"""Logical device meshes over the job's ranks: the counterpart of
``tpu_on_k8s/parallel/mesh.py``.

The operator hands a job N cards; this module folds the ranks of the
``torch.distributed`` world into a ``DeviceMesh`` with the reference's five
named axes, in its order (outermost → innermost: ``data``, ``fsdp``,
``expert``, ``seq``, ``model``), so the axes that carry the chattiest
collectives (``model``'s per-layer reductions) land on the ranks nearest each
other. Axis sizes must multiply to the rank count (``MeshConfig.resolve``),
the legal-quanta rule the gang scheduler enforces on hosts.

A ``NamedSharding`` (a mesh and a spec: one entry per tensor dim, each
``None``, an axis name or a tuple of axis names) is what a partition rule
yields; its ``placements`` are the ``DTensor`` placements, one per mesh dim.
``batch_sharding`` splits a ``[batch, ...]`` input over ``data`` and
``fsdp``: each rank holds the rows of its (data, fsdp) coordinate.

The mesh's device type comes from the caller: ``"cuda"`` (the default, over
NCCL) or ``"cpu"`` (gloo), as every entry point of the port takes it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from tpu_on_k8s_torch.device import resolve_device

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_EXPERT = "expert"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"

#: outermost → innermost; the innermost axes map to the nearest ranks.
AXIS_ORDER: Tuple[str, ...] = (AXIS_DATA, AXIS_FSDP, AXIS_EXPERT, AXIS_SEQ,
                               AXIS_MODEL)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. Sizes must multiply to the rank count (or use -1
    on exactly one axis to absorb the remainder)."""

    data: int = 1
    fsdp: int = -1  # default: all remaining ranks do FSDP
    model: int = 1
    seq: int = 1
    expert: int = 1

    def _sizes(self) -> Dict[str, int]:
        return {AXIS_DATA: self.data, AXIS_FSDP: self.fsdp,
                AXIS_MODEL: self.model, AXIS_SEQ: self.seq,
                AXIS_EXPERT: self.expert}

    def resolve(self, n_devices: int) -> "MeshConfig":
        """Replace a single -1 with whatever makes the product n_devices."""
        sizes = self._sizes()
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"cannot fit mesh {sizes} onto {n_devices} devices: "
                    f"fixed product {fixed} does not divide {n_devices}")
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices but {n_devices} are "
                f"available")
        return MeshConfig(data=sizes[AXIS_DATA], fsdp=sizes[AXIS_FSDP],
                          model=sizes[AXIS_MODEL], seq=sizes[AXIS_SEQ],
                          expert=sizes[AXIS_EXPERT])

    def axis_sizes(self) -> Tuple[int, ...]:
        by_name = self._sizes()
        return tuple(by_name[a] for a in AXIS_ORDER)

    def describe(self) -> str:
        """Compact stable signature ("data=1,fsdp=1,expert=1,seq=1,
        model=2")."""
        by_name = self._sizes()
        return ",".join(f"{a}={by_name[a]}" for a in AXIS_ORDER)


def create_mesh(config: Optional[MeshConfig] = None,
                ranks: Optional[Sequence[int]] = None,
                device: str | torch.device = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` with the five named axes over ``ranks`` (default:
    the whole ``torch.distributed`` world, which must be initialised:
    ``train/distributed.py``'s ``initialize``). The ranks fill the grid in
    ``AXIS_ORDER``, so ``model`` is innermost. A mesh over a subset of the
    world is built by every rank of the world (its process groups are made
    collectively); a rank outside it holds empty shards."""
    if not torch.distributed.is_initialized():
        raise RuntimeError(
            "create_mesh needs an initialised torch.distributed world "
            "(tpu_on_k8s_torch.train.distributed.initialize)")
    device_type = resolve_device(device).type
    ranks = (list(range(torch.distributed.get_world_size()))
             if ranks is None else [int(r) for r in ranks])
    cfg = (config or MeshConfig()).resolve(len(ranks))
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(cfg.axis_sizes())
    return DeviceMesh(device_type, grid, mesh_dim_names=AXIS_ORDER)


def serving_mesh(data: int = 1, model: int = 1, expert: int = 1,
                 ranks: Optional[Sequence[int]] = None,
                 device: str | torch.device = "cuda") -> DeviceMesh:
    """The serving plane's ``{data, model, expert}`` mesh: fsdp and seq stay
    at 1 (a decode step has no gradient to shard and no sequence axis to
    split); ``data * model * expert`` must equal the rank count."""
    return create_mesh(MeshConfig(data=data, fsdp=1, model=model, seq=1,
                                  expert=expert), ranks, device)


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis: size}`` of every axis of ``mesh``."""
    return {name: int(mesh.size(i))
            for i, name in enumerate(mesh.mesh_dim_names)}


def mesh_axes(mesh: Optional[DeviceMesh]) -> Dict[str, int]:
    """``{axis: size}`` for the mesh's non-trivial axes ({} for None or an
    all-1 mesh): the stable sharding signature."""
    if mesh is None:
        return {}
    return {a: s for a, s in mesh_shape(mesh).items() if s > 1}


def mesh_ranks(mesh: DeviceMesh) -> Tuple[int, ...]:
    """The mesh's ranks, in grid order."""
    return tuple(int(r) for r in mesh.mesh.flatten().tolist())


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: one entry per tensor dim (``None``, an axis name or
    a tuple of axis names, outer axis first), the reference's
    ``NamedSharding(mesh, PartitionSpec(...))``. A spec may be shorter than
    the tensor (the rest is replicated)."""

    mesh: DeviceMesh
    spec: Tuple

    @property
    def placements(self) -> Tuple:
        """One ``DTensor`` placement per mesh dim: ``Shard(d)`` where the
        spec puts the axis on tensor dim d, else ``Replicate()``. Axes that
        share a tensor dim shard it in mesh order (outer axis major), the
        reference's order for a tuple entry."""
        names = list(self.mesh.mesh_dim_names)
        out: List = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            for axis in _axes(entry):
                out[names.index(axis)] = Shard(d)
        return tuple(out)

    def shard_index(self, shape: Sequence[int]) -> Dict[int, Tuple]:
        """rank → the ``(start, stop)`` per tensor dim of the block it holds
        (a replica holds the same block as its peers)."""
        names = list(self.mesh.mesh_dim_names)
        sizes = [int(self.mesh.size(i)) for i in range(len(names))]
        grid = self.mesh.mesh
        out = {}
        for coord in torch.cartesian_prod(
                *[torch.arange(s) for s in sizes]).reshape(-1, len(sizes)):
            coord = [int(c) for c in coord]
            rank = int(grid[tuple(coord)])
            block = []
            for d, n in enumerate(shape):
                axes = _axes(self.spec[d]) if d < len(self.spec) else ()
                parts, idx = 1, 0
                for axis in axes:          # outer axis major
                    i = names.index(axis)
                    idx = idx * sizes[i] + coord[i]
                    parts *= sizes[i]
                step = n // parts
                block.append((idx * step, idx * step + step))
            out[rank] = tuple(block)
        return out

    def is_equivalent_to(self, other: "NamedSharding",
                         shape: Sequence[int]) -> bool:
        """Whether both shardings place the same block of a ``shape``
        tensor on the same rank, for every rank (the reference's
        ``is_equivalent_to``): the same spec on a mesh whose axis sizes
        changed is not equivalent; different specs that place every block
        alike are."""
        return self.shard_index(shape) == other.shard_index(shape)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def batch_sharding(mesh: DeviceMesh,
                   shape: Optional[Sequence[int]] = None) -> NamedSharding:
    """Sharding of a ``[batch, ...]`` input: the batch over every
    data-parallel axis (data, fsdp); ``seq`` shards dim 1 when it is there.

    With ``shape``, an axis that does not divide its dim is shed (a batch
    smaller than data×fsdp, or the +1-shifted token dim): those ranks then
    hold the same rows."""
    sizes = mesh_shape(mesh)
    batch_axes: List[str] = []
    if shape is None:
        batch_axes = [AXIS_DATA, AXIS_FSDP]
    else:
        rem = shape[0]
        for axis in (AXIS_DATA, AXIS_FSDP):
            size = sizes.get(axis, 1)
            if size > 1 and rem % size == 0:
                batch_axes.append(axis)
                rem //= size
    seq = sizes.get(AXIS_SEQ, 1)
    shard_seq = seq > 1 and (shape is None or
                             (len(shape) > 1 and shape[1] % seq == 0))
    # one axis is named alone, as a PartitionSpec normalises it
    first = (None if not batch_axes else batch_axes[0]
             if len(batch_axes) == 1 else tuple(batch_axes))
    spec = (first, AXIS_SEQ) if shard_seq else (first,)
    return NamedSharding(mesh, spec)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (1 for None or a mesh without it)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


class MeshAxis:
    """One axis of a mesh as this rank sees it: the process group along it
    (``group``), the global ranks along it in coordinate order (``ranks``:
    a ring's members in ring order; the peers a ``P2POp`` names are global
    ranks), their count (``size``) and this rank's coordinate on it
    (``rank``: on ``seq``, which chunk of the sequence it holds). ``axis``
    names a dim of ``mesh``; None takes a one-dim mesh's only dim."""

    def __init__(self, mesh: DeviceMesh, axis: Optional[str] = None) -> None:
        dim = 0 if axis is None else mesh.mesh_dim_names.index(axis)
        self.group = mesh.get_group(dim)
        coord = list(mesh.get_coordinate())
        self.rank = coord[dim]
        coord[dim] = slice(None)
        self.ranks = tuple(int(r) for r in mesh.mesh[tuple(coord)].tolist())
        self.size = len(self.ranks)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's block of ``dim``, concatenated in order (no
        gradient)."""
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(self.size)]
        torch.distributed.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def own(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``dim``."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)


def data_sharding(mesh: DeviceMesh) -> NamedSharding:
    """Only the leading batch dim over (data, fsdp), for inputs whose other
    dims carry no sequence (images, labels)."""
    return NamedSharding(mesh, ((AXIS_DATA, AXIS_FSDP),))


def data_shard(mesh: DeviceMesh) -> Tuple[int, int]:
    """(shard id, shard count) of this rank's rows among data × fsdp: its
    (data, fsdp) coordinate (ranks that differ only on other axes read the
    same rows)."""
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return (coord[AXIS_DATA] * sizes[AXIS_FSDP] + coord[AXIS_FSDP],
            sizes[AXIS_DATA] * sizes[AXIS_FSDP])


def replicated(mesh: DeviceMesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def local_rows(tokens: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of a tensor every rank holds in full, under
    ``sharding`` (a batch's rows by the rank's (data, fsdp) coordinate).
    No communication. A rank outside the mesh gets an empty tensor."""
    block = sharding.shard_index(tokens.shape).get(
        torch.distributed.get_rank())
    if block is None:
        return tokens[:0]
    return tokens[tuple(slice(a, b) for a, b in block)]
