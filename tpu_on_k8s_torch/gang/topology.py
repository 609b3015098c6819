"""GPU host topology math.

The GPU flavour of ``tpu_on_k8s/gang/topology.py``, with its semantics: a
worker replica is a *host*, hosts come in fixed GPUs-per-host quanta, and
only certain slice topologies exist. So:

* gang PodGroup ``MinMember`` = ``hosts_per_slice(accelerator, topology)``;
* elastic rescale may only land on ``legal_host_counts``: the reference's
  free-form replica doubling (torchelastic job.go:102-104) is snapped to the
  nearest legal quantum by ``next_legal_host_count``.

A topology is an ``HxG`` string: H hosts of G GPUs each. ``1x1``-``1x8`` fit
one host; a multi-host slice takes whole 8-GPU hosts in powers of two up to
64, so the legal host counts are those of the TPU package's
``tpu-v5-lite-podslice`` ({1, 2, 4, 8, 16, 32, 64}). The table is data:
extendable without code changes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

# accelerator name (cloud.google.com/gke-accelerator value) →
#   (GPUs per host, legal topology strings)
_ACCELERATORS: Dict[str, Tuple[int, List[str]]] = {
    # H100 80GB hosts (a3-highgpu-8g): 8 GPUs each, NVLink within a host.
    "nvidia-h100-80gb": (
        8,
        ["1x1", "1x2", "1x4", "1x8", "2x8", "4x8", "8x8", "16x8", "32x8",
         "64x8"],
    ),
}

_SINGLE_HOST_MAX_CHIPS = {
    # Slices at or under this many GPUs fit one host.
    "nvidia-h100-80gb": 8,
}


@dataclass(frozen=True)
class SliceShape:
    accelerator: str
    topology: str

    @property
    def chips(self) -> int:
        return chips_in_topology(self.topology)

    @property
    def hosts(self) -> int:
        return hosts_per_slice(self.accelerator, self.topology)

    @property
    def chips_per_host(self) -> int:
        return chips_per_host(self.accelerator)


def parse_topology(topology: str) -> Tuple[int, ...]:
    try:
        dims = tuple(int(d) for d in topology.lower().split("x"))
    except ValueError as e:
        raise ValueError(f"malformed topology {topology!r}") from e
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"malformed topology {topology!r}")
    return dims


def chips_in_topology(topology: str) -> int:
    return math.prod(parse_topology(topology))


def chips_per_host(accelerator: str) -> int:
    """GPUs per host (the reference's name, kept: "chips" are GPUs here)."""
    spec = _ACCELERATORS.get(accelerator)
    if spec is None:
        raise KeyError(f"unknown GPU accelerator {accelerator!r}")
    return spec[0]


def legal_topologies(accelerator: str) -> List[str]:
    spec = _ACCELERATORS.get(accelerator)
    if spec is None:
        raise KeyError(f"unknown GPU accelerator {accelerator!r}")
    return list(spec[1])


def hosts_per_slice(accelerator: str, topology: str) -> int:
    """Host (VM) count of one slice — the gang MinMember for its worker group."""
    chips = chips_in_topology(topology)
    single_max = _SINGLE_HOST_MAX_CHIPS.get(accelerator)
    if single_max is not None and chips <= single_max:
        return 1
    per_host = chips_per_host(accelerator)
    return max(1, math.ceil(chips / per_host))


def legal_host_counts(accelerator: str) -> List[int]:
    """Sorted unique host counts reachable via legal topologies — the elastic
    rescale quanta."""
    counts = {hosts_per_slice(accelerator, t) for t in legal_topologies(accelerator)}
    return sorted(counts)


def topology_for_hosts(accelerator: str, hosts: int) -> Optional[str]:
    """Smallest legal topology providing at least ``hosts`` hosts (None if the
    accelerator tops out below that)."""
    best: Optional[Tuple[int, str]] = None
    for t in legal_topologies(accelerator):
        h = hosts_per_slice(accelerator, t)
        if h >= hosts and (best is None or h < best[0]):
            best = (h, t)
    return best[1] if best else None


def next_legal_host_count(
    accelerator: str, current: int, *, direction: int = +1
) -> Optional[int]:
    """Next legal host count strictly above (direction=+1) or below (-1)
    ``current``; None at the boundary. Used by the elastic autoscaler in place of
    the reference's unconstrained ``replicas *= 2``."""
    counts = legal_host_counts(accelerator)
    if direction > 0:
        for c in counts:
            if c > current:
                return c
        return None
    for c in reversed(counts):
        if c < current:
            return c
    return None


def snap_host_count(accelerator: str, desired: int) -> int:
    """Snap an arbitrary desired host count to the nearest legal quantum
    (rounding up, capped at the largest legal topology)."""
    counts = legal_host_counts(accelerator)
    for c in counts:
        if c >= desired:
            return c
    return counts[-1]


def validate_slice(accelerator: str, topology: str) -> None:
    if topology not in legal_topologies(accelerator):
        raise ValueError(
            f"topology {topology!r} is not legal for {accelerator!r}; "
            f"legal: {legal_topologies(accelerator)}"
        )


# --------------------------------------------------------------- mesh shapes
# The elastic decision is no longer just a host count: a live reshard
# (tpu_on_k8s_torch/parallel/reshard.py) needs the *(hosts, mesh shape)* pair,
# where the mesh shape is the logical axis layout the training state is
# repartitioned onto. The legality constraint is chips, not hosts: the
# axis sizes must multiply to the slice configuration's chip count —
# the same quanta rule `parallel/mesh.MeshConfig.resolve` enforces on
# the compute plane, expressed here dependency-free so the controller
# can validate a decision without importing torch.

def format_mesh_axes(mesh: Dict[str, int]) -> str:
    """Stable wire form of a mesh shape ("data=2,fsdp=8"): sorted,
    trivial (size-1) axes dropped — two writers of the same shape
    produce identical strings. "" is the single-chip/trivial mesh."""
    return ",".join(f"{a}={int(s)}" for a, s in sorted(mesh.items())
                    if int(s) > 1)


def parse_mesh_axes(raw: str) -> Dict[str, int]:
    """Inverse of ``format_mesh_axes``. Raises ValueError on malformed
    input (non-numeric or non-positive sizes) — callers on annotation
    paths catch and treat as "no request"."""
    out: Dict[str, int] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        axis, _, size = part.partition("=")
        if not axis or not size:
            raise ValueError(f"malformed mesh axes {raw!r}")
        n = int(size)
        if n < 1:
            raise ValueError(f"non-positive axis size in {raw!r}")
        out[axis] = n
    return out


def slice_chips(accelerator: str, topology: str, num_slices: int = 1) -> int:
    """Total chips of a slice configuration — the budget a mesh shape
    must multiply to."""
    validate_slice(accelerator, topology)
    return chips_in_topology(topology) * max(int(num_slices), 1)


def validate_mesh_for_slice(accelerator: str, topology: str,
                            mesh: Dict[str, int],
                            num_slices: int = 1) -> None:
    """A mesh shape is slice-legal iff its axis product equals the slice
    configuration's chip count. Raises ValueError naming both numbers —
    the decision-side guard matching the compute plane's
    ``MeshConfig.resolve`` check."""
    chips = slice_chips(accelerator, topology, num_slices)
    product = math.prod(max(int(s), 1) for s in mesh.values()) if mesh else 1
    if product != chips:
        raise ValueError(
            f"mesh shape {format_mesh_axes(mesh) or 'single'} has axis "
            f"product {product} but {accelerator}/{topology}"
            f"{f' x{num_slices}' if num_slices > 1 else ''} provides "
            f"{chips} chips — axis sizes must multiply to the chip count")


def mesh_shape_for_slice(accelerator: str, topology: str,
                         num_slices: int = 1, *, data: int = 1,
                         model: int = 1, expert: int = 1,
                         ) -> Dict[str, int]:
    """The default (hosts, mesh shape) second half for a slice
    configuration: fixed axes as given, ``fsdp`` absorbing the remaining
    chips (the training plane's default parallelism). Raises ValueError
    when the fixed axes do not divide the chip count."""
    chips = slice_chips(accelerator, topology, num_slices)
    fixed = max(int(data), 1) * max(int(model), 1) * max(int(expert), 1)
    if chips % fixed != 0:
        raise ValueError(
            f"fixed axes data={data},model={model},expert={expert} "
            f"(product {fixed}) do not divide the {chips} chips of "
            f"{accelerator}/{topology}"
            f"{f' x{num_slices}' if num_slices > 1 else ''}")
    shape = {"data": int(data), "fsdp": chips // fixed,
             "model": int(model), "expert": int(expert)}
    validate_mesh_for_slice(accelerator, topology, shape, num_slices)
    return shape


def format_reshard_spec(generation: int, hosts: int,
                        mesh: Dict[str, int]) -> str:
    """The annotation wire form of a (hosts, mesh shape) rescale
    decision: ``gen=3;hosts=4;mesh=data=2,fsdp=8``
    (``ANNOTATION_RESHARD_REQUESTED_SPEC``). Order-normalized so two
    writers of the same decision produce identical strings."""
    return (f"gen={int(generation)};hosts={int(hosts)};"
            f"mesh={format_mesh_axes(mesh)}")


def parse_reshard_spec(raw: str) -> Optional[Tuple[int, int, Dict[str, int]]]:
    """Inverse of ``format_reshard_spec``: (generation, hosts,
    mesh_axes), or None on malformed input — a garbled annotation must
    read as "no request", never crash a poll loop."""
    try:
        fields = dict(part.split("=", 1) for part in raw.split(";") if part)
        gen = int(fields["gen"])
        hosts = int(fields["hosts"])
        mesh = parse_mesh_axes(fields.get("mesh", ""))
    except (KeyError, ValueError):
        return None
    if gen < 0 or hosts < 1:
        return None
    return gen, hosts, mesh
