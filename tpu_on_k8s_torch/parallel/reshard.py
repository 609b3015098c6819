"""Live mesh reconfiguration: an elastic rescale as a state transform, not
a cold restart. The counterpart of ``tpu_on_k8s/parallel/reshard.py``.

* ``plan_reshard`` walks a state once (a nested dict of ``DTensor``s, or a
  ``TrainState``), resolves each leaf's source and destination spec through
  the rules, validates every destination leaf first
  (``ShardingValidationError`` before any byte moves) and marks the leaves
  whose layout changes: a leaf moves unless both layouts put the same
  block on the same rank (``NamedSharding.is_equivalent_to``). The plan
  prices the move (``bytes_moved``), the ``ReshardMetrics`` feed.
* ``ReshardPlan.execute`` runs it. ``DTensor.redistribute`` cannot cross
  meshes of different rank sets, so each moved leaf is gathered on its
  source mesh (``full_tensor``), broadcast over the world from the source
  mesh's first rank, and laid out on the destination (each rank keeps its
  block, ``distribute_tensor`` with no scatter): exact by construction.
  Leaves that do not move stay as they are. A ``TrainState`` moves into a
  fresh model and optimizer laid out on the destination
  (``train_state_template``), its unmoved leaves copied block for block
  with no communication. The chaos site ``SITE_RESHARD`` fires before the
  first leaf moves, so an injected ``ReshardAbort`` (or a failed
  validation) leaves the source state untouched.
* ``ReshardNotice`` is the ``train/loop.py`` integration, the
  ``preemption_signal`` sibling that transforms instead of stopping;
  ``ReshardAgent`` the pod side of the operator's request annotation.

Every rank of the world runs a transform, members of either mesh or not.
Across restarts, ``CheckpointManager.restore(mesh=, rules=)`` lands a
checkpoint written under one layout directly in another
(``restore_resharded``).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from tpu_on_k8s_torch import chaos, constants
from tpu_on_k8s_torch.parallel.mesh import (
    NamedSharding,
    mesh_axes,
    mesh_ranks,
)
from tpu_on_k8s_torch.parallel.partition import (
    PartitionRule,
    ShardingValidationError,
    flatten_tree,
    map_tree,
    named_sharding,
    rule_for_path,
)
from tpu_on_k8s_torch.utils.logging import get_logger, kv

__all__ = [
    "LeafMove", "ReshardPlan", "ReshardNotice", "ReshardAgent",
    "plan_reshard", "reshard_state", "abstract_resharded",
    "restore_resharded", "ShardingValidationError",
    "format_reshard_spec", "parse_reshard_spec",
]

log = get_logger("parallel.reshard")


@dataclasses.dataclass(frozen=True)
class LeafMove:
    """One leaf's transfer: where it lives, where it goes, what it costs.
    ``moved`` is False when both layouts put the same block on the same
    rank: the leaf stays as it is."""

    path: str
    shape: Tuple[int, ...]
    dtype: str
    src_spec: str
    dst_spec: str
    nbytes: int
    moved: bool


def _is_train_state(state: Any) -> bool:
    return hasattr(state, "state_dict") and hasattr(state, "optimizer")


class ReshardPlan:
    """A validated transfer plan over one state, built by ``plan_reshard``;
    ``execute`` runs it. ``describe()`` is the stable one-line form."""

    def __init__(self, moves: List[LeafMove],
                 dst_shardings: Dict[str, NamedSharding],
                 src_axes: Dict[str, int], dst_axes: Dict[str, int],
                 dst_mesh: Any = None,
                 dst_rules: Sequence[PartitionRule] = ()) -> None:
        self.moves = moves
        self.dst_shardings = dst_shardings
        self.src_axes = src_axes
        self.dst_axes = dst_axes
        self.dst_mesh = dst_mesh
        self.dst_rules = tuple(dst_rules)

    # ------------------------------------------------------------- readouts
    @property
    def bytes_total(self) -> int:
        return sum(m.nbytes for m in self.moves)

    @property
    def bytes_moved(self) -> int:
        return sum(m.nbytes for m in self.moves if m.moved)

    @property
    def n_moved(self) -> int:
        return sum(1 for m in self.moves if m.moved)

    def describe(self) -> str:
        """Stable one-line form (no timestamps, no ranks)."""
        src = ",".join(f"{a}={s}" for a, s in sorted(self.src_axes.items()))
        dst = ",".join(f"{a}={s}" for a, s in sorted(self.dst_axes.items()))
        return (f"reshard {src or 'single'} -> {dst or 'single'} "
                f"leaves={len(self.moves)} moved={self.n_moved} "
                f"bytes={self.bytes_moved}")

    # -------------------------------------------------------------- execute
    def execute(self, state: Any) -> Any:
        """The transform (see the module docstring). The chaos site fires
        before any leaf moves: an abort leaves ``state`` untouched. The
        source leaves that moved are freed once the caller drops
        ``state`` (the reference donates them)."""
        fault = chaos.fire(chaos.SITE_RESHARD, leaves=len(self.moves))
        if fault is not None:
            raise fault.to_exception()
        moved = {m.path: m.moved for m in self.moves}
        if _is_train_state(state):
            return self._execute_train_state(state, moved)

        def move(path: str, leaf: torch.Tensor) -> torch.Tensor:
            if not moved[path]:
                return leaf
            return distribute_tensor(
                _gathered(leaf), self.dst_mesh,
                self.dst_shardings[path].placements, src_data_rank=None)

        return map_tree(move, state)

    def _execute_train_state(self, state: Any, moved: Dict[str, bool]):
        from tpu_on_k8s_torch.train.trainer import _copy_into
        new = _template_like(state, self.dst_mesh, self.dst_rules)
        src = state.state_dict()
        dst = new.state_dict()
        with torch.no_grad():
            for path, t in dst.items():
                if path in ("count", "step"):
                    continue
                same_blocks = (not moved[path] and _same_storage(src[path], t))
                _copy_into(t, src[path] if same_blocks
                           else _gathered(src[path]))
        new.optimizer.count = state.optimizer.count
        new.step = state.step
        return new


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two leaves hold the same block on this rank as stored (the
    same placements over the same ranks, or both plain)."""
    if isinstance(a, DTensor) != isinstance(b, DTensor):
        return False
    if not isinstance(a, DTensor):
        return True
    # rank-independent, so every rank takes the same (collective) branch
    return (a.placements == b.placements and a.shape == b.shape
            and mesh_ranks(a.device_mesh) == mesh_ranks(b.device_mesh))


def _template_like(state: Any, mesh: Any,
                   rules: Sequence[PartitionRule]) -> Any:
    """An empty ``TrainState`` like ``state`` (its config, its optimizer's
    arithmetic and moment dtypes) laid out on ``(mesh, rules)``."""
    from tpu_on_k8s_torch.train.trainer import train_state_template
    hyper = state.optimizer.hyperparameters()
    device = next(iter(state.model.parameters())).device
    template = train_state_template(
        state.model.cfg, device, mesh=mesh, rules=rules,
        mu_dtype=hyper["mu_dtype"], nu_dtype=hyper["nu_dtype"])
    opt = template.optimizer
    opt.schedule, opt.max_grad_norm = hyper["schedule"], hyper["max_grad_norm"]
    for group in opt.param_groups:
        group.update(b1=hyper["b1"], b2=hyper["b2"], eps=hyper["eps"],
                     weight_decay=hyper["weight_decay"])
    return template


def _gathered(leaf: torch.Tensor) -> torch.Tensor:
    """The full value of a (possibly sharded) leaf on every rank of the
    world: gathered on its source mesh, then broadcast from that mesh's
    first rank."""
    if not isinstance(leaf, DTensor):
        return leaf
    mesh = leaf.device_mesh
    if mesh.get_coordinate() is not None:
        full = leaf.full_tensor()
    else:
        full = torch.empty(leaf.shape, dtype=leaf.dtype,
                           device=leaf.to_local().device)
    src = mesh_ranks(mesh)
    if len(src) < dist.get_world_size():
        dist.broadcast(full, src=src[0])
    return full


def _spec_str(spec: Any) -> str:
    return str(tuple(spec)) if len(tuple(spec)) else "()"


def plan_reshard(state: Any, src_mesh: Any, src_rules: Sequence[PartitionRule],
                 dst_mesh: Any, dst_rules: Sequence[PartitionRule],
                 ) -> ReshardPlan:
    """The validated transfer plan for ``state`` from ``(src_mesh,
    src_rules)`` to ``(dst_mesh, dst_rules)``: every destination leaf is
    validated up front (``ShardingValidationError`` with the path, dim,
    axis sizes and rule), so an illegal destination fails before any data
    moves."""
    dst_shardings = named_sharding(state, dst_mesh, dst_rules)
    src_shardings = named_sharding(state, src_mesh, src_rules)
    moves: List[LeafMove] = []
    for path, leaf in flatten_tree(state):
        if path in ("count", "step") and _is_train_state(state):
            continue            # host scalars: they ride along
        shape = tuple(leaf.shape)
        moved = not src_shardings[path].is_equivalent_to(
            dst_shardings[path], shape)
        nbytes = leaf.numel() * leaf.element_size()
        moves.append(LeafMove(
            path=path, shape=shape, dtype=str(leaf.dtype),
            src_spec=_spec_str(rule_for_path(path, src_rules)[1]),
            dst_spec=_spec_str(dst_shardings[path].spec),
            nbytes=int(nbytes), moved=moved))
    return ReshardPlan(moves, dst_shardings, mesh_axes(src_mesh),
                       mesh_axes(dst_mesh), dst_mesh, dst_rules)


def reshard_state(state: Any, src_mesh: Any,
                  src_rules: Sequence[PartitionRule], dst_mesh: Any,
                  dst_rules: Sequence[PartitionRule]
                  ) -> Tuple[Any, ReshardPlan]:
    """Plan and execute in one call: (the resharded state, its plan)."""
    plan = plan_reshard(state, src_mesh, src_rules, dst_mesh, dst_rules)
    return plan.execute(state), plan


def abstract_resharded(state: Any, mesh: Any,
                       rules: Sequence[PartitionRule]) -> Any:
    """A template of ``state``'s leaves laid out on ``(mesh, rules)``,
    validated first: for a nested dict, empty ``DTensor``s of each leaf's
    shape and dtype; for a ``TrainState``, ``train_state_template`` on the
    mesh. What ``CheckpointManager.restore`` reads a checkpoint written
    under one layout into, in another."""
    shardings = named_sharding(state, mesh, rules)
    if _is_train_state(state):
        return _template_like(state, mesh, rules)
    device = mesh.device_type

    def empty(path: str, leaf: torch.Tensor) -> DTensor:
        return distribute_tensor(
            torch.empty(leaf.shape, dtype=leaf.dtype, device=device), mesh,
            shardings[path].placements, src_data_rank=None)

    return map_tree(empty, state)


def restore_resharded(manager: Any, state: Any, mesh: Any,
                      rules: Sequence[PartitionRule], *,
                      generation: Optional[int] = None,
                      step: Optional[int] = None) -> Tuple[Any, int, int]:
    """Restore the newest checkpoint directly into ``(mesh, rules)``: the
    checkpoint-restart arm of a rescale. Returns (state, generation,
    step)."""
    return manager.restore(state, generation=generation, step=step,
                           mesh=mesh, rules=rules)


class ReshardNotice:
    """What ``train/loop.py``'s ``reshard_signal`` returns: the (src, dst)
    layout pair, an optional ``step_builder(dst_mesh, state) -> step_fn``
    that rebuilds the step for the new layout (None keeps the current
    step), an optional ``generation`` for the checkpoints after it, and the
    control-plane acks ``on_applied`` / ``on_failed``. The reference's
    ``warm_batch`` AOT-compiles a jitted step; the port's steps are eager
    and build their kernels on first use, so a ``warm_batch`` raises
    ``ValueError``."""

    def __init__(self, src_mesh: Any, src_rules: Sequence[PartitionRule],
                 dst_mesh: Any, dst_rules: Sequence[PartitionRule], *,
                 step_builder: Optional[Callable[[Any, Any], Any]] = None,
                 warm_batch: Any = None,
                 generation: Optional[int] = None,
                 tag: str = "",
                 on_applied: Optional[Callable[[], None]] = None,
                 on_failed: Optional[Callable[[], None]] = None) -> None:
        self.src_mesh = src_mesh
        self.src_rules = list(src_rules)
        self.dst_mesh = dst_mesh
        self.dst_rules = list(dst_rules)
        if warm_batch is not None:
            raise ValueError(
                "warm_batch compiles a jitted step ahead in the reference; "
                "the port's steps are eager and have nothing to compile")
        self.step_builder = step_builder
        self.generation = generation
        self.tag = tag
        self.on_applied = on_applied
        self.on_failed = on_failed

    def apply(self, state: Any, step_fn: Any) -> Tuple[Any, Any, ReshardPlan]:
        """Transform ``state`` and rebuild the step. Raises before any byte
        moves on an illegal destination or an injected ``ReshardAbort``:
        the caller's ``state`` is the intact source state then."""
        plan = plan_reshard(state, self.src_mesh, self.src_rules,
                            self.dst_mesh, self.dst_rules)
        new_state = plan.execute(state)
        new_step = step_fn
        if self.step_builder is not None:
            new_step = self.step_builder(self.dst_mesh, new_state)
        return new_state, new_step, plan


# ------------------------------------------------------------ control plane
def format_mesh_axes(mesh: Dict[str, int]) -> str:
    """Stable wire form of a mesh shape ("data=2,fsdp=8"): sorted, size-1
    axes dropped. "" is the trivial mesh."""
    return ",".join(f"{a}={int(s)}" for a, s in sorted(mesh.items())
                    if int(s) > 1)


def parse_mesh_axes(raw: str) -> Dict[str, int]:
    """Inverse of ``format_mesh_axes``; ValueError on malformed input."""
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


def format_reshard_spec(generation: int, hosts: int,
                        mesh: Dict[str, int]) -> str:
    """The annotation wire form of a (hosts, mesh shape) rescale decision:
    ``gen=3;hosts=4;mesh=data=2,fsdp=8``, order-normalized. A copy of the
    reference's ``gang/topology.py`` function."""
    return (f"gen={int(generation)};hosts={int(hosts)};"
            f"mesh={format_mesh_axes(mesh)}")


def parse_reshard_spec(raw: str) -> Optional[Tuple[int, int, Dict[str, int]]]:
    """Inverse of ``format_reshard_spec``: (generation, hosts, mesh axes),
    or None on malformed input (a garbled annotation is no request)."""
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


class ReshardAgent:
    """The pod side of the live-reshard protocol: the ``CheckpointAgent``
    sibling that transforms instead of dying.

    The operator stamps ``reshard-requested-spec = gen=G;hosts=H;mesh=...``;
    ``poll`` (wire it as ``TrainLoop(reshard_signal=agent.poll)``) observes
    it and asks ``notice_factory(mesh_axes, generation)`` for a
    ``ReshardNotice``. The notice acks on apply (``reshard-completed-spec =
    G``); a failed transform, or a factory that declines (None), clears the
    request so the operator falls back to the checkpoint-restart path.
    ``cluster`` is duck-typed (``try_get``, ``patch_meta``) and ``job_cls``
    is the job's type, as ``CheckpointAgent`` takes them; a cluster's
    not-found error is recognised by its class name (``NotFoundError``).
    Polls are rate-limited to one every ``min_poll_interval_s``."""

    def __init__(self, cluster: Any, namespace: str, job_name: str,
                 notice_factory: Callable[[Dict[str, int], int],
                                          Optional[ReshardNotice]],
                 job_cls: type, *,
                 min_poll_interval_s: float = 5.0,
                 clock: Optional[Callable[[], float]] = None) -> None:
        self.cluster = cluster
        self.namespace = namespace
        self.job_name = job_name
        self.notice_factory = notice_factory
        self.job_cls = job_cls
        self.min_poll_interval_s = max(float(min_poll_interval_s), 0.0)
        self._clock = clock if clock is not None else time.monotonic
        self._last_poll: Optional[float] = None

    def pending_request(self) -> Optional[Tuple[int, int, Dict[str, int]]]:
        job = self.cluster.try_get(self.job_cls, self.namespace, self.job_name)
        if job is None:
            return None
        ann = job.metadata.annotations or {}
        raw = ann.get(constants.ANNOTATION_RESHARD_REQUESTED_SPEC)
        if raw is None:
            return None
        parsed = parse_reshard_spec(raw)
        if parsed is None:
            return None
        done = ann.get(constants.ANNOTATION_RESHARD_COMPLETED_SPEC)
        if done is not None and done.strip().isdigit() \
                and int(done) >= parsed[0]:
            return None
        return parsed

    def poll(self) -> Optional[ReshardNotice]:
        """The ``TrainLoop.reshard_signal`` callable: a pending request
        becomes a ``ReshardNotice`` whose acks close the protocol; the
        factory's own hooks (and generation) are kept, the agent's acks
        chained after them."""
        if self.min_poll_interval_s > 0:
            now = self._clock()
            if self._last_poll is not None and \
                    now - self._last_poll < self.min_poll_interval_s:
                return None
            self._last_poll = now
        pending = self.pending_request()
        if pending is None:
            return None
        gen, _hosts, mesh_shape = pending
        notice = self.notice_factory(mesh_shape, gen)
        if notice is None:
            # the requested mesh cannot be built here: withdraw the request
            # so the operator's cold path runs the rescale
            self._clear(gen)
            return None
        notice.generation = gen if notice.generation is None \
            else notice.generation
        factory_applied, factory_failed = notice.on_applied, notice.on_failed

        def applied() -> None:
            if factory_applied is not None:
                factory_applied()
            self._ack(gen)

        def failed() -> None:
            if factory_failed is not None:
                factory_failed()
            self._clear(gen)

        notice.on_applied = applied
        notice.on_failed = failed
        return notice

    def _patch(self, annotations: Dict[str, Optional[str]]) -> None:
        try:
            self.cluster.patch_meta(self.job_cls, self.namespace,
                                    self.job_name, annotations=annotations)
        except Exception as e:  # noqa: BLE001 — only a deleted job is moot
            if type(e).__name__ != "NotFoundError":
                raise

    def _ack(self, generation: int) -> None:
        # a job deleted mid-protocol makes the ack moot: the transform
        # already succeeded and the run must not die over it
        self._patch({constants.ANNOTATION_RESHARD_COMPLETED_SPEC:
                     str(generation)})

    def _clear(self, generation: int) -> None:
        """A failed transform: withdraw the request so the operator's hold
        releases and the cold checkpoint-restart path proceeds."""
        kv(log, logging.WARNING, "reshard_request_cleared",
           generation=generation, job=f"{self.namespace}/{self.job_name}")
        self._patch({constants.ANNOTATION_RESHARD_REQUESTED_SPEC: None})
