"""Virtual device/slice layer (a copy of ``tpu_on_k8s/sim/devices.py``):
the stand-in for serving replicas on GPU hosts that the twin's control
plane cannot tell from the real thing.

`autoscale/signals.FleetScraper` is explicitly duck-typed ("anything
with a ``replicas`` dict of objects carrying ``metrics`` / ``engine`` /
``outstanding`` / ``routable`` / ``state``"), and
`controller/fleetautoscaler._execute` applies committed decisions via
``fleet.scale_to``. `SimFleet` implements exactly that surface — real
`metrics.ServingMetrics` per replica (mirror deques, monotone counts,
exemplars: the scraper's delta reads work unmodified), virtual
everything else.

Cost model (``DeviceCostModel``): the same constants `serve_load`'s
virtual modes price with — decode costs ``step_base`` (= 1.0,
serve_load ``_DISAGG_STEP_BASE``) step-times per new token, prefill
costs ``prefill_cost`` (= 0.05, serve_load ``_DISAGG_PREFILL_COST``)
step-times per prompt position, and a replica spends ``compile_s``
between creation and readiness (weights to the card, engine set-up and
its first step; the reference's program compile — the delay that makes
scale-up horizons real: ``replicas_ready`` lands observably later than
the patch). The defaults are hand-picked, not a measurement;
``sim/calibrate`` fits them from measurements of the port on the card.
The blueprint: decouple the workload from hardware behind a device layer
priced by a calibrated cost model.

Request lifecycle is event-driven (no per-step ticking): dispatch
computes the request's whole timeline — queue wait, prefill end, first
token, finish — from the cost model and schedules ONE completion event.
Preemption invalidates in-flight timelines by generation counter and
replays the requests (the ``replays`` count rides into span attrs, like
the gateway's crash replays).

Determinism: replica names are counter-derived, dispatch scans
insertion-ordered dicts, queues are FIFO deques — same seed, same
event sequence, same bytes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

from tpu_on_k8s_torch.metrics import ServingMetrics
from tpu_on_k8s_torch.sim.clock import EventLoop

#: `serve_load` virtual-mode cost constants (its ``_DISAGG_STEP_BASE``
#: and ``_DISAGG_PREFILL_COST``): decode step-times per new token and
#: per padded prefill position respectively
STEP_BASE = 1.0
PREFILL_COST = 0.05

REPLICA_STARTING = "starting"
REPLICA_READY = "ready"
REPLICA_DRAINING = "draining"


class _Phase:
    """Replica lifecycle phase with the ``.value`` shape the scraper
    reads (``getattr(rep.state, "value", ...)``)."""

    __slots__ = ("value",)

    def __init__(self, value: str) -> None:
        self.value = value


class _EngineStub:
    """The slice stand-in: just the slot capacity the scraper sums."""

    __slots__ = ("n_slots",)

    def __init__(self, n_slots: int) -> None:
        self.n_slots = n_slots


@dataclasses.dataclass(frozen=True)
class DeviceCostModel:
    """Latency pricing for one virtual slice. ``step_s`` is the decode
    step wall-time; everything else is priced in step-times by the
    serve_load constants above.

    Multi-model pricing mirrors `serve/modelpool.ModelPool`'s two-tier
    residency: dispatching a request for a model that is RESIDENT but
    not active costs ``swap_s`` (a params-tree pointer replace), one
    that is not resident costs ``swap_cold_s`` (host load + prepare)
    and evicts the LRU resident when the pool is at
    ``max_resident_models``. Both default to 0 with residency unbounded,
    so every single-model scenario prices exactly as before."""

    step_s: float = 0.05
    step_base: float = STEP_BASE
    prefill_cost: float = PREFILL_COST
    compile_s: float = 30.0
    n_slots: int = 8
    swap_s: float = 0.0
    swap_cold_s: float = 0.0
    max_resident_models: int = 0            # 0 = unbounded residency

    def prefill_s(self, prompt_len: int) -> float:
        return self.step_s * self.prefill_cost * prompt_len

    def decode_s(self, new_tokens: int) -> float:
        return self.step_s * self.step_base * new_tokens

    def service_s(self, prompt_len: int, new_tokens: int) -> float:
        return self.prefill_s(prompt_len) + self.decode_s(new_tokens)


class SimRequest:
    """One in-flight virtual request. Timeline fields are filled at
    dispatch; ``gen`` invalidates a scheduled completion after a
    preemption replay (the completion closure captures the generation
    it was scheduled under)."""

    __slots__ = ("rid", "tenant", "prompt_len", "new_tokens", "submit_t",
                 "dispatch_t", "prefill_end_t", "first_token_t",
                 "finish_t", "replica", "replays", "gen", "model")

    def __init__(self, rid: int, tenant: str, prompt_len: int,
                 new_tokens: int, submit_t: float,
                 model: str = "") -> None:
        self.rid = rid
        self.tenant = tenant
        self.model = model
        self.prompt_len = int(prompt_len)
        self.new_tokens = max(int(new_tokens), 1)
        self.submit_t = submit_t
        self.dispatch_t = 0.0
        self.prefill_end_t = 0.0
        self.first_token_t = 0.0
        self.finish_t = 0.0
        self.replica = ""
        self.replays = 0
        self.gen = 0

    @property
    def queue_wait(self) -> float:
        return self.dispatch_t - self.submit_t

    @property
    def ttft(self) -> float:
        return self.first_token_t - self.submit_t


class SimReplica:
    """One virtual serving replica: the scraper-facing attribute set
    plus slot bookkeeping. ``engine`` is None until the compile
    finishes — a starting replica contributes no slot capacity, exactly
    like a real replica whose engine has not come up. ``active_model``
    / ``resident`` mirror the model pool: one active params tree, an
    LRU set of resident ones (insertion-ordered dict, oldest first)."""

    __slots__ = ("name", "cost", "state", "engine", "metrics",
                 "outstanding", "routable", "inflight", "active_model",
                 "resident")

    def __init__(self, name: str, cost: DeviceCostModel) -> None:
        self.name = name
        self.cost = cost
        self.state = _Phase(REPLICA_STARTING)
        self.engine: Optional[_EngineStub] = None
        self.metrics = ServingMetrics()
        self.outstanding = 0
        self.routable = False
        self.inflight: Dict[int, SimRequest] = {}   # rid -> request
        self.active_model = ""
        self.resident: Dict[str, None] = {}         # LRU, oldest first

    @property
    def free_slots(self) -> int:
        if self.engine is None or not self.routable:
            return 0
        return self.engine.n_slots - self.outstanding


class SimFleet:
    """The virtual fleet: FIFO admission queue, deterministic dispatch,
    ``scale_to`` (the autoscaler's apply target), replica preemption.

    ``on_complete(req)`` is the twin's hook, called at each request's
    completion instant (the clock reads the finish time): it mints the
    span tree and returns the trace id to cite as the TTFT exemplar —
    or None to cite nothing (the sampling knob sheds that trace, and an
    exemplar nothing retains must never be emitted)."""

    def __init__(self, loop: EventLoop, *,
                 cost: Optional[DeviceCostModel] = None,
                 replicas: int = 1, max_queue_depth: int = 10_000,
                 on_complete: Optional[
                     Callable[[SimRequest], Optional[int]]] = None) -> None:
        self.loop = loop
        self.cost = cost if cost is not None else DeviceCostModel()
        self.max_queue_depth = max_queue_depth
        self.on_complete = on_complete
        self.replicas: Dict[str, SimReplica] = {}
        self.queue: Deque[SimRequest] = deque()
        self.stats = {"scale_ups": 0, "scale_downs": 0, "preemptions": 0,
                      "model_swaps": 0, "model_loads": 0,
                      "model_evictions": 0}
        self.served = 0
        self.rejected = 0
        self.replayed = 0
        self._next_replica = 0
        self._desired = 0
        for _ in range(replicas):
            self._add_replica(warm=True)

    # ------------------------------------------------------------- capacity
    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def size(self) -> int:
        """Non-draining replica count — what ``scale_to`` targets."""
        return sum(1 for r in self.replicas.values()
                   if r.state.value != REPLICA_DRAINING)

    @property
    def ready_count(self) -> int:
        return sum(1 for r in self.replicas.values() if r.routable)

    def has_live_requests(self) -> bool:
        return bool(self.queue) or any(r.outstanding
                                       for r in self.replicas.values())

    def _add_replica(self, *, warm: bool = False) -> SimReplica:
        name = f"sim-{self._next_replica}"
        self._next_replica += 1
        rep = SimReplica(name, self.cost)
        self.replicas[name] = rep
        self._desired += 1
        if warm:
            self._make_ready(rep)
        else:
            self.loop.after(self.cost.compile_s,
                            lambda: self._make_ready(rep))
        return rep

    def _make_ready(self, rep: SimReplica) -> None:
        if rep.state.value == REPLICA_STARTING:
            rep.state = _Phase(REPLICA_READY)
            rep.engine = _EngineStub(self.cost.n_slots)
            rep.routable = True
            self._dispatch()

    def scale_to(self, target: int) -> None:
        """The autoscaler's in-process apply: grow with cold (compiling)
        replicas, shrink by draining from the newest name down —
        revived drains come first on the way back up, like a real
        rollout reusing still-warm pods."""
        target = max(int(target), 0)
        current = self.size
        if target > current:
            self.stats["scale_ups"] += 1
            draining = sorted(n for n, r in self.replicas.items()
                              if r.state.value == REPLICA_DRAINING)
            for name in draining[:target - current]:
                rep = self.replicas[name]
                rep.state = _Phase(REPLICA_READY)
                rep.routable = True
                self._desired += 1
                current += 1
            while current < target:
                self._add_replica()
                current += 1
            self._dispatch()
        elif target < current:
            self.stats["scale_downs"] += 1
            active = sorted(n for n, r in self.replicas.items()
                            if r.state.value != REPLICA_DRAINING)
            for name in reversed(active[target:]):
                self._drain(self.replicas[name])

    def _drain(self, rep: SimReplica) -> None:
        rep.state = _Phase(REPLICA_DRAINING)
        rep.routable = False
        self._desired -= 1
        if rep.outstanding == 0:
            self.replicas.pop(rep.name, None)

    def preempt_replica(self, name: str) -> int:
        """Kill a replica instantly (chaos/broker preemption): its
        in-flight requests replay through the queue head in rid order;
        their scheduled completions are invalidated by generation.
        Returns the number of replayed requests."""
        rep = self.replicas.pop(name, None)
        if rep is None:
            return 0
        self.stats["preemptions"] += 1
        if rep.state.value != REPLICA_DRAINING:
            self._desired -= 1
        replay = [rep.inflight[rid] for rid in sorted(rep.inflight)]
        for req in reversed(replay):
            req.gen += 1
            req.replays += 1
            req.replica = ""
            self.queue.appendleft(req)
        self.replayed += len(replay)
        rep.inflight.clear()
        rep.outstanding = 0
        rep.routable = False
        self._dispatch()
        return len(replay)

    # -------------------------------------------------------------- serving
    def submit(self, req: SimRequest) -> bool:
        """Admit one request (False = queue full, rejected)."""
        if len(self.queue) >= self.max_queue_depth:
            self.rejected += 1
            return False
        self.queue.append(req)
        self._dispatch()
        return True

    def _pick_replica(self, model: str = "") -> Optional[SimReplica]:
        """Most-free-slots routing, name tie-break — deterministic and
        balancing, the shape the router's least-loaded policy has. With
        a model, affinity ranks first (active model beats resident beats
        cold), the model-key salting the fleet router's ``route_model``
        applies: swaps happen only when no warm replica has room."""
        best: Optional[SimReplica] = None
        best_rank = None
        for name in sorted(self.replicas):
            rep = self.replicas[name]
            if rep.free_slots <= 0:
                continue
            if model and rep.active_model != model:
                affinity = 1 if model in rep.resident else 2
            else:
                affinity = 0
            rank = (affinity, -rep.free_slots)
            if best is None or rank < best_rank:
                best, best_rank = rep, rank
        return best

    def _swap_in(self, rep: SimReplica, model: str) -> float:
        """Price one model activation on ``rep`` and update its
        residency LRU. Returns the swap-in delay: ``swap_s`` when the
        model was already resident (pointer replace), ``swap_cold_s``
        when it had to be loaded — evicting the LRU resident (and, in
        the real pool, surgically flushing its prefixes) when the pool
        is at ``max_resident_models``."""
        cost = self.cost
        warm = model in rep.resident
        delay = cost.swap_s if warm else cost.swap_cold_s
        if warm:
            del rep.resident[model]         # move-to-end: refresh LRU
        else:
            self.stats["model_loads"] += 1
            cap = cost.max_resident_models
            if cap > 0:
                while len(rep.resident) >= cap:
                    victim = next(iter(rep.resident))
                    del rep.resident[victim]
                    self.stats["model_evictions"] += 1
        rep.resident[model] = None
        rep.active_model = model
        self.stats["model_swaps"] += 1
        rep.metrics.observe("swap_seconds", delay)
        return delay

    def _dispatch(self) -> None:
        now = self.loop.clock.t
        while self.queue:
            req = self.queue[0]
            rep = self._pick_replica(req.model)
            if rep is None:
                return
            self.queue.popleft()
            cost = self.cost
            swap = 0.0
            if req.model and rep.active_model != req.model:
                swap = self._swap_in(rep, req.model)
            elif req.model:
                del rep.resident[req.model]  # refresh LRU on every hit
                rep.resident[req.model] = None
            req.dispatch_t = now
            req.prefill_end_t = now + swap + cost.prefill_s(req.prompt_len)
            req.first_token_t = req.prefill_end_t + cost.step_s
            req.finish_t = (req.prefill_end_t
                            + cost.decode_s(req.new_tokens))
            req.replica = rep.name
            rep.outstanding += 1
            rep.inflight[req.rid] = req
            gen = req.gen
            self.loop.at(req.finish_t,
                         lambda r=req, g=gen: self._complete(r, g))

    def _complete(self, req: SimRequest, gen: int) -> None:
        if req.gen != gen:
            return                          # preempted: a replay owns it now
        rep = self.replicas.get(req.replica)
        if rep is None:
            return                          # replica vanished uncleanly
        rep.outstanding -= 1
        rep.inflight.pop(req.rid, None)
        self.served += 1
        exemplar = (self.on_complete(req)
                    if self.on_complete is not None else None)
        m = rep.metrics
        m.observe("queue_wait_seconds", req.queue_wait)
        m.observe("time_to_first_token_seconds", req.ttft,
                  exemplar=exemplar)
        m.observe("time_per_output_token_seconds", self.cost.step_s)
        if rep.state.value == REPLICA_DRAINING and rep.outstanding == 0:
            self.replicas.pop(rep.name, None)
        self._dispatch()
