"""ServingFleet: many engine replicas behind one routed front door.

One ``ServingGateway`` serves one engine; heavy traffic is a *fleet*
problem. ``ServingFleet`` owns N replicas — each an engine + its own
gateway (bounded admission, fairness, deadlines, in-place crash replay
all unchanged) — and adds the three things only a fleet can do:

* **Routing** (`serve/router.py`): least-outstanding-tokens balancing
  with prefix affinity — repeated prompt prefixes land on the replica
  whose engine cache is warm (the fleet auto-registers each prompt's
  ``prefix_bucket_len``-token head as an engine prefix on first sight,
  so affinity hits skip that prefill entirely) — and weighted canary
  splits across model versions during a rollout.
* **Replica lifecycle** (`serve/health.py`): slow-start readiness before
  a replica takes traffic, liveness by progress, and **ejection** with
  cross-replica replay — a replica crash (``ReplicaCrash`` chaos, or a
  wedged liveness probe) moves every one of its live requests to a
  surviving replica under the same ``ReplayPolicy`` budget and typed
  outcomes the single-gateway replay uses: zero silent loss.
* **Zero-loss rolling rollout**: ``start_rollout(factory, "v2")`` surges
  new-version replicas within ``max_surge``, waits for slow-start
  readiness, shifts router weight (``canary_weight`` first, growing with
  the replaced fraction), then drains old replicas — stop accepting,
  finish in-flight, remove only when empty (or cancel typed-ly past the
  drain timeout). The controller twin of this machine is
  `controller/inferenceservice.py`; this is the in-process plane the
  deterministic rollout test pins step by step.

Threading model matches the gateway's: ONE driver thread calls
``step()`` / ``run()`` / ``drain()``; frontend threads call ``submit()``
/ ``cancel()`` / ``result()`` / ``state()``. The fleet also publishes
its load signal in the ElasticAutoscaler observation-line format
(``observation_line()``) so replica *count* can ride the same scaling
loop training replicas do.
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.autoscale.signals import (
    FleetScraper,
    format_observation_line,
)
from tpu_on_k8s_torch.metrics import ServingMetrics
from tpu_on_k8s_torch.obs.trace import ensure as ensure_tracer
from tpu_on_k8s_torch.serve.admission import (
    REASON_DRAINING,
    REASON_UNAVAILABLE,
    AdmissionConfig,
    Rejected,
)
from tpu_on_k8s_torch.serve.gateway import ReplayPolicy, ServingGateway
from tpu_on_k8s_torch.serve.health import (
    ACTIVE_STATES,
    HealthMonitor,
    ProbeConfig,
    ReplicaState,
)
from tpu_on_k8s_torch.serve.lifecycle import (
    LIVE_STATES,
    RequestResult,
    RequestState,
)
from tpu_on_k8s_torch.serve.router import Router

#: "match not precomputed" sentinel — None is a real match_prefix result
_UNSET = object()


class RolloutPhase(str, enum.Enum):
    """Fleet rollout position (mirrored into ``FleetMetrics`` as the
    ``rollout_phase`` gauge via stable codes)."""

    IDLE = "idle"
    SURGING = "surging"        # bringing up new-version capacity
    SHIFTING = "shifting"      # new capacity ready; weight moving over
    DRAINING = "draining"      # old replicas finishing in-flight work
    COMPLETE = "complete"


@dataclasses.dataclass(frozen=True)
class FleetRolloutPolicy:
    """``max_surge`` extra replicas may exist during the rollout;
    ``canary_weight`` is the new version's traffic share once its first
    replica is ready (grows with the replaced fraction after);
    ``drain_timeout_s`` bounds how long an old replica may take to
    finish in-flight work before stragglers are cancelled (typed, never
    dropped). None = wait forever."""

    max_surge: int = 1
    canary_weight: float = 0.1
    drain_timeout_s: Optional[float] = 30.0

    def __post_init__(self) -> None:
        if self.max_surge < 1:
            raise ValueError(f"max_surge must be >= 1, got "
                             f"{self.max_surge}")
        if not 0.0 <= self.canary_weight <= 1.0:
            raise ValueError(f"canary_weight must be in [0, 1], got "
                             f"{self.canary_weight}")


class Replica:
    """One engine + gateway + health record. ``outstanding`` is the token
    cost (prompt + max_new) of every live request routed here — the
    router's balance signal; ``prefix_ids`` maps affinity bucket keys to
    engine-registered prefixes (the warm cache the router exploits)."""

    def __init__(self, name: str, version: str, engine,
                 gateway: ServingGateway, metrics: Optional[ServingMetrics],
                 health: HealthMonitor) -> None:
        self.name = name
        self.version = version
        self.engine = engine
        self.gateway = gateway
        self.metrics = metrics
        self.health = health
        self.state = ReplicaState.STARTING
        self.outstanding = 0
        self.prefix_ids: Dict[int, int] = {}
        self.routed = 0

    @property
    def routable(self) -> bool:
        return self.state is ReplicaState.READY


@dataclasses.dataclass
class _FleetRequest:
    """Fleet-side record: everything needed to re-dispatch the request to
    another replica after an ejection (the gateway's record dies with its
    replica; the fleet's survives)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    tenant: str
    priority: int
    eos_id: Optional[int]
    deadline: Optional[float]          # absolute fleet-clock time
    on_token: Optional[Callable[[int, int], None]]
    cost: int
    state: RequestState = RequestState.QUEUED
    replica: Optional[str] = None      # current owner (None = fleet pending)
    sub_rid: Optional[int] = None      # id inside the owner's gateway
    replays: int = 0                   # cross-replica re-dispatches
    tokens: Optional[np.ndarray] = None
    cancel_requested: bool = False
    # the request's root span (`tpu_on_k8s_torch/obs/trace.py`) — owned by the
    # fleet (gateways attach their queue/decode children to it via
    # ``trace_parent`` and never finish it); None when tracing is off
    span: object = None


class ServingFleet:
    """See module doc. ``engine_factory(replica_name)`` builds one engine
    per replica (tests hand in tiny engines; production hands in the
    flagship constructor)."""

    def __init__(self, engine_factory: Callable[[str], object],
                 n_replicas: int, *, version: str = "v1",
                 admission: Optional[AdmissionConfig] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 replay: Optional[ReplayPolicy] = None,
                 probe: Optional[ProbeConfig] = None,
                 router: Optional[Router] = None,
                 prefix_bucket_len: int = 128,
                 auto_register_prefixes: bool = True,
                 max_prefixes_per_replica: int = 16,
                 replica_metrics: bool = True,
                 metrics=None, shard_metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None) -> None:
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self._factory = engine_factory
        #: optional ``metrics.ShardMetrics``: each replica's mesh shape at
        #: creation and the reshard rollouts
        self.shard_metrics = shard_metrics
        self._admission = admission
        self._tenant_weights = tenant_weights
        self._replay = replay or ReplayPolicy()
        self._probe = probe or ProbeConfig()
        self._clock = clock
        # one tracer for the fleet AND every replica gateway it mints:
        # a request's routing, queue waits, decode attempts, and
        # re-routes all land on one counter-coherent span tree
        self._tracer = ensure_tracer(tracer)
        #: optional ``FleetMetrics`` (per-replica labelled gauges/counters)
        self.metrics = metrics
        self._replica_metrics = replica_metrics
        self._auto_prefix = auto_register_prefixes
        self._max_prefixes = max_prefixes_per_replica
        self.router = router or Router(prefix_bucket_len)
        self.desired_replicas = n_replicas
        self.version = version
        self.replicas: Dict[str, Replica] = {}
        self._requests: Dict[int, _FleetRequest] = {}
        self._by_sub: Dict[Tuple[str, int], int] = {}
        self._pending: List[int] = []     # rids waiting for a ready replica
        self._newly_terminal: List[int] = []
        # flight-recorder dump reasons noted under the fleet lock,
        # written (file I/O) outside it at the end of step() — same
        # deferral as DisaggFleet._deferred_dumps
        self._deferred_dumps: List[str] = []
        self._next_rid = 0
        self._next_ordinal = 0
        self._accepting = True
        self._scaledown: set = set()      # replica names draining for scale-down
        self._obs_scraper = None          # observation_line's delta reader
        self._rollout = None              # type: Optional[_Rollout]
        self.rollout_phase = RolloutPhase.IDLE
        #: records of removed replicas: {"name", "version", "reason",
        #: "drained_clean"} — the rollout test's old-replica-drained proof
        self.retired: List[Dict[str, object]] = []
        self.stats = {"steps": 0, "routed": 0, "rerouted": 0,
                      "ejected": 0, "prefix_hits": 0, "prefix_misses": 0,
                      "readiness_flaps": 0, "rollout_interrupts": 0,
                      "rollouts_completed": 0, "scale_ups": 0,
                      "scale_downs": 0, "rebalanced": 0,
                      # rollouts whose winning replicas ran a different
                      # mesh than the replaced ones (a ShardingPolicy
                      # flip riding the ordinary rollout machinery)
                      "reshard_rollouts": 0}
        self._lock = threading.Lock()
        for _ in range(n_replicas):
            self._add_replica(engine_factory, version)
        self.router.set_weights({version: 1.0})

    # ---------------------------------------------------------- replica mgmt
    def _add_replica(self, factory: Callable[[str], object],
                     version: str) -> Replica:
        name = f"replica-{self._next_ordinal}"
        self._next_ordinal += 1
        engine = factory(name)
        # a mesh-sharded replica spans several chips: the router's
        # bounded-load balance normalizes outstanding tokens by chip
        # count
        self.router.set_capacity(name,
                                 int(getattr(engine, "n_chips", 1) or 1))
        if self.shard_metrics is not None:
            # one writer for the mesh gauges: the fleet converges to one
            # shape, so the last replica built wins
            self.shard_metrics.set_mesh_axes(
                getattr(engine, "mesh_axes", {}) or {})
        rmetrics = ServingMetrics() if self._replica_metrics else None
        gateway = ServingGateway(
            engine, self._admission, tenant_weights=self._tenant_weights,
            metrics=rmetrics, clock=self._clock, replay=self._replay,
            tracer=self._tracer if self._tracer.enabled else None)
        rep = Replica(name, version, engine, gateway, rmetrics,
                      HealthMonitor(self._probe))
        self.replicas[name] = rep
        self.router.add_replica(name, version)
        return rep

    def _retire_replica(self, rep: Replica, *, state: ReplicaState,
                        reason: str, drained_clean: bool) -> None:
        rep.state = state
        self.router.remove_replica(rep.name)
        self.retired.append({"name": rep.name, "version": rep.version,
                             "reason": reason,
                             "drained_clean": drained_clean})
        # release the engine (params + device KV pool) and gateway: a
        # long-lived server rolls out repeatedly, and keeping every dead
        # replica's model weights referenced would accumulate to OOM.
        # The record above, .metrics, .routed, and .state stay readable.
        close = getattr(rep.engine, "close", None)
        if close is not None:
            close()                 # a mesh engine's workers drop theirs
        rep.engine = None
        rep.gateway = None
        rep.prefix_ids.clear()
        self._scaledown.discard(rep.name)
        if self.metrics is not None:
            # zero the dead replica's labelled gauges — a retired series
            # frozen at its last value reads as phantom load forever
            for name in ("in_flight", "queue_depth", "outstanding_tokens"):
                self.metrics.set_gauge(name, 0, replica=rep.name)

    def _mesh_signature_locked(self) -> Tuple:
        """Stable mesh signature of the fleet's active replicas (the
        first live engine's non-trivial axes, as sorted items) — what
        reshard-rollout detection compares. Lock held (or init)."""
        for rep in self.replicas.values():
            if rep.state in ACTIVE_STATES and rep.engine is not None:
                return tuple(sorted(
                    dict(getattr(rep.engine, "mesh_axes", {}) or {})
                    .items()))
        return ()

    def _ready_names(self) -> List[str]:
        return [r.name for r in self.replicas.values() if r.routable]

    @staticmethod
    def _ordinal(name: str) -> int:
        try:
            return int(name.rsplit("-", 1)[-1])
        except ValueError:
            return -1

    def scale_to(self, n: int,
                 factory: Optional[Callable[[str], object]] = None) -> int:
        """Resize the fleet to ``n`` replicas of the current serving
        version (the execution half of the SLO autoscaler's loop —
        `controller/fleetautoscaler.py` calls this after patching
        ``InferenceService.spec.replicas``; the CRD-plane twin is the
        reconciler's surge/drain machinery).

        Scale-up adds fresh replicas immediately (they earn readiness
        through slow start before taking traffic). Scale-down NEVER
        removes a replica outright: victims — not-yet-ready replicas
        first (nothing routed at them), then the highest-ordinal ready
        ones — are marked DRAINING (``stop_accepting``; in-flight work
        finishes) and only reaped by ``step()`` once their gateway is
        empty, and a READY victim is only marked while the remaining
        ready count stays >= ``n`` (the ready floor). Returns the
        number of replicas added (+) or marked draining (-).
        Refused mid-rollout: two machines moving ``desired_replicas``
        at once cannot both be right."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        with self._lock:
            if self._rollout is not None:
                raise RuntimeError("cannot scale during a rollout")
            self.desired_replicas = n
            live = [r for r in self.replicas.values()
                    if r.state in (ReplicaState.STARTING, ReplicaState.READY)]
            cur = len(live)
            if n > cur:
                need = n - cur
                # reclaim still-draining scale-down victims first: a
                # warm engine already holding its weights beats minutes
                # of fresh-replica spin-up, and leaving it to drain
                # while minting a replacement would transiently hold
                # more slices than the operator configured
                for name in sorted(self._scaledown, key=self._ordinal):
                    if need <= 0:
                        break
                    rep = self.replicas.get(name)
                    if rep is None or rep.state is not ReplicaState.DRAINING:
                        continue
                    rep.gateway.resume_accepting()
                    rep.state = (ReplicaState.READY if rep.health.ready
                                 else ReplicaState.STARTING)
                    self._scaledown.discard(name)
                    need -= 1
                for _ in range(need):
                    self._add_replica(factory or self._factory, self.version)
                self.stats["scale_ups"] += 1
                if self.metrics is not None:
                    self.metrics.inc("scale_ups")
                return n - cur
            if n == cur:
                return 0
            excess = cur - n
            ready = sum(1 for r in live if r.state is ReplicaState.READY)
            victims: List[Replica] = []
            starting = sorted(
                (r for r in live if r.state is ReplicaState.STARTING),
                key=lambda r: -self._ordinal(r.name))
            victims.extend(starting[:excess])
            for rep in sorted(
                    (r for r in live if r.state is ReplicaState.READY),
                    key=lambda r: -self._ordinal(r.name)):
                if len(victims) >= excess:
                    break
                if ready - 1 < n:
                    break      # ready floor: keep n replicas routable
                ready -= 1
                victims.append(rep)
            for rep in victims:
                rep.state = ReplicaState.DRAINING
                rep.gateway.stop_accepting()
                self._scaledown.add(rep.name)
            if victims:
                self.stats["scale_downs"] += 1
                if self.metrics is not None:
                    self.metrics.inc("scale_downs")
            return -len(victims)

    def _reap_scaledown_locked(self) -> None:
        """Retire scale-down victims whose drain finished: gateway empty
        means every routed request reached a typed terminal state — the
        zero-silent-loss half of the scale-down contract."""
        for name in sorted(self._scaledown):
            rep = self.replicas.get(name)
            if rep is None or rep.state is not ReplicaState.DRAINING:
                self._scaledown.discard(name)
                continue
            if rep.gateway is not None and not rep.gateway.has_live_requests:
                self._retire_replica(rep, state=ReplicaState.STOPPED,
                                     reason="scale-down drain complete",
                                     drained_clean=True)

    def _outstanding(self) -> Dict[str, int]:
        return {r.name: r.outstanding for r in self.replicas.values()}

    # ---------------------------------------------------------- frontend API
    def submit(self, prompt, max_new_tokens: int, *, tenant: str = "default",
               priority: int = 0, deadline_s: Optional[float] = None,
               eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> Union[int, Rejected]:
        """Route and admit one request; returns the fleet request id or a
        typed ``Rejected`` (no ready replica, or the chosen replica's own
        admission refused it). Ids are fleet-scoped — ``on_token`` and
        ``result()`` speak fleet ids even across re-routes."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            if not self._accepting:
                return Rejected(REASON_DRAINING, "fleet is draining")
            # ONE noted-prefix scan per submit: routing and the prefix
            # plan both consume this match instead of re-scanning
            pmatch, pkey = self.router.affinity(prompt)
            target = self.router.route(prompt, self._ready_names(),
                                       self._outstanding(), key=pkey)
            if target is None:
                return Rejected(REASON_UNAVAILABLE,
                                "no replica is ready for traffic",
                                retry_after_hint=1.0)
            rep = self.replicas[target]
            rid = self._next_rid
            self._next_rid += 1
            now = self._clock()
            req = _FleetRequest(
                rid=rid, prompt=prompt, max_new_tokens=max_new_tokens,
                tenant=tenant, priority=priority, eos_id=eos_id,
                deadline=(now + deadline_s if deadline_s is not None
                          else None),
                on_token=on_token,
                cost=int(prompt.size) + max_new_tokens)
            req.span = self._tracer.start(
                "request", rid=rid, tenant=tenant, priority=priority,
                prompt_tokens=int(prompt.size),
                max_new_tokens=max_new_tokens)
            send, pid, key, reg = self._prefix_plan_locked(
                prompt, rep, allow_register=True, match=pmatch)
            if reg is None:
                r = self._dispatch_locked(req, rep, send, pid)
                if isinstance(r, Rejected):
                    if req.span is not None:
                        req.span.finish(RequestState.REJECTED.value)
                    return r
                self._requests[rid] = req
                return rid
            self._requests[rid] = req     # parked while we register
        # first sight of this prefix bucket: prefill it OUTSIDE the fleet
        # lock — register_prefix is real device work (plus a possible XLA
        # compile on a cold bucket) and holding the fleet-wide lock across
        # it would stall the driver and every other frontend call. The
        # bucket is marked pending under the lock above, so a concurrent
        # same-bucket submit serves cold instead of double-registering.
        try:
            new_pid = rep.engine.register_prefix(reg)
        # analyze: allow[silent-loss] typed fallback: serve cold; a dead replica is ejected by the next fleet step
        except Exception:                  # noqa: BLE001 — replica died
            new_pid = None                 # under us; serve cold instead
        with self._lock:
            if new_pid is not None and rep.prefix_ids.get(key,
                                                          -1) is None:
                rep.prefix_ids[key] = new_pid
                # teach the router the registered CONTENT: prompts that
                # share this prefix but diverge before the raw bucket
                # boundary now key to the same replica (for the fleet's
                # own bucket-length heads the key is unchanged)
                self.router.note_prefix(reg)
            else:
                rep.prefix_ids.pop(key, None)
            if req.state not in LIVE_STATES:
                return rid                 # cancelled while registering
            if rep.state is not ReplicaState.READY:
                # the replica flapped/ejected while we prefilled: let the
                # pending machinery find the request a new home
                if rid not in self._pending:
                    self._pending.append(rid)
                return rid
            if new_pid is not None:
                send, pid = prompt[reg.size:], new_pid
            r = self._dispatch_locked(req, rep, send, pid)
            if isinstance(r, Rejected):
                del self._requests[rid]
                if req.span is not None:
                    req.span.finish(RequestState.REJECTED.value)
                return r
            return rid

    def cancel(self, request_id: int) -> bool:
        with self._lock:
            req = self._requests.get(request_id)
            if req is None or req.state not in LIVE_STATES:
                return False
            # mark first, then forward: if an ejection re-routes this
            # request before/while the gateway-level cancel lands, the
            # mark makes _eject_locked finalize it CANCELLED instead of
            # silently re-dispatching it (the gateway cancel dies with
            # the ejected gateway). Ejection runs under this same lock,
            # so holding it across the forward closes the race.
            req.cancel_requested = True
            if req.replica is None:               # fleet-level pending
                try:
                    self._pending.remove(request_id)
                except ValueError:
                    pass
                self._finalize_locked(req, RequestState.CANCELLED)
                return True
            return self.replicas[req.replica].gateway.cancel(req.sub_rid)

    def result(self, request_id: int) -> Optional[RequestResult]:
        with self._lock:
            req = self._requests.get(request_id)
            if req is None or req.state in LIVE_STATES:
                return None
            del self._requests[request_id]
            tokens = (req.tokens if req.tokens is not None
                      else np.zeros(0, np.int32))
            return RequestResult(request_id, req.state, tokens)

    def state(self, request_id: int) -> Optional[RequestState]:
        with self._lock:
            req = self._requests.get(request_id)
            return None if req is None else req.state

    def replica_of(self, request_id: int) -> Optional[str]:
        """The replica that holds the request, or that served it while its
        result is unclaimed; None for an unknown id or one waiting at the
        fleet level."""
        with self._lock:
            req = self._requests.get(request_id)
            return None if req is None else req.replica

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return (len(self._pending)
                    + sum(r.gateway.queue_depth
                          for r in self.replicas.values()
                          if r.state in ACTIVE_STATES))

    # ------------------------------------------------------------- dispatch
    def _dispatch_locked(self, req: _FleetRequest, rep: Replica,
                         send: Optional[np.ndarray] = None,
                         prefix_id: Optional[int] = None,
                         match=_UNSET) -> Union[int, Rejected]:
        """Hand ``req`` to ``rep``'s gateway. ``submit()`` passes the
        prepared (suffix, prefix id) pair in; re-dispatch paths leave
        them None and get a no-registration prefix plan (a hit when the
        bucket is already warm, a cold full prompt otherwise — re-routes
        never pay a registration prefill under the lock). Lock held."""
        if send is None:
            send, prefix_id, _, _ = self._prefix_plan_locked(
                req.prompt, rep, allow_register=False, match=match)
        now = self._clock()
        deadline_s = None
        if req.deadline is not None:
            deadline_s = req.deadline - now   # <=0: the gateway rejects it
        on_token = None
        if req.on_token is not None:
            user = req.on_token

            def on_token(_sub_rid: int, token: int,
                         _rid: int = req.rid) -> None:
                user(_rid, token)   # frontend speaks fleet ids
        r = rep.gateway.submit(send, req.max_new_tokens, tenant=req.tenant,
                               priority=req.priority, deadline_s=deadline_s,
                               eos_id=req.eos_id, prefix_id=prefix_id,
                               on_token=on_token, trace_parent=req.span)
        if isinstance(r, Rejected):
            return r
        if req.span is not None:
            # one event per placement — first route, crash re-route,
            # rebalance all read off the same timeline
            req.span.event("routed", replica=rep.name,
                           attempt=req.replays,
                           prefix_warm=prefix_id is not None)
        req.replica = rep.name
        req.sub_rid = r
        req.state = RequestState.QUEUED
        self._by_sub[(rep.name, r)] = req.rid
        rep.outstanding += req.cost
        rep.routed += 1
        self.stats["routed"] += 1
        if self.metrics is not None:
            self.metrics.inc("requests_routed", replica=rep.name)
        return r

    def _prefix_plan_locked(self, prompt: np.ndarray, rep: Replica, *,
                            allow_register: bool, match=_UNSET
                            ) -> Tuple[np.ndarray, Optional[int],
                                       Optional[int],
                                       Optional[np.ndarray]]:
        """Plan the prefix split for ``prompt`` on ``rep``: returns
        ``(tokens to submit, engine prefix id, bucket key, tokens to
        register)``. A warm bucket (the replica's engine already holds
        this prompt's affinity-bucket KV) submits only the suffix — the
        shared prefill is skipped (exact: the engine's prefix cache is
        position-absolute). First sight with ``allow_register`` marks the
        bucket pending and returns the head for the caller to
        ``register_prefix`` OUTSIDE the fleet lock; a pending or
        over-capacity bucket serves the full prompt cold. Lock held."""
        blen = self.router.prefix_bucket_len
        if (not self._auto_prefix or prompt.size <= blen
                or blen > rep.engine.max_len - 2):
            return prompt, None, None, None
        m = self.router.match_prefix(prompt) if match is _UNSET else match
        if m is not None and m[1] < blen:
            # The affinity key is a noted prefix SHORTER than the bucket:
            # two prompts sharing it may diverge inside [match, blen), so
            # the bucket-length engine-prefix registry must not be keyed
            # by it — splicing another prompt's head KV would silently
            # decode wrong tokens. Routing still gets the warm-replica
            # affinity; the engine serves this prompt cold.
            return prompt, None, None, None
        # the match above already IS the bucket key when it hit;
        # bucket_key() would re-run the whole noted-prefix scan
        key = m[0] if m is not None else self.router.head_key(prompt)
        pid = rep.prefix_ids.get(key, -1)
        if pid is not None and pid >= 0:
            self.stats["prefix_hits"] += 1
            if self.metrics is not None:
                self.metrics.inc("prefix_cache_hits")
            return prompt[blen:], pid, key, None
        self.stats["prefix_misses"] += 1
        if self.metrics is not None:
            self.metrics.inc("prefix_cache_misses")
        if (allow_register and pid == -1
                and len(rep.prefix_ids) < self._max_prefixes):
            rep.prefix_ids[key] = None        # pending — no double work
            return prompt, None, key, prompt[:blen].copy()
        return prompt, None, key, None

    def _rebalance_locked(self) -> None:
        """Queued work is pinned to the gateway it was dispatched into —
        so fresh capacity (a scale-up, a rollout surge, a replica back
        from a flap) would sit idle while an older replica's queue
        drains alone, and the SLO breach that triggered the scale-up
        would never heal. When a ready replica has free slots and an
        empty queue while another active replica holds queued work,
        evict that backlog (newest first; dispatched work never moves)
        back to the fleet pending queue — the router re-spreads it onto
        the idle capacity this same step. Bounded by the idle slot
        count, so a balanced fleet pays one queue-depth read per
        replica and moves nothing. Lock held."""
        ready = [r for r in self.replicas.values() if r.routable]
        if len(ready) < 2:
            return
        idle = [r for r in ready
                if r.gateway.queue_depth == 0 and r.engine.free_slots > 0]
        if not idle:
            return
        budgets = {r.name: r.engine.free_slots for r in idle}
        idle_cap = sum(budgets.values())
        donors = sorted((r for r in ready if r.gateway.queue_depth > 0),
                        key=lambda r: -r.gateway.queue_depth)
        for rep in donors:
            if idle_cap <= 0:
                break
            # prefix-warm requests stay: they were pinned here FOR the
            # warm engine cache, and moving one trades a guaranteed hit
            # for a cold prefill elsewhere — affinity's imbalance is a
            # deliberate trade the rebalancer must not undo
            for sub in rep.gateway.evict_queued(
                    idle_cap, skip=lambda r: r.prefix_id is not None):
                rid = self._by_sub.pop((rep.name, sub), None)
                if rid is None:
                    continue
                req = self._requests[rid]
                rep.outstanding -= req.cost
                req.replica = None
                req.sub_rid = None
                # place directly onto the least-loaded idle replica —
                # the router's affinity-with-bounded-load would happily
                # send a small request straight back to the donor it was
                # just evicted from (its outstanding lead can sit under
                # spill_tokens while its queue is deep)
                target = min(
                    (r for r in idle if budgets[r.name] > 0),
                    key=lambda r: (r.outstanding, self._ordinal(r.name)),
                    default=None)
                r = (self._dispatch_locked(req, target)
                     if target is not None else None)
                if target is None or isinstance(r, Rejected):
                    if rid not in self._pending:
                        self._pending.append(rid)
                    continue
                budgets[target.name] -= 1
                idle_cap -= 1
                self.stats["rebalanced"] += 1
                if self.metrics is not None:
                    self.metrics.inc("requests_rebalanced",
                                     replica=target.name)

    # -------------------------------------------------------------- ejection
    def _eject_locked(self, rep: Replica, reason: str) -> None:
        """Replica death: remove it from the routable set and move every
        live request it owned to a survivor (or the fleet pending queue),
        spending one unit of the per-request ``ReplayPolicy`` budget —
        the cross-replica twin of the gateway's in-place replay. Requests
        out of budget finalize ``RETRY_EXHAUSTED``; none vanish."""
        self._retire_replica(rep, state=ReplicaState.EJECTED,
                             reason=reason, drained_clean=False)
        self.stats["ejected"] += 1
        if self.metrics is not None:
            self.metrics.inc("replicas_ejected")
        victims = [r for r in self._requests.values()
                   if r.replica == rep.name and r.state in LIVE_STATES]
        now = self._clock()
        for req in sorted(victims, key=lambda r: r.rid):
            self._by_sub.pop((rep.name, req.sub_rid), None)
            req.replica = None
            req.sub_rid = None
            if req.span is not None:
                req.span.event("ejected", replica=rep.name, reason=reason)
            if req.cancel_requested:
                # the client's cancel died with the ejected gateway —
                # honor it here instead of re-dispatching the request
                self._finalize_locked(req, RequestState.CANCELLED)
                continue
            if req.replays >= self._replay.max_replays:
                self._finalize_locked(req, RequestState.RETRY_EXHAUSTED)
                continue
            if req.deadline is not None and now >= req.deadline:
                self._finalize_locked(req, RequestState.DEADLINE_EXCEEDED)
                continue
            req.replays += 1
            self.stats["rerouted"] += 1
            if self.metrics is not None:
                self.metrics.inc("requests_rerouted", replica=rep.name)
            self._route_pending_locked(req)
        # the ejected gateway's open spans die with it (they never
        # finish); the flight ring still holds the recent finished ones.
        # Dump deferred: this runs under the fleet lock, and recorder
        # file I/O must not block every submit()/step()
        self._deferred_dumps.append("replica_ejected")

    def _route_pending_locked(self, req: _FleetRequest) -> None:
        """Re-dispatch a homeless request now if a ready replica exists;
        otherwise park it in the fleet pending queue (retried every
        step). No backoff: unlike an in-place replay onto a
        just-crashed engine, the target here is a healthy survivor."""
        pmatch, pkey = self.router.affinity(req.prompt)
        target = self.router.route(req.prompt, self._ready_names(),
                                   self._outstanding(), key=pkey)
        if target is not None:
            r = self._dispatch_locked(req, self.replicas[target],
                                      match=pmatch)
            if not isinstance(r, Rejected):
                return
        if req.rid not in self._pending:
            self._pending.append(req.rid)

    # ------------------------------------------------------------- lifecycle
    def _finalize_locked(self, req: _FleetRequest, state: RequestState,
                         tokens=None) -> None:
        if req.state not in LIVE_STATES:
            return
        req.state = state
        if tokens is not None:
            req.tokens = np.asarray(tokens, np.int32)
        if req.span is not None:
            req.span.finish(state.value)
        self._newly_terminal.append(req.rid)

    def _collect_replica_terminals_locked(self, rep: Replica,
                                          sub_rids: List[int]) -> None:
        for sub in sub_rids:
            rid = self._by_sub.pop((rep.name, sub), None)
            if rid is None:
                continue
            req = self._requests[rid]
            res = rep.gateway.result(sub)
            rep.outstanding -= req.cost
            if res is None:      # claimed elsewhere (shouldn't happen)
                self._finalize_locked(req, RequestState.DONE)
                continue
            self._finalize_locked(req, res.state, res.tokens)

    # --------------------------------------------------------------- driver
    def step(self) -> List[int]:
        """One fleet iteration: advance the rollout state machine, step
        every active replica's gateway (collecting fleet-id terminals),
        run health probes (slow-start readiness, liveness-by-progress,
        chaos crash/flap injection), re-dispatch fleet-pending requests,
        refresh gauges. Returns fleet ids newly terminal — notifications,
        like ``gateway.step``."""
        with self._lock:
            now = self._clock()
            self._advance_rollout_locked(now)
            self._reap_scaledown_locked()
            active = [r for r in self.replicas.values()
                      if r.state in ACTIVE_STATES]
        for rep in active:
            fault = chaos.fire(chaos.SITE_FLEET_REPLICA, replica=rep.name,
                               steps=self.stats["steps"])
            if isinstance(fault, chaos.ReplicaCrash):
                with self._lock:
                    self._eject_locked(rep, "chaos: replica crash")
                continue
            if isinstance(fault, chaos.ReadinessFlap):
                rep.health.flap(fault.steps)
                self.stats["readiness_flaps"] += 1
                if self.metrics is not None:
                    self.metrics.inc("readiness_flaps")
            emitted0 = rep.engine.stats["emitted"]
            terminals = rep.gateway.step()
            with self._lock:
                self._collect_replica_terminals_locked(rep, terminals)
                progressed = (rep.engine.stats["emitted"] > emitted0
                              or bool(terminals))
                busy = rep.gateway.has_live_requests
                rep.health.observe_step(progressed=progressed, busy=busy)
                if rep.state in (ReplicaState.STARTING, ReplicaState.READY):
                    if rep.health.wedged:
                        self._eject_locked(rep, "liveness: no progress "
                                           "while busy")
                        continue
                    rep.state = (ReplicaState.READY if rep.health.ready
                                 else ReplicaState.STARTING)
        with self._lock:
            self._rebalance_locked()
            for rid in list(self._pending):
                req = self._requests[rid]
                now = self._clock()
                if req.cancel_requested:
                    self._pending.remove(rid)
                    self._finalize_locked(req, RequestState.CANCELLED)
                    continue
                if req.deadline is not None and now >= req.deadline:
                    self._pending.remove(rid)
                    self._finalize_locked(req,
                                          RequestState.DEADLINE_EXCEEDED)
                    continue
                pmatch, pkey = self.router.affinity(req.prompt)
                target = self.router.route(req.prompt, self._ready_names(),
                                           self._outstanding(), key=pkey)
                if target is None:
                    continue
                r = self._dispatch_locked(req, self.replicas[target],
                                          match=pmatch)
                if not isinstance(r, Rejected):
                    self._pending.remove(rid)
            self.stats["steps"] += 1
            out, self._newly_terminal = self._newly_terminal, []
            dumps, self._deferred_dumps = self._deferred_dumps, []
            self._refresh_gauges_locked()
        # one dump per distinct reason per step, outside the lock
        for reason in dict.fromkeys(dumps):
            self._tracer.crash_dump(reason)
        return out

    def _refresh_gauges_locked(self) -> None:
        if self.metrics is None:
            return
        ready = 0
        for rep in self.replicas.values():
            if rep.state not in ACTIVE_STATES:
                continue
            ready += rep.routable
            in_flight = sum(1 for r in self._requests.values()
                            if r.replica == rep.name
                            and r.state in LIVE_STATES)
            self.metrics.set_gauge("in_flight", in_flight,
                                   replica=rep.name)
            self.metrics.set_gauge("queue_depth", rep.gateway.queue_depth,
                                   replica=rep.name)
            self.metrics.set_gauge("outstanding_tokens", rep.outstanding,
                                   replica=rep.name)
        self.metrics.set_gauge("replicas_ready", ready)
        self.metrics.set_gauge(
            "replicas_total",
            sum(r.state in ACTIVE_STATES for r in self.replicas.values()))
        self.metrics.set_rollout_phase(self.rollout_phase.value)

    def _live(self) -> bool:
        with self._lock:
            return any(r.state in LIVE_STATES
                       for r in self._requests.values())

    @property
    def has_live_requests(self) -> bool:
        return self._live()

    def run(self) -> Dict[int, RequestResult]:
        """Step until every accepted request is terminal (and any rollout
        in flight completes); claim and return all unclaimed results."""
        while self._live() or self._rollout is not None or self._scaledown:
            self.step()
        return self._claim_all()

    def stop_accepting(self) -> None:
        with self._lock:
            self._accepting = False
        for rep in self.replicas.values():
            if rep.state in ACTIVE_STATES:   # retired gateways are released
                rep.gateway.stop_accepting()

    def drain(self, timeout_s: Optional[float] = None
              ) -> Dict[int, RequestResult]:
        """Fleet-wide graceful shutdown: stop accepting, finish in-flight
        work everywhere, cancel stragglers past ``timeout_s``."""
        self.stop_accepting()
        deadline = (self._clock() + timeout_s if timeout_s is not None
                    else None)
        while self._live():
            if deadline is not None and self._clock() >= deadline:
                # swept EVERY iteration past the deadline, not once: an
                # ejection can re-route work into flight after a sweep
                # (the old gateway's cancel marks die with it), and a
                # one-shot sweep would let that work overrun the timeout
                with self._lock:
                    live = [r for r in self._requests.values()
                            if r.state in LIVE_STATES]
                    for req in live:
                        req.cancel_requested = True
                        if req.replica is not None:
                            self.replicas[req.replica].gateway.cancel(
                                req.sub_rid)
            self.step()
        return self._claim_all()

    def _claim_all(self) -> Dict[int, RequestResult]:
        with self._lock:
            done = [rid for rid, r in self._requests.items()
                    if r.state not in LIVE_STATES]
            out = {}
            for rid in done:
                req = self._requests.pop(rid)
                tokens = (req.tokens if req.tokens is not None
                          else np.zeros(0, np.int32))
                out[rid] = RequestResult(rid, req.state, tokens)
            return out

    # --------------------------------------------------------------- rollout
    def start_rollout(self, engine_factory: Callable[[str], object],
                      version: str,
                      policy: Optional[FleetRolloutPolicy] = None) -> None:
        """Begin replacing every replica not on ``version`` with fresh
        ``engine_factory`` replicas, under continuous traffic. Advances
        one transition per ``step()``; ``rollout_phase`` tracks position
        and ``retired`` records each removed replica (with whether it
        drained cleanly)."""
        with self._lock:
            if self._rollout is not None:
                raise RuntimeError("a rollout is already in progress")
            self._rollout = _Rollout(engine_factory, version,
                                     policy or FleetRolloutPolicy())
            # snapshot the incumbent mesh signature: at completion the
            # winner's signature decides whether this was a RESHARD
            # (mesh-shape flip riding the ordinary rollout machinery)
            self._rollout.from_mesh = self._mesh_signature_locked()
            # the new version starts at weight 0 (no traffic until its
            # first replica is ready and the canary share is granted)
            self.router.set_weights({**self.router.weights, version: 0.0})
            self.rollout_phase = RolloutPhase.SURGING

    def _advance_rollout_locked(self, now: float) -> None:
        ro = self._rollout
        if ro is None:
            return
        fault = chaos.fire(chaos.SITE_FLEET_ROLLOUT,
                           phase=self.rollout_phase.value,
                           steps=self.stats["steps"])
        if isinstance(fault, chaos.RolloutInterrupt):
            # the rollout driver restarted: transient surge state is lost.
            # Not-yet-ready surge replicas never took traffic — discard
            # them; the machine re-derives its position from what exists
            # and converges anyway (level-triggered, like the controller).
            self.stats["rollout_interrupts"] += 1
            if self.metrics is not None:
                self.metrics.inc("rollout_interrupts")
            for rep in list(self.replicas.values()):
                if (rep.version == ro.version
                        and rep.state is ReplicaState.STARTING
                        and rep.routed == 0
                        and not rep.gateway.has_live_requests):
                    # only PRISTINE surge replicas are discardable; one
                    # that served traffic (went READY, then flapped back
                    # to STARTING) may hold live requests — discarding it
                    # would orphan them, so it stays and is re-derived as
                    # existing surge capacity
                    self._retire_replica(
                        rep, state=ReplicaState.STOPPED,
                        reason="rollout interrupt discarded surge",
                        drained_clean=True)
            return
        old = [r for r in self.replicas.values()
               if r.version != ro.version and r.state in ACTIVE_STATES]
        new = [r for r in self.replicas.values()
               if r.version == ro.version and r.state in ACTIVE_STATES]
        if not old:
            # every old replica retired: commit all traffic to the new
            # version and finish
            self.router.set_weights({ro.version: 1.0})
            self.rollout_phase = RolloutPhase.COMPLETE
            # future scale-ups must mint the version that WON, not the
            # one the fleet was constructed with
            self.version = ro.version
            self._factory = ro.factory
            self.stats["rollouts_completed"] += 1
            if self.metrics is not None:
                self.metrics.inc("rollouts_completed")
            if self._mesh_signature_locked() != ro.from_mesh:
                self.stats["reshard_rollouts"] += 1
                if self.shard_metrics is not None:
                    self.shard_metrics.inc("reshard_rollouts")
            self._rollout = None
            return

        # 1. reap / time-out draining old replicas
        for rep in [r for r in old if r.state is ReplicaState.DRAINING]:
            if not rep.gateway.has_live_requests:
                self._retire_replica(
                    rep, state=ReplicaState.STOPPED,
                    reason="rollout drain complete",
                    drained_clean=rep.name not in ro.forced)
                ro.replaced += 1
                continue
            dl = ro.drain_deadlines.get(rep.name)
            if dl is not None and now >= dl:
                # grace spent: cancel stragglers (typed outcome, budget
                # freed) rather than holding the rollout hostage
                ro.forced.add(rep.name)
                for req in list(self._requests.values()):
                    if (req.replica == rep.name
                            and req.state in LIVE_STATES):
                        rep.gateway.cancel(req.sub_rid)
                ro.drain_deadlines[rep.name] = None   # one sweep

        # 2. surge new capacity within the budget
        total_active = len(old) + len(new)
        while (len(new) < self.desired_replicas
               and total_active < self.desired_replicas + ro.policy.max_surge):
            rep = self._add_replica(ro.factory, ro.version)
            new.append(rep)
            total_active += 1

        # 3. shift weight + drain old once new capacity is actually ready
        ready_new = sum(r.routable for r in new)
        ready_total = ready_new + sum(r.routable for r in old)
        if ready_new == 0:
            self.rollout_phase = RolloutPhase.SURGING
            return
        weight = max(ro.policy.canary_weight,
                     min(ro.replaced / self.desired_replicas, 1.0))
        old_versions = sorted({r.version for r in old})
        w = {v: (1.0 - weight) / len(old_versions) for v in old_versions}
        w[ro.version] = weight
        self.router.set_weights(w)
        drained_any = False
        for rep in sorted((r for r in old if r.state is ReplicaState.READY),
                          key=lambda r: r.name):
            if ready_total - 1 < self.desired_replicas:
                break      # zero-downtime floor: never dip below desired
            rep.state = ReplicaState.DRAINING
            rep.gateway.stop_accepting()
            if ro.policy.drain_timeout_s is not None:
                ro.drain_deadlines[rep.name] = (now
                                                + ro.policy.drain_timeout_s)
            ready_total -= 1
            drained_any = True
            break          # one replica per step: observable transitions
        self.rollout_phase = (RolloutPhase.DRAINING
                              if drained_any
                              or any(r.state is ReplicaState.DRAINING
                                     for r in old)
                              else RolloutPhase.SHIFTING)

    # --------------------------------------------------------- observability
    def observation_line(self) -> str:
        """The fleet's load signal in the ElasticAutoscaler observation
        format (`controller/autoscaler.parse_observation`), extended
        with the keys the serving autoscaler's signal layer consumes
        (`tpu_on_k8s_torch/autoscale/signals.sample_from_line`):
        ``[elastic-metrics] epoch=<rollouts> batch=<steps>
        latency=<p95 TTFT s> accuracy=0.0 queue_wait=<p95 s>
        queue_depth=<n> inflight=<tokens> slots=<n> ready=<n>``.

        Percentiles cover only the samples accrued SINCE THE PREVIOUS
        line (the emitter delta-reads through the signal layer's own
        ``FleetScraper``): each line is one window, exactly what
        ``sample_from_line`` documents. Folding the lifetime histograms
        instead would let one historical burst keep the reported p95
        breached long after traffic recovered — pinning a log-scraping
        autoscaler at max replicas forever.

        With no TTFT sample this window, ``latency`` falls back to p95
        queue wait; with no sample of either kind it emits the ``nan``
        sentinel — "no data", which every parser maps to None. The old
        ``latency=0.0`` fallback read as "infinitely fast" to any
        consumer and would have scaled a freshly-started fleet straight
        to min replicas."""
        if self._obs_scraper is None:
            self._obs_scraper = FleetScraper()
        s = self._obs_scraper.scrape(self)
        return format_observation_line(
            s, epoch=self.stats["rollouts_completed"],
            batch=self.stats["steps"])


class _Rollout:
    """In-flight rollout bookkeeping (transient by design: a
    ``RolloutInterrupt`` may discard it and the machine still
    converges)."""

    def __init__(self, factory: Callable[[str], object], version: str,
                 policy: FleetRolloutPolicy) -> None:
        self.factory = factory
        self.version = version
        self.policy = policy
        self.replaced = 0
        self.drain_deadlines: Dict[str, Optional[float]] = {}
        self.forced: set = set()   # replicas whose drain was cut short
        self.from_mesh: Tuple = ()  # incumbent mesh signature at start
