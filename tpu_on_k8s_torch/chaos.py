"""Deterministic, seed-driven fault injection at the engine's sites.

Counterpart of the part of ``tpu_on_k8s/chaos/`` that the serving engine's,
the training loop's and the cluster client's sites need: the ``Fault`` base
with ``HttpError``, ``Conflict``, ``TimeoutFault``, ``ConnectionResetFault``
and ``WatchDrop`` (the REST client's and the apiserver's),
the job engine's ``PodFail`` and ``SlicePreempt``,
``EngineCrash``, ``EngineStall`` and ``DraftCrash``, and ``StepFailure``,
``SaveFailure``, ``PreemptNotice`` and ``ReshardAbort`` with their typed
exceptions, and the
serving plane's ``ReplicaCrash``, ``ReadinessFlap``, ``RolloutInterrupt``,
``HandoffLoss``, ``HandoffCorrupt`` and ``SwapFailure``, and the serving
autoscaler's ``SignalOutage`` and the capacity broker's ``StaleBid``
(``faults.py``), the engine's, the plane's, the autoscaler's, the broker's
and the training loop's sites, the
``FaultInjector`` that evaluates a schedule of ``FaultRule(site, trigger,
fault)`` (``injector.py``) and the control plane's ``watch_outage``,
``apiserver_flaky``, ``slice_preemption`` and ``pod_kill``, and the
``engine_crash_mid_decode``,
``spec_draft_crash``, ``replica_crash_mid_decode``,
``fleet_rollout_chaos``, ``disagg_handoff_chaos``,
``autoscale_under_crash``, ``broker_grant_under_crash``,
``model_swap_failure``,
``train_preemption`` and ``live_reshard_abort`` scenarios
(``scenarios.py``).

Every instrumented call site calls ``fire(site, **ctx)``; with no injector
installed that is one module-global read and a None return. With one
installed, the injector counts the invocation against every rule whose
site and ``match`` filter apply, and returns the first rule's fault whose
trigger elects this invocation. ``at`` / ``every`` triggers depend only on
the per-rule count of matching invocations; ``prob`` triggers draw from a
``random.Random`` seeded by ``(seed, site, rule index)``. The event log
holds a sequence id and the rule's stable description, so two runs of one
seeded schedule log identically. Install is process-global, one injector
at a time, typically ``with FaultInjector(rules, seed=s):``.
"""
from __future__ import annotations

import dataclasses
import random
import threading
from typing import ClassVar, Dict, List, Mapping, Optional, Sequence, Tuple

#: ``RestCluster._request``: ``HttpError``, ``Conflict``, ``TimeoutFault``,
#: ``ConnectionResetFault``
SITE_REST_REQUEST = "rest.request"
#: ``RestCluster._watch_loop`` dialling a stream: ``ConnectionResetFault``,
#: ``HttpError``
SITE_REST_WATCH_CONNECT = "rest.watch.connect"
#: ``RestCluster._watch_loop`` per delivered frame: ``WatchDrop``
SITE_REST_WATCH_EVENT = "rest.watch.event"
#: the apiserver's handler before every verb: ``HttpError``, ``Conflict``,
#: ``ConnectionResetFault``, ``TimeoutFault``
SITE_APISERVER_REQUEST = "apiserver.request"
#: the apiserver's watch stream per delivered frame: ``WatchDrop``
SITE_APISERVER_WATCH = "apiserver.watch"
#: ``JobEngine.reconcile``, before the pass lists its pods: ``PodFail``,
#: ``SlicePreempt`` (recovered by the failover policy: slice-atomic
#: restart / recreate)
SITE_RECONCILE = "controller.reconcile"
#: ``ContinuousBatchingEngine.step``: ``EngineCrash``, ``EngineStall``
SITE_SERVE_STEP = "serve.engine.step"
#: the engine's speculative round: ``DraftCrash``
SITE_SPEC_DRAFT = "serve.engine.spec_draft"
#: ``ServingFleet.step`` per replica: ``ReplicaCrash``, ``ReadinessFlap``
SITE_FLEET_REPLICA = "serve.fleet.replica"
#: the fleet's rollout driver: ``RolloutInterrupt``
SITE_FLEET_ROLLOUT = "serve.fleet.rollout"
#: a disaggregated fleet's prefill-to-decode handoff: ``HandoffLoss``,
#: ``HandoffCorrupt``
SITE_KV_HANDOFF = "serve.kv.handoff"
#: ``ModelPool``'s params swap: ``SwapFailure``
SITE_MODEL_SWAP = "serve.model.swap"
#: ``TrainLoop`` before a step dispatches: ``StepFailure``
SITE_TRAIN_STEP = "train.step"
#: ``TrainLoop`` enqueueing a checkpoint save: ``SaveFailure``
SITE_TRAIN_SAVE = "train.save"
#: ``TrainLoop`` before each step, a preemption source: ``PreemptNotice``
SITE_TRAIN_PREEMPT = "train.preempt"
#: ``parallel/reshard.py``'s plan execution, before any leaf moves:
#: ``ReshardAbort``
SITE_RESHARD = "train.reshard"
#: ``FleetAutoscaler``'s signal scrape: ``SignalOutage`` (recovered by the
#: signal layer's staleness: a dead scrape holds last-known-good)
SITE_AUTOSCALE_SIGNAL = "autoscale.signal"
#: ``FleetAutoscaler``'s ``spec.replicas`` patch: ``Conflict``,
#: ``HttpError``, ``TimeoutFault`` (a failed patch burns no cooldown)
SITE_AUTOSCALE_PATCH = "autoscale.patch"
#: ``CapacityBroker``'s lane commit (a grant, harvest, fill or degrade
#: applied): ``StaleBid``, ``Conflict`` (recovered by re-clearing next
#: tick: no partial apply, no cooldown burned)
SITE_BROKER_GRANT = "broker.grant"


class ChaosStepError(RuntimeError):
    """An injected training-step failure (``StepFailure``)."""


class ChaosReshardError(RuntimeError):
    """An injected live-reshard abort (``ReshardAbort``)."""


class StaleBidError(RuntimeError):
    """An injected stale-bid rejection (``StaleBid``): a consumer's bid no
    longer matches its live state when the broker applies the grant."""


class ChaosSaveError(OSError):
    """An injected checkpoint-save failure (``SaveFailure``): an OSError,
    as a full disk or revoked credentials raise."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """Base class; ``kind`` is the stable name used in event logs."""

    kind: ClassVar[str] = "fault"

    def to_exception(self) -> Exception:
        raise NotImplementedError(f"{self.kind} is interpreted by its call "
                                  f"site, not raised")


@dataclasses.dataclass(frozen=True)
class HttpError(Fault):
    """A server-side 5xx. Client sites raise the generic ``ApiError`` the
    real client maps unrecognized statuses to; the apiserver site answers
    with this code and a Status body."""

    code: int = 503
    kind: ClassVar[str] = "http_error"

    def to_exception(self) -> Exception:
        from tpu_on_k8s_torch.client.cluster import ApiError
        return ApiError(f"HTTP {self.code}: chaos injected server error")


@dataclasses.dataclass(frozen=True)
class Conflict(Fault):
    """An optimistic-concurrency 409: what a losing read-modify-write
    write sees under contention."""

    kind: ClassVar[str] = "conflict"

    def to_exception(self) -> Exception:
        from tpu_on_k8s_torch.client.cluster import ConflictError
        return ConflictError("chaos injected write conflict")


@dataclasses.dataclass(frozen=True)
class TimeoutFault(Fault):
    """A request that never completes within the socket timeout.
    ``TimeoutError`` is an ``OSError``, so client sites exercise the real
    stale-connection retry path."""

    kind: ClassVar[str] = "timeout"

    def to_exception(self) -> Exception:
        return TimeoutError("chaos injected request timeout")


@dataclasses.dataclass(frozen=True)
class ConnectionResetFault(Fault):
    """Peer reset mid-request (load-balancer restart, apiserver roll)."""

    kind: ClassVar[str] = "connection_reset"

    def to_exception(self) -> Exception:
        return ConnectionResetError("chaos injected connection reset")


@dataclasses.dataclass(frozen=True)
class WatchDrop(Fault):
    """Close the watch stream: the client must reconnect from its last
    observed revision (or re-list on 410) without going deaf."""

    kind: ClassVar[str] = "watch_drop"

    def to_exception(self) -> Exception:
        return ConnectionResetError("chaos injected watch-stream drop")


@dataclasses.dataclass(frozen=True)
class PodFail(Fault):
    """Kill one pod of the reconciled job the way a kubelet reports it:
    phase Failed, the given container exit code and kill reason. With
    ``reason="Evicted"`` this is a node-pressure eviction / single-host
    preemption (retryable per `controller/failover.py`)."""

    task_type: str = "worker"
    index: int = 0
    exit_code: int = 137
    reason: str = "Killed"
    kind: ClassVar[str] = "pod_fail"


@dataclasses.dataclass(frozen=True)
class SlicePreempt(Fault):
    """Preempt a whole GPU slice: every worker pod whose task index falls
    in slice ``slice_index`` (hosts-per-slice, 8 GPUs a host, comes from
    the job's gpu_policy through ``gang/topology.py``) goes Failed/Evicted
    at once — how a real slice preemption lands (the slice is one failure
    domain, SURVEY §5.3)."""

    slice_index: int = 0
    exit_code: int = 137
    reason: str = "Evicted"
    kind: ClassVar[str] = "slice_preempt"


@dataclasses.dataclass(frozen=True)
class EngineCrash(Fault):
    """The serving engine dies mid-decode (``EngineCrashError`` from
    ``step()``): every slot's request state is lost. Re-admission by the
    requests' owner is the recovery under test."""

    kind: ClassVar[str] = "engine_crash"


@dataclasses.dataclass(frozen=True)
class EngineStall(Fault):
    """The engine's device step wedges: ``step()`` makes no progress (no
    admission, no tokens, no retirement) but does not raise. The caller's
    timeouts are the recovery under test."""

    kind: ClassVar[str] = "engine_stall"


@dataclasses.dataclass(frozen=True)
class DraftCrash(Fault):
    """The draft model of a speculative engine dies. The draft only speeds
    decoding up, so the recovery under test is degradation: the engine drops
    the draft and finishes every in-flight request on the plain step,
    token for token (greedy), with the crash counted
    (``stats["draft_crashes"]``, ``SpecMetrics.spec_draft_crashes``)."""

    kind: ClassVar[str] = "draft_crash"


@dataclasses.dataclass(frozen=True)
class ReplicaCrash(Fault):
    """A whole serving replica dies (pod kill, VM preemption): harder than
    ``EngineCrash``, which the replica's own gateway replays in place. The
    fleet must eject the replica and re-route every one of its live
    requests through a survivor under the ``ReplayPolicy`` budget. Matched
    by ``replica`` in the site ctx to target one replica."""

    kind: ClassVar[str] = "replica_crash"


@dataclasses.dataclass(frozen=True)
class ReadinessFlap(Fault):
    """The replica's readiness probe fails for ``steps`` fleet steps: the
    router must stop sending it new traffic (in-flight work keeps
    decoding) and resume only after the replica re-earns its slow-start
    streak."""

    steps: int = 2
    kind: ClassVar[str] = "readiness_flap"


@dataclasses.dataclass(frozen=True)
class RolloutInterrupt(Fault):
    """The rollout driver is interrupted mid-transition (controller
    restart, lost leadership): transient surge state is discarded and the
    state machine must re-derive its position and still converge, with
    every in-flight request reaching a typed terminal state."""

    kind: ClassVar[str] = "rollout_interrupt"


@dataclasses.dataclass(frozen=True)
class HandoffLoss(Fault):
    """A prefill-to-decode KV handoff vanishes in transfer: the payload
    never reaches the handoff queue. The disaggregated fleet re-runs the
    prefill under the request's ``ReplayPolicy`` budget."""

    kind: ClassVar[str] = "handoff_loss"


@dataclasses.dataclass(frozen=True)
class HandoffCorrupt(Fault):
    """A KV handoff arrives with flipped bytes. The adopting replica must
    reject it (``KVHandoff.verify()``) and route the request back through
    the re-prefill replay path instead of decoding from a poisoned
    cache."""

    kind: ClassVar[str] = "handoff_corrupt"


@dataclasses.dataclass(frozen=True)
class SwapFailure(Fault):
    """A model hot-swap dies mid-replace (a torn checkpoint read, an OOM
    while staging the incoming tree). It fires before the engine's params
    pointer moves: the previous model's params stay live and keep serving,
    the failure is counted and the swap retried on the scheduler's next
    pass, and every request queued for the incoming model still reaches a
    typed terminal state."""

    kind: ClassVar[str] = "swap_failure"


@dataclasses.dataclass(frozen=True)
class SignalOutage(Fault):
    """The autoscaler's fleet scrape fails (dead metrics endpoint, log
    tail outage): the tick records a dead sample. The recovery under
    test is the signal layer's staleness contract — "no data" must hold
    last-known-good, never read as "zero load, scale to min"."""

    kind: ClassVar[str] = "signal_outage"


@dataclasses.dataclass(frozen=True)
class StepFailure(Fault):
    """A training step raises (bad batch, NaN guard, device error)."""

    kind: ClassVar[str] = "step_failure"

    def to_exception(self) -> Exception:
        return ChaosStepError("chaos injected training-step failure")


@dataclasses.dataclass(frozen=True)
class SaveFailure(Fault):
    """A checkpoint save fails (full disk, revoked credentials). The loop
    must survive it: training continues, and resume falls back to the last
    good checkpoint."""

    kind: ClassVar[str] = "save_failure"

    def to_exception(self) -> Exception:
        return ChaosSaveError("chaos injected checkpoint-save failure")


@dataclasses.dataclass(frozen=True)
class StaleBid(Fault):
    """A consumer's bid went stale between clearing and apply (the consumer
    scaled itself, died, or re-bid concurrently). The broker must reject
    the WHOLE grant — no partial apply — ledger the conflict, and re-clear
    from fresh bids next tick; the refused requester burns no cooldown."""

    kind: ClassVar[str] = "stale_bid"

    def to_exception(self) -> Exception:
        return StaleBidError("chaos injected stale bid")


@dataclasses.dataclass(frozen=True)
class PreemptNotice(Fault):
    """A SIGTERM-style preemption notice: the train loop must save its
    exact stopping point, drain, and stop cleanly."""

    kind: ClassVar[str] = "preempt_notice"


@dataclasses.dataclass(frozen=True)
class ReshardAbort(Fault):
    """A live mesh reshard dies mid-transform (a rank lost, an out-of-memory
    in the transfer, a wedged collective). Fired before the first leaf
    moves, so the source state is intact: the train loop counts the
    fallback and leaves through the preemption path, and the
    checkpoint-restart rescale takes over."""

    kind: ClassVar[str] = "reshard_abort"

    def to_exception(self) -> Exception:
        return ChaosReshardError("chaos injected live-reshard abort")


def describe(fault: Fault, note: Optional[str] = None) -> str:
    """Stable one-line event-log form: the fault kind, its non-default
    fields and the rule's note; no call-site context, which varies with
    thread timing."""
    fields = []
    for f in dataclasses.fields(fault):
        v = getattr(fault, f.name)
        if v != f.default:
            fields.append(f"{f.name}={v}")
    body = f"{fault.kind}" + (f"({', '.join(fields)})" if fields else "")
    return f"{body} note={note}" if note else body


@dataclasses.dataclass(frozen=True)
class Trigger:
    """When a rule fires, in terms of its own matching-invocation count
    (1-based). Exactly one of ``at`` / ``every`` / ``prob`` should be set:

    * ``at``    — fire on these invocation indices (``(1,)``: the first).
    * ``every`` — fire on every nth invocation.
    * ``prob``  — fire with this probability per invocation (seeded rng).
    * ``limit`` — cap total fires (``at`` implies ``len(at)``).
    * ``match`` — ctx filter: every key must be present in the call's ctx
      and equal after ``str()``, except that a string value matches as a
      boundary-anchored substring of a string ctx value.
    """

    at: Tuple[int, ...] = ()
    every: Optional[int] = None
    prob: Optional[float] = None
    limit: Optional[int] = None
    match: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.every is not None and self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if self.prob is not None and not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if not self.at and self.every is None and self.prob is None:
            raise ValueError("trigger needs at=, every=, or prob=")

    def max_fires(self) -> Optional[int]:
        if self.limit is not None:
            return self.limit
        if self.at and self.every is None and self.prob is None:
            return len(self.at)
        return None


def on_call(*indices: int) -> Trigger:
    """Fire on exactly these 1-based matching invocations."""
    return Trigger(at=tuple(indices))


def every(n: int, limit: Optional[int] = None) -> Trigger:
    return Trigger(every=n, limit=limit)


def with_prob(p: float, limit: Optional[int] = None) -> Trigger:
    return Trigger(prob=p, limit=limit)


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One line of a fault schedule. ``note`` is a label carried into the
    event log (stable across runs: no timestamps)."""

    site: str
    trigger: Trigger
    fault: Fault
    note: str = ""


class _RuleState:
    __slots__ = ("seen", "fired")

    def __init__(self) -> None:
        self.seen = 0
        self.fired = 0


def _substr_on_boundaries(want: str, have: str) -> bool:
    """``want`` occurs in ``have`` with non-alphanumeric (or string-edge)
    characters on both sides, so a rule for ``replica-1`` does not also hit
    ``replica-10`` while ``/pods`` still matches inside a longer path."""
    if not want:
        return True
    start = have.find(want)
    while start != -1:
        end = start + len(want)
        # an edge is a boundary when the adjacent outside char or the
        # pattern's own edge char is non-alphanumeric
        pre = (start == 0 or not have[start - 1].isalnum()
               or not want[0].isalnum())
        post = (end == len(have) or not have[end].isalnum()
                or not want[-1].isalnum())
        if pre and post:
            return True
        start = have.find(want, start + 1)
    return False


def _ctx_matches(match: Mapping[str, object],
                 ctx: Mapping[str, object]) -> bool:
    for key, want in match.items():
        if key not in ctx:
            return False
        have = ctx[key]
        if isinstance(want, str) and isinstance(have, str):
            if not _substr_on_boundaries(want, have):
                return False
        elif str(want) != str(have):
            return False
    return True


class FaultInjector:
    """Evaluate a fault schedule; as a context manager it installs itself
    process-globally (one at a time)."""

    def __init__(self, rules: Sequence[FaultRule], *, seed: int = 0,
                 name: str = "") -> None:
        self.rules: List[FaultRule] = list(rules)
        self.seed = seed
        self.name = name
        self.events: List[str] = []
        self._lock = threading.Lock()
        self._state: List[_RuleState] = [_RuleState() for _ in self.rules]
        # one rng per rule, seeded by (seed, site, index): adding a rule
        # never perturbs another rule's draws
        self._rngs: Dict[int, random.Random] = {
            i: random.Random(f"{seed}:{r.site}:{i}")
            for i, r in enumerate(self.rules) if r.trigger.prob is not None}

    def fire(self, site: str, **ctx) -> Optional[Fault]:
        """Count this invocation against every matching rule; return the
        first rule's fault elected to fire (or None)."""
        return self.fire_seq(site, **ctx)[0]

    def fire_seq(self, site: str, **ctx) -> Tuple[Optional[Fault], int]:
        """Like ``fire``, and also this invocation's event sequence id (0
        when nothing fired), allocated under the injector lock."""
        hit: Optional[FaultRule] = None
        seq = 0
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.site != site:
                    continue
                if rule.trigger.match and not _ctx_matches(rule.trigger.match,
                                                           ctx):
                    continue
                st = self._state[i]
                st.seen += 1
                if hit is not None:
                    continue  # keep counting later rules; one fault a call
                cap = rule.trigger.max_fires()
                if cap is not None and st.fired >= cap:
                    continue
                if self._elects(rule.trigger, st.seen, self._rngs.get(i)):
                    st.fired += 1
                    hit = rule
                    seq = len(self.events) + 1
                    self.events.append(
                        f"seq={seq} "
                        + describe(rule.fault, rule.note or None))
        return (hit.fault if hit is not None else None, seq)

    @staticmethod
    def _elects(trigger: Trigger, seen: int,
                rng: Optional[random.Random]) -> bool:
        if trigger.at and seen in trigger.at:
            return True
        if trigger.every is not None and seen % trigger.every == 0:
            return True
        if trigger.prob is not None and rng is not None:
            return rng.random() < trigger.prob
        return False

    def counts(self) -> Dict[str, Tuple[int, int]]:
        """{``site#index``: (seen, fired)}."""
        with self._lock:
            return {f"{r.site}#{i}": (s.seen, s.fired)
                    for i, (r, s) in enumerate(zip(self.rules, self._state))}

    def fired_total(self) -> int:
        with self._lock:
            return sum(s.fired for s in self._state)

    def __enter__(self) -> "FaultInjector":
        install(self)
        return self

    def __exit__(self, *exc) -> None:
        uninstall(self)


_active: Optional[FaultInjector] = None
_install_lock = threading.Lock()


def install(injector: FaultInjector) -> FaultInjector:
    """Make ``injector`` the process-global injector. Refuses to stack: a
    forgotten uninstall must fail loudly, not merge schedules."""
    global _active
    with _install_lock:
        if _active is not None and _active is not injector:
            raise RuntimeError(
                f"a FaultInjector ({_active.name or 'unnamed'}) is already "
                f"installed; uninstall it first")
        _active = injector
    return injector


def uninstall(injector: Optional[FaultInjector] = None) -> None:
    """Remove the global injector (a given one, or whatever is installed).
    Idempotent."""
    global _active
    with _install_lock:
        if injector is None or _active is injector:
            _active = None


def active() -> Optional[FaultInjector]:
    return _active


def fire(site: str, **ctx) -> Optional[Fault]:
    """The call-site entry point: free when nothing is installed."""
    inj = _active
    if inj is None:
        return None
    return inj.fire(site, **ctx)


def fire_seq(site: str, **ctx) -> Tuple[Optional[Fault], int]:
    """``fire`` plus this invocation's event sequence id (0 = no fault)."""
    inj = _active
    if inj is None:
        return None, 0
    return inj.fire_seq(site, **ctx)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, seeded fault schedule; ``injector()`` mints a fresh
    ``FaultInjector`` (rule counters zeroed), so a scenario runs any number
    of times."""

    name: str
    rules: Tuple[FaultRule, ...]
    seed: int = 0

    def injector(self) -> FaultInjector:
        return FaultInjector(self.rules, seed=self.seed, name=self.name)


def watch_outage(kind: str = "Pod", *, reconnect_failures: int = 2,
                 seed: int = 0) -> Scenario:
    """Drop ``kind``'s live watch stream on the first frame delivered
    after install, then fail the next ``reconnect_failures`` dials — an
    API-server blip plus a slow comeback. Dial counting starts at
    injector install (the stream is usually already established when
    chaos arrives), so dial #1 is the reconnect the drop provokes.
    Recovery under test: the informer resumes from its last revision with
    decorrelated-jitter backoff and no controller goes deaf."""
    rules = [FaultRule(SITE_REST_WATCH_EVENT,
                       Trigger(at=(1,), match={"kind": kind}),
                       WatchDrop(), note=f"drop {kind} stream")]
    if reconnect_failures:
        fail_at = tuple(range(1, 1 + reconnect_failures))
        rules.append(FaultRule(SITE_REST_WATCH_CONNECT,
                               Trigger(at=fail_at, match={"kind": kind}),
                               ConnectionResetFault(),
                               note=f"refuse {kind} reconnect"))
    return Scenario("watch-outage", tuple(rules), seed)


def apiserver_flaky(every_n: int = 7, *, limit: int = 4,
                    seed: int = 0) -> Scenario:
    """Every nth API request answers 503 — sustained flakiness the
    clients' retries and the controllers' requeues must absorb."""
    return Scenario("apiserver-flaky", (
        FaultRule(SITE_APISERVER_REQUEST,
                  Trigger(every=every_n, limit=limit),
                  HttpError(503), note="flaky apiserver"),
    ), seed)


def slice_preemption(job: str, *, slice_index: int = 0,
                     seed: int = 0) -> Scenario:
    """Evict a whole slice of ``job`` (namespace/name) on the next
    reconcile pass. Recovery under test: exit-code-classified failover
    brings the slice's task group back to Running as one unit."""
    return Scenario("slice-preemption", (
        FaultRule(SITE_RECONCILE,
                  Trigger(at=(1,), match={"job": job}),
                  SlicePreempt(slice_index=slice_index),
                  note=f"preempt slice {slice_index} of {job}"),
    ), seed)


def pod_kill(job: str, *, task_type: str = "worker", index: int = 0,
             exit_code: int = 137, reason: str = "OOMKilled",
             seed: int = 0) -> Scenario:
    """Kill one pod of ``job`` with a classified exit code on the next
    reconcile pass."""
    return Scenario("pod-kill", (
        FaultRule(SITE_RECONCILE,
                  Trigger(at=(1,), match={"job": job}),
                  PodFail(task_type=task_type, index=index,
                                 exit_code=exit_code, reason=reason),
                  note=f"kill {task_type}-{index} of {job}"),
    ), seed)


def engine_crash_mid_decode(at_steps: Tuple[int, ...] = (3,), *,
                            seed: int = 0) -> Scenario:
    """Crash the serving engine on these ``engine.step()`` calls (counted
    per call)."""
    return Scenario("engine-crash", (
        FaultRule(SITE_SERVE_STEP, on_call(*at_steps), EngineCrash(),
                  note="crash mid-decode"),
    ), seed)


def spec_draft_crash(at_round: int = 2, *, seed: int = 0) -> Scenario:
    """Kill the speculative draft on its ``at_round``-th round (counted per
    speculative round of ``engine.step()``)."""
    return Scenario("spec-draft-crash", (
        FaultRule(SITE_SPEC_DRAFT, on_call(at_round), DraftCrash(),
                  note="draft dies mid-speculation"),
    ), seed)


def replica_crash_mid_decode(replica: str = "replica-1", *,
                             at_steps: Tuple[int, ...] = (3,),
                             seed: int = 0) -> Scenario:
    """Kill one serving-fleet replica on these fleet steps (counted per
    replica per ``fleet.step()``). The fleet ejects it and re-routes every
    live request through a survivor under the ``ReplayPolicy`` budget."""
    return Scenario("replica-crash", (
        FaultRule(SITE_FLEET_REPLICA,
                  Trigger(at=at_steps, match={"replica": replica}),
                  ReplicaCrash(), note=f"crash {replica} mid-decode"),
    ), seed)


def fleet_rollout_chaos(*, flap_replica: str = "replica-0",
                        flap_at: int = 2, flap_steps: int = 3,
                        interrupt_at: Tuple[int, ...] = (4,),
                        seed: int = 0) -> Scenario:
    """A rollout under weather: one replica's readiness flaps and the
    rollout driver is interrupted mid-transition. The rollout must still
    complete with every request terminal."""
    return Scenario("fleet-rollout-chaos", (
        FaultRule(SITE_FLEET_REPLICA,
                  Trigger(at=(flap_at,), match={"replica": flap_replica}),
                  ReadinessFlap(steps=flap_steps),
                  note=f"flap {flap_replica} readiness"),
        FaultRule(SITE_FLEET_ROLLOUT, Trigger(at=interrupt_at),
                  RolloutInterrupt(), note="interrupt the rollout driver"),
    ), seed)


def disagg_handoff_chaos(*, lose_at: Tuple[int, ...] = (2,),
                         corrupt_at: Tuple[int, ...] = (4,),
                         seed: int = 0) -> Scenario:
    """The prefill-to-decode handoff link under weather: the
    ``lose_at``-th handoffs vanish and the ``corrupt_at``-th arrive with
    flipped bytes (counted per handoff enqueue across the fleet). A lost
    handoff re-runs its prefill; a corrupted one fails the adopting
    replica's checksum and is replayed the same way."""
    rules = []
    if lose_at:
        rules.append(FaultRule(SITE_KV_HANDOFF, Trigger(at=lose_at),
                               HandoffLoss(),
                               note="lose the KV handoff in transfer"))
    if corrupt_at:
        rules.append(FaultRule(SITE_KV_HANDOFF, Trigger(at=corrupt_at),
                               HandoffCorrupt(),
                               note="corrupt the KV handoff payload"))
    return Scenario("disagg-handoff-chaos", tuple(rules), seed)


def model_swap_failure(*, at_swap: int = 2, model: str = "",
                       seed: int = 0) -> Scenario:
    """Fail the ``at_swap``-th model hot-swap mid-replace (counted per
    ``ModelPool`` activation; ``model`` narrows it to one model's
    swap-ins). The previous model keeps serving, the failure is ledgered
    with its ``chaos#N`` trigger ref and the swap retries."""
    match = {"model": model} if model else {}
    return Scenario("model-swap-failure", (
        FaultRule(SITE_MODEL_SWAP, Trigger(at=(at_swap,), match=match),
                  SwapFailure(),
                  note=(f"fail swap #{at_swap}"
                        + (f" into {model}" if model else ""))),
    ), seed)


def autoscale_under_crash(replica: str = "replica-1", *,
                          crash_at: int = 3,
                          outage_at: Tuple[int, ...] = (2, 3),
                          conflict_at: Tuple[int, ...] = (),
                          seed: int = 0) -> Scenario:
    """A burst is in flight, the autoscaler is mid-reaction — and then a
    serving replica dies (fleet step ``crash_at`` of that replica), the
    signal scrape blacks out for the ticks in ``outage_at``, and
    (optionally) the ``spec.replicas`` patch hits write conflicts.
    Recovery under test: the crashed replica's requests re-route with
    zero silent loss, the stale window HOLDS last-known-good instead of
    scaling to min, a failed patch burns no cooldown, and the loop still
    converges to the SLO-satisfying replica count without oscillating
    (no up→down→up thrash) — the acceptance scenario for
    `controller/fleetautoscaler.py`."""
    rules = [
        FaultRule(SITE_FLEET_REPLICA,
                  Trigger(at=(crash_at,), match={"replica": replica}),
                  ReplicaCrash(),
                  note=f"crash {replica} mid-burst"),
    ]
    if outage_at:
        rules.append(FaultRule(SITE_AUTOSCALE_SIGNAL,
                               Trigger(at=outage_at),
                               SignalOutage(),
                               note="black out the fleet scrape"))
    if conflict_at:
        rules.append(FaultRule(SITE_AUTOSCALE_PATCH,
                               Trigger(at=conflict_at),
                               Conflict(),
                               note="conflict the replicas patch"))
    return Scenario("autoscale-under-crash", tuple(rules), seed)


def broker_grant_under_crash(replica: str = "replica-1", *,
                             grant_at: Tuple[int, ...] = (1,),
                             crash_at: int = 3, consumer: str = "",
                             seed: int = 0) -> Scenario:
    """The market under compound weather: the ``grant_at``-th broker
    grant applies against a stale bid (``consumer`` narrows it to one
    lane) WHILE a serving replica dies mid-burst (fleet step
    ``crash_at`` of ``replica``). Recovery under test: the faulted
    grant rejects the WHOLE lane transition — no partial apply, the
    conflict is ledgered, the refused lane burns no cooldown and the
    market re-clears from fresh bids next tick — while the crashed
    replica's requests re-route under the replay budget with zero
    silent loss; neither failure is allowed to mask the other."""
    match = {"consumer": consumer} if consumer else {}
    return Scenario("broker-grant-under-crash", (
        FaultRule(SITE_BROKER_GRANT,
                  Trigger(at=grant_at, match=match),
                  StaleBid(),
                  note=("stale-bid the grant apply"
                        + (f" of {consumer}" if consumer else ""))),
        FaultRule(SITE_FLEET_REPLICA,
                  Trigger(at=(crash_at,), match={"replica": replica}),
                  ReplicaCrash(),
                  note=f"crash {replica} mid-burst"),
    ), seed)


def train_preemption(at_step: int, *, fail_save: bool = False,
                     seed: int = 0) -> Scenario:
    """Deliver a SIGTERM-style preemption notice before training step
    ``at_step`` dispatches; with ``fail_save`` the preemption-time save
    also fails, forcing resume to fall back to the last periodic
    checkpoint. Recovery under test: generation-versioned resume
    reproduces the no-fault loss trajectory bit for bit."""
    rules = [FaultRule(SITE_TRAIN_PREEMPT, on_call(at_step), PreemptNotice(),
                       note=f"preempt before step {at_step}")]
    if fail_save:
        # the preemption-time save carries the stopping step (at_step - 1)
        # in its ctx: match it, so periodic saves land and only the final
        # one fails
        rules.append(FaultRule(SITE_TRAIN_SAVE,
                               Trigger(every=1, limit=1,
                                       match={"step": at_step - 1}),
                               SaveFailure(),
                               note="fail the preemption save"))
    return Scenario("train-preemption", tuple(rules), seed)


def live_reshard_abort(at_transform: int = 1, *, seed: int = 0) -> Scenario:
    """Abort the ``at_transform``-th live mesh reshard (counted per plan
    execution, ``parallel/reshard.py``) before any leaf moves. Recovery
    under test: the train loop counts the fallback, leaves through the
    preemption path (a final save of the intact state, then the drain),
    and a checkpoint restart reproduces the fault-free trajectory bit for
    bit."""
    return Scenario("live-reshard-abort", (
        FaultRule(SITE_RESHARD, on_call(at_transform), ReshardAbort(),
                  note=f"abort live reshard #{at_transform}"),
    ), seed)
