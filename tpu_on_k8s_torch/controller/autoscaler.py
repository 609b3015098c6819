"""Native elastic autoscaler: throughput-driven, slice-legal replica scaling
(the counterpart of ``tpu_on_k8s/controller/autoscaler.py``).

Analog of controllers/train/torchelastic/ (SURVEY §2.5) — the
second control loop over the same job CRD that *decides* replica counts from
observed training throughput, while the main reconciler + ElasticController
execute the resulting spec changes:

* per registered job, every ``period`` (reference: 30s,
  elastictorchjob_controller.go:60): read training metrics from worker-0's log
  stream (pods/log subresource — observation.go:40-106), parse
  ``key=value`` lines into ``MetricObservation``;
* after ``metric_count`` (5) observations at the current replica count,
  decide via the latency-per-replica test ``IsSatisfyElasticContinue``
  (job.go:94-100): if throughput still scales, grow; else revert to the last
  count and freeze (ReachMaxMetric);
* slices (SURVEY §7): growth steps to the **next legal slice host count**
  (``topology.next_legal_host_count``), not the reference's free-form
  ``replicas *= 2`` (job.go:102-104) — on 8-GPU hosts those coincide
  (1, 2, 4, 8, … hosts), and a multi-slice job adds a whole slice;
* pending pods at a grown size revert to the last-known-good count
  (elastic_scale.go:107-122) — capacity isn't there;
* the unfinished ``GetPodsForJob -> panic("Implement me")`` seam of the
  reference (torchelastic/pod.go:25-27) simply doesn't exist here: scaling
  goes through the job spec and the engine owns pods.

Observation line format (what the port's trainers print a step,
``train_llama.py`` and the rest):
``[elastic-metrics] epoch=3 batch=120 latency=0.245 accuracy=0.81``.
"""
from __future__ import annotations

import math
import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Pod, PodPhase
from tpu_on_k8s_torch.api.types import ElasticStatus, TaskType, TorchJob
from tpu_on_k8s_torch.autoscale.policy import (
    ACTION_DOWN,
    ACTION_HOLD,
    ACTION_UP,
    Decision,
)
from tpu_on_k8s_torch.autoscale.signals import KV_RE, METRICS_TAG
from tpu_on_k8s_torch.client.cluster import InMemoryCluster, NotFoundError
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.elastic import apply_host_count
from tpu_on_k8s_torch.controller.loopkernel import (
    LoopKernel,
    OpenHorizon,
    format_commit_failure_line,
    format_decision_line,
)
from tpu_on_k8s_torch.gang import topology
from tpu_on_k8s_torch.metrics import JobMetrics
from tpu_on_k8s_torch.obs.ledger import (
    COMMIT_LANDED,
    COMMIT_NONE,
    HORIZON_REPLICAS_READY,
)
from tpu_on_k8s_torch.utils import conditions
from tpu_on_k8s_torch.utils.logging import get_logger

_log = get_logger("autoscaler")

# The observation-line vocabulary lives in `autoscale/signals.py` (one
# home, stdlib-only). Values are captured loosely (any non-space run)
# and validated by float() below: the old numeric-class pattern silently
# extracted digit fragments out of malformed values ("latency=x1.5"
# parsed as 1.5) instead of rejecting the line.
_KV_RE = KV_RE


@dataclass
class MetricObservation:
    """One parsed training-metrics line (reference MetricObservation,
    elastictorchjob_controller.go:99-105)."""

    epoch: int = 0
    batch: int = 0
    latency: float = 0.0
    accuracy: float = 0.0


def parse_observation(line: str) -> Optional[MetricObservation]:
    """Parse a ``[elastic-metrics] key=value ...`` line; None if not one.

    Rejected outright (None, never a zeroed observation): a missing or
    malformed ``latency``, a negative latency, and the non-finite
    ``nan``/``inf`` sentinels — ``latency=nan`` is how an emitter with
    no samples yet says "no data" (`serve/fleet.observation_line`), and
    folding it in as a number would read as infinitely fast and scale
    the consumer straight to min. Duplicate keys keep the LAST value
    (the rightmost write wins, like repeated flag parsing)."""
    if METRICS_TAG not in line:
        return None
    fields = {k: v for k, v in _KV_RE.findall(line)}
    if "latency" not in fields:
        return None
    try:
        latency = float(fields["latency"])
        obs = MetricObservation(
            epoch=int(float(fields.get("epoch", 0))),
            batch=int(float(fields.get("batch", 0))),
            latency=latency,
            accuracy=float(fields.get("accuracy", 0.0)),
        )
    except (ValueError, OverflowError):
        # OverflowError: int(float("9e999")) — an absurd epoch/batch is
        # as malformed as a non-numeric one
        return None
    if not math.isfinite(latency) or latency < 0.0:
        return None
    return obs


def is_satisfy_elastic_continue(last_replicas: int, last_latency: float,
                                cur_replicas: int, cur_latency: float) -> bool:
    """The throughput test (reference torchelastic job.go:94-100): keep
    growing while latency-per-replica improves. Both denominators are
    guarded: a zero-replica current world has no throughput to compare
    (the reference would divide by zero here) — never "keep growing"."""
    if last_replicas <= 0:
        return True
    if cur_replicas <= 0:
        return False
    return last_latency / last_replicas > cur_latency / cur_replicas


@dataclass(frozen=True)
class _ElasticPack:
    """One elastic tick's evidence, frozen at observe time (decide
    mutates the job's ElasticStatus, so the ledger's signal snapshot
    must be captured before it does)."""

    job: TorchJob
    status: ElasticStatus
    cur: int
    last_replicas: int
    last_latency: float
    #: pending-pods revert: the grown size is not materializing and the
    #: grace ran out — revert to this count (None = normal metric tick)
    revert_to: Optional[int] = None
    #: mean latency of the decision window (None on a revert tick)
    cur_latency: Optional[float] = None


class _JobState(LoopKernel):
    """One elastic job's decision loop on the shared observe→decide→
    commit kernel (`controller/loopkernel.py`): observe tails worker-0's
    log into watermarked per-replica buckets, decide runs the
    latency-per-replica continue test, commit executes the rescale (or
    freeze) through the cluster client — and every decision lands one
    ledger record, uniformly with the serving loops."""

    #: the owning controller (set before run_tick): the hooks reach
    #: the cluster client through it
    owner: Optional["ElasticAutoscaler"] = None

    def bind_owner(self, owner: "ElasticAutoscaler") -> None:
        self.owner = owner

    def __init__(self, observations: Optional[Dict[int, List[
            MetricObservation]]] = None, frozen: bool = False,
            watermark: Optional[tuple] = None,
            pending_ticks: int = 0) -> None:
        super().__init__()
        self.observations: Dict[int, List[MetricObservation]] = (
            observations if observations is not None else {})
        #: ReachMaxMetric / ReachMaxReplicas: stop deciding
        self.frozen = frozen
        # Only metric lines strictly newer than this (epoch, batch)
        # watermark count toward the current replica bucket — worker-0's
        # log tail still holds pre-scale lines right after a rescale,
        # and deciding on those would race the scaler to max_replicas on
        # zero post-scale evidence.
        self.watermark = watermark
        #: consecutive ticks with Pending workers at grown size
        self.pending_ticks = pending_ticks

    # ------------------------------------------------------------ kernel hooks
    def observe(self, ctx) -> Optional[_ElasticPack]:
        """Everything short of a decision: hold while a scale transaction
        is in flight, while stale-generation pods linger, while the
        world assembles, while frozen, and until the decision window is
        full. None = no decision exists this tick."""
        a = self.owner
        job = ctx["job"]
        worker = job.spec.tasks.get(TaskType.WORKER)
        ep = job.spec.elastic_policy
        if worker is None or ep is None:
            return None
        status = a._elastic_status(job)
        cur = worker.num_tasks

        # Hold while a scale transaction is executing (stale pods / inflight).
        if job.metadata.annotations.get(
                constants.ANNOTATION_SCALE_STATE) == \
                constants.SCALE_STATE_INFLIGHT:
            return None
        pods = a.cluster.list(Pod, job.metadata.namespace,
                              {constants.LABEL_JOB_NAME: job.metadata.name})
        workers = [p for p in pods if p.metadata.labels.get(
            constants.LABEL_TASK_TYPE) == TaskType.WORKER.value.lower()]
        if any(int(p.metadata.labels.get(constants.LABEL_JOB_GENERATION,
                                         "0") or 0)
               < job.metadata.generation for p in pods):
            return None

        pending = [p for p in workers if p.status.phase == PodPhase.PENDING]
        if pending and cur > ep.min_replicas and status.last_replicas > 0:
            # Grown size not materializing. Grace-period the revert
            # (reference polls up to 1min, elastic_scale.go:440-474): a
            # tick landing in a normal seconds-long scheduling window
            # must not kill autoscaling.
            self.pending_ticks += 1
            if self.pending_ticks >= a.config.elastic_pending_grace_ticks:
                self.seq += 1
                return _ElasticPack(job, status, cur,
                                    status.last_replicas,
                                    status.last_latency,
                                    revert_to=status.last_replicas)
            return None
        self.pending_ticks = 0
        if len(workers) < cur or pending:
            return None  # world still assembling
        if self.frozen:
            return None  # no decisions → no log tailing either

        obs = a._collect_observations(job, self, cur)
        if len(obs) < a.config.elastic_metric_count:
            return None
        window = obs[-a.config.elastic_metric_count:]
        cur_latency = sum(o.latency for o in window) / len(window)
        status.current_latency = cur_latency
        self.seq += 1
        return _ElasticPack(job, status, cur, status.last_replicas,
                            status.last_latency, cur_latency=cur_latency)

    def decide(self, pack: _ElasticPack, ctx) -> Decision:
        """The throughput continue-test (reference order,
        elastic_scale.go:186-233: continue-test FIRST — a regression at
        max replicas must still revert to the last-good size). The
        decision KIND rides ``ctx`` to commit; the Decision itself is
        the shared loop vocabulary the log and ledger serialize."""
        a = self.owner
        job = ctx["job"]
        status, cur = pack.status, pack.cur
        ep = job.spec.elastic_policy
        if pack.revert_to is not None:
            ctx["elastic_kind"] = "revert"
            return Decision(self.seq,
                            ACTION_DOWN if pack.revert_to < cur
                            else ACTION_HOLD, cur, pack.revert_to,
                            "pending pods at grown size; reverting")
        if is_satisfy_elastic_continue(status.last_replicas,
                                       status.last_latency,
                                       cur, pack.cur_latency):
            nxt = None if cur >= ep.max_replicas else \
                a._next_host_count(job, cur, ep.max_replicas)
            if nxt is None:
                ctx["elastic_kind"] = "freeze_max_replicas"
                return Decision(self.seq, ACTION_HOLD, cur, cur,
                                "ReachMaxReplicas")
            status.last_replicas = cur
            status.last_latency = pack.cur_latency
            status.continue_scaling = True
            status.message = f"scaling {cur} -> {nxt} hosts"
            ctx["elastic_kind"] = "grow"
            return Decision(self.seq, ACTION_UP, cur, nxt,
                            f"scaling {cur} -> {nxt} hosts")
        # Throughput stopped scaling: best config is the previous one.
        ctx["elastic_kind"] = "freeze_max_metric"
        target = status.last_replicas or cur
        return Decision(self.seq,
                        ACTION_DOWN if target < cur else ACTION_HOLD,
                        cur, target, "ReachMaxMetric")

    def record(self, pack: _ElasticPack, decision, ctx) -> None:
        self.owner.decision_log.append(format_decision_line(
            decision.seq, decision.action, decision.current,
            decision.target, decision.reason,
            scope=(("job", ctx["key"]),)))

    def actionable(self, decision, ctx) -> bool:
        # every elastic decision executes SOMETHING (a rescale, a
        # freeze-with-status-write) — the kind dispatch lives in commit
        return True

    def commit(self, pack: _ElasticPack, decision, ctx) -> str:
        a = self.owner
        job = ctx["job"]
        status = pack.status
        kind = ctx["elastic_kind"]
        if kind == "freeze_max_replicas":
            self.frozen = True
            status.continue_scaling = False
            status.message = "ReachMaxReplicas"
            a._write_status(job)
            return COMMIT_NONE       # nothing scaled: a frozen hold
        if kind == "revert":
            a._rescale(job, status, self, decision.target,
                       message="pending pods at grown size; reverting",
                       freeze=True)
            return COMMIT_LANDED
        if kind == "freeze_max_metric":
            status.message = "ReachMaxMetric"
            a._rescale(job, status, self, decision.target, freeze=True)
            return COMMIT_LANDED
        if a.broker is not None and not a.broker.request_capacity(
                f"train/{ctx['key']}", decision.current, decision.target):
            # the capacity-market gate, pre-rescale: a refusal means the
            # grow never happened — no watermark reset, no status write,
            # no freeze — and the loop re-decides at full speed next
            # tick while the broker's ladder works the shortfall; the
            # grant lands whenever pressure clears
            a.decision_log.append(format_commit_failure_line(
                decision.seq, "BrokerRefused",
                scope=(("job", ctx["key"]),)))
            return "conflict:BrokerRefused"
        a._rescale(job, status, self, decision.target)
        return COMMIT_LANDED

    # -------------------------------------------------------- provenance hooks
    def opens_horizon(self, decision, outcome: str, ctx) -> bool:
        """A rescale that also FREEZES the loop (pending-revert,
        ReachMaxMetric) leaves no future tick to observe its effect —
        opening a horizon there would pin the open_effect_horizons
        gauge forever and read as a standing 'effects never land'
        alert on every normally-converged job."""
        return ctx.get("elastic_kind") == "grow"

    def signals_of(self, pack: _ElasticPack):
        fmt = (lambda v: "none" if v is None else f"{v:.6f}")
        return (("latency", fmt(pack.cur_latency)),
                ("last_latency", fmt(pack.last_latency)),
                ("last_replicas", str(pack.last_replicas)))

    def horizon_events(self, h: OpenHorizon, pack: _ElasticPack, ctx):
        # a metric tick only exists once the world assembled at the new
        # size AND post-scale evidence filled the window — exactly the
        # "replicas went ready" observation (a revert tick proves the
        # opposite and must not close anything)
        if pack.revert_to is None and pack.cur == h.target:
            return ((HORIZON_REPLICAS_READY, True),)
        return ()


class ElasticAutoscaler:
    """The decision loop. ``run_once()`` is the deterministic unit tests and
    the local driver call; ``run()`` wraps it in a background thread at the
    reference's 30s cadence."""

    def __init__(self, cluster: InMemoryCluster,
                 config: Optional[JobControllerConfig] = None,
                 metrics: Optional[JobMetrics] = None,
                 ledger=None, broker=None) -> None:
        self.cluster = cluster
        self.config = config or JobControllerConfig()
        self.metrics = metrics
        # the capacity broker (`coordinator/broker.CapacityBroker`):
        # set, every grow asks for chips before the rescale (a refusal
        # is ``conflict:BrokerRefused`` — the loop retries next tick)
        # and the job becomes a bidder (``train/<key>``) the broker's
        # rung-3 preemption can shrink through ``shrink_to`` — the
        # live-reshard path with its cold-restart fallback, never a
        # kill. None → market-free operation, byte-identical.
        self.broker = broker
        # the decision ledger (`obs/ledger.DecisionLedger`): every
        # elastic decision lands one provenance record through the loop
        # kernel, uniformly with the serving loops. None → NOOP.
        self.ledger = ledger
        #: stable one-line-per-decision record in the shared serializer
        #: format (``job=<ns/name> seq=N action=... replicas=c->t
        #: reason=...``) — the elastic twin of the FleetAutoscaler's
        #: byte-comparable log. Bounded like its sibling.
        self.decision_log: Deque[str] = deque(maxlen=10_000)
        self._lock = threading.Lock()
        self._jobs: Dict[str, _JobState] = {}  # "ns/name" → state
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ registration
    def register(self, job: TorchJob) -> None:
        """Jobs enter via the create-watch (reference eventhandler.go:25-66);
        only native-elastic jobs (elastic_policy set) qualify."""
        if job.spec.elastic_policy is None:
            return
        key = f"{job.metadata.namespace}/{job.metadata.name}"
        with self._lock:
            self._jobs.setdefault(key, _JobState())
        self._broker_register(key)

    def deregister(self, job: TorchJob) -> None:
        key = f"{job.metadata.namespace}/{job.metadata.name}"
        with self._lock:
            state = self._jobs.pop(key, None)
        if state is not None:
            # a deleted-mid-scale job must not leave an unclosable
            # horizon pinning the shared ledger's gauge
            state.abandon()
            self._broker_deregister(key)

    def observe_event(self, event) -> None:
        """Watch glue: register on ADDED, deregister on DELETED."""
        if event.kind != constants.KIND_TORCHJOB:
            return
        if event.type == "ADDED":
            self.register(event.obj)
        elif event.type == "DELETED":
            self.deregister(event.obj)

    def registered(self) -> List[str]:
        with self._lock:
            return sorted(self._jobs)

    # ------------------------------------------------------------ decision loop
    def run_once(self) -> None:
        with self._lock:
            keys = list(self._jobs.items())
        for key, state in keys:
            ns, name = key.split("/", 1)
            job = self.cluster.try_get(TorchJob, ns, name)
            if job is None or conditions.is_finished(job.status):
                with self._lock:
                    self._jobs.pop(key, None)
                state.abandon()
                self._broker_deregister(key)
                continue
            # the kernel template drives observe→decide→commit and
            # lands one ledger record per decision (hooks on _JobState
            # above; they reach this controller through `owner`)
            state.bind(f"elasticautoscaler/{key}", self.ledger)
            state.bind_owner(self)
            try:
                state.run_tick({"job": job, "key": key})
            except NotFoundError:
                continue

    # --------------------------------------------------------- capacity market
    def _broker_register(self, key: str) -> None:
        """Make the job a bidder on the capacity market (idempotent —
        re-registering would reset the lane's ledger loop). The bid and
        shrink closures run on the BROKER's tick thread and touch only
        the cluster client and ``shrink_to`` — which takes this
        autoscaler's lock briefly for the state lookup, never while the
        broker holds its own, so no lock-order cycle exists."""
        broker = self.broker
        if broker is None:
            return
        name = f"train/{key}"
        if name in broker.consumers():
            return
        broker.register(
            name,
            lambda: self._training_bid(key),
            apply_fn=lambda target, reason: self.shrink_to(
                key, target, reason=reason))

    def _broker_deregister(self, key: str) -> None:
        if self.broker is not None:
            self.broker.deregister(f"train/{key}")

    def _training_bid(self, key: str):
        """The job's standing bid: hold its current worker gang (growth
        arrives through the ``request_capacity`` gate in commit),
        floored at ``elastic_policy.min_replicas`` — the broker's
        rung-3 preemption can shrink the gang down to the floor but
        never below, and never touches a non-elastic job at all."""
        from tpu_on_k8s_torch.coordinator.broker import (
            KIND_TRAINING, PRIORITY_TRAINING, Bid)
        ns, name = key.split("/", 1)
        job = self.cluster.try_get(TorchJob, ns, name)
        if job is None or conditions.is_finished(job.status):
            return None
        ep = job.spec.elastic_policy
        worker = job.spec.tasks.get(TaskType.WORKER)
        if ep is None or worker is None:
            return None
        cur = max(int(worker.num_tasks), 0)
        return Bid(name=f"train/{key}", kind=KIND_TRAINING,
                   priority=PRIORITY_TRAINING, current=cur, desired=cur,
                   floor=max(int(ep.min_replicas), 0), unit=1,
                   preemption_cost=float(cur))

    def shrink_to(self, key: str, hosts: int, *, reason: str = "") -> bool:
        """Broker-pushed preemption (ladder rung 3): shrink the job's
        worker gang to ``hosts`` through the SAME path an elastic
        decision takes — ``apply_host_count`` slice legality, a
        live-reshard request when the policy allows one, the
        checkpoint-restart fallback otherwise — WITHOUT freezing the
        continue-test: when pressure clears, the loop's next grow asks
        the broker again and wins its chips back. Clamped to
        ``min_replicas``; already at/below target is a success."""
        ns, name = key.split("/", 1)
        with self._lock:
            state = self._jobs.get(key)
        job = self.cluster.try_get(TorchJob, ns, name)
        if state is None or job is None \
                or conditions.is_finished(job.status):
            return False
        ep = job.spec.elastic_policy
        worker = job.spec.tasks.get(TaskType.WORKER)
        if ep is None or worker is None:
            return False
        target = max(int(hosts), int(ep.min_replicas))
        if target >= worker.num_tasks:
            return True
        status = self._elastic_status(job)
        try:
            self._rescale(job, status, state, target,
                          message=reason
                          or f"broker preempt to {target} hosts")
        except NotFoundError:
            return False
        return True

    def _next_host_count(self, job: TorchJob, cur: int, cap: int) -> Optional[int]:
        """One growth step: multi-slice jobs add a slice; single-slice
        jobs step to the next legal topology host count (one slice preferred),
        falling over to a second slice only once the topology maxes out."""
        gpu = job.spec.gpu_policy
        per_slice = topology.hosts_per_slice(gpu.accelerator, gpu.topology)
        if gpu.num_slices > 1:
            nxt = cur + per_slice
        else:
            nxt = topology.next_legal_host_count(gpu.accelerator, cur)
            if nxt is None:
                nxt = cur + per_slice
        return None if nxt > cap else nxt

    # --------------------------------------------------------------- mechanics
    def _collect_observations(self, job: TorchJob, state: _JobState,
                              replicas: int) -> List[MetricObservation]:
        """getMetricsObservation (observation.go:40-106): tail worker-0's log.
        Lines at/below the rescale watermark belong to the previous world size
        and are excluded; buckets are bounded."""
        worker0 = conditions.gen_general_name(job.metadata.name, TaskType.WORKER, 0)
        lines = self.cluster.read_pod_log(
            job.metadata.namespace, worker0,
            tail=self.config.elastic_metric_count * 4)
        parsed = [o for o in (parse_observation(l) for l in lines) if o is not None]
        bucket = state.observations.setdefault(replicas, [])
        seen = {(o.epoch, o.batch) for o in bucket}
        cap = self.config.elastic_metric_count * 4
        for o in parsed:
            key = (o.epoch, o.batch)
            if state.watermark is not None and key <= state.watermark:
                continue
            if key not in seen:
                bucket.append(o)
                seen.add(key)
        del bucket[:-cap]
        return bucket

    def _rescale(self, job: TorchJob, status: ElasticStatus, state: _JobState,
                 hosts: int, *, message: str = "", freeze: bool = False) -> None:
        if message:
            status.message = message
        if freeze:
            state.frozen = True
            status.continue_scaling = False
        # Advance the watermark past everything seen so far: post-scale
        # decisions must rest on post-scale evidence only.
        keys = [(o.epoch, o.batch)
                for bucket in state.observations.values() for o in bucket]
        if keys:
            state.watermark = max(keys)
        state.observations.clear()

        worker = job.spec.tasks.get(TaskType.WORKER)
        prev_hosts = worker.num_tasks if worker is not None else 0
        applied = [0]

        def mutate(j: TorchJob) -> None:
            applied[0] = apply_host_count(j, hosts)

        updated = self.cluster.update_with_retry(
            TorchJob, job.metadata.namespace, job.metadata.name, mutate)
        status.replicas = applied[0]
        ep = job.spec.elastic_policy
        if (ep is not None and ep.live_reshard and applied[0] > 0
                and applied[0] != prev_hosts):
            # the decision is a (hosts, mesh shape) PAIR: deliver it to
            # the pods as a live-reshard request (`parallel/reshard.py`)
            # instead of leaving the cold restart as the only executor
            self._request_live_reshard(updated, applied[0])
        self._write_status(job)
        self.cluster.record_event(
            job, "Normal", "ElasticRescale",
            f"autoscaler: {status.message or f'scale to {applied[0]} hosts'}")

    def _request_live_reshard(self, job: TorchJob, hosts: int) -> None:
        """Stamp the post-respec job with the (hosts, mesh shape) reshard
        request. The mesh shape is derived from the new slice
        configuration under `gang/topology` legality (axis product ==
        chip count); a configuration with no legal default shape leaves
        the cold checkpoint-restart path in charge, with the reason on
        the event stream."""
        gpu = job.spec.gpu_policy
        try:
            mesh = topology.mesh_shape_for_slice(
                gpu.accelerator, gpu.topology, gpu.num_slices)
        except (KeyError, ValueError) as e:
            self.cluster.record_event(job, "Warning", "LiveReshardSkipped",
                                      f"no slice-legal mesh shape: {e}")
            return
        spec = topology.format_reshard_spec(
            job.metadata.generation, hosts, mesh)
        try:
            self.cluster.patch_meta(
                TorchJob, job.metadata.namespace, job.metadata.name,
                annotations={
                    constants.ANNOTATION_RESHARD_REQUESTED_SPEC: spec})
        except NotFoundError:
            return
        self.cluster.record_event(job, "Normal", "LiveReshardRequested",
                                  f"reshard request: {spec}")

    def _elastic_status(self, job: TorchJob) -> ElasticStatus:
        status = job.status.elastic_statuses.get(TaskType.WORKER)
        if status is None:
            status = ElasticStatus(
                replicas=job.spec.tasks[TaskType.WORKER].num_tasks)
            job.status.elastic_statuses[TaskType.WORKER] = status
        return status

    def _write_status(self, job: TorchJob) -> None:
        desired = job.status.elastic_statuses

        def mutate(j: TorchJob) -> None:
            j.status.elastic_statuses = desired

        try:
            self.cluster.update_with_retry(
                TorchJob, job.metadata.namespace, job.metadata.name, mutate,
                subresource="status")
        except NotFoundError:
            pass

    # ----------------------------------------------------------------- run loop
    def run(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.run_once()
                except Exception:
                    # a crashing decision loop must never disappear silently:
                    # surface it in the log AND the errors_total counter
                    _log.exception("elastic autoscaler tick failed")
                    if self.metrics is not None:
                        self.metrics.error()
                self._stop.wait(self.config.elastic_loop_period_seconds)

        # start before publishing: stop() must never observe (and join) a
        # created-but-unstarted thread
        t = threading.Thread(target=loop, daemon=True, name="elastic-autoscaler")
        t.start()
        self._thread = t

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)


def setup_elastic_autoscaler(cluster: InMemoryCluster,
                             config: Optional[JobControllerConfig] = None,
                             metrics: Optional[JobMetrics] = None,
                             ledger=None, broker=None) -> ElasticAutoscaler:
    """Wire the autoscaler's job registry to the cluster watch (reference
    SetupWithManager, torchelastic/elastictorchjob_controller.go:128-148)."""
    scaler = ElasticAutoscaler(cluster, config=config, metrics=metrics,
                               ledger=ledger, broker=broker)
    cluster.watch(scaler.observe_event)
    return scaler
