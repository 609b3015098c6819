"""Coordinator core: tenant queues + the scheduling cycle (the
counterpart of ``tpu_on_k8s/coordinator/core.py``).

Analog of pkg/coordinator/core/coordinator.go. A job entering
the cluster is **held** in a tenant queue (the watch path enqueues here rather
than into the reconciler workqueue — eventhandler.go:38-64); every scheduling
period one cycle runs: pick a queue via the selector (smooth WRR by default —
wired in, unlike the reference's plain-RR ctor at coordinator.go:62), scan its
snapshot through pre-filter/filter plugins (isQueueUnitAcceptable :389-430),
score the acceptable units (:434-452), pick the max with reservoir tie-break
(:456-476), run pre-dequeue plugins, then hand the job to its reconciler's
workqueue (Dequeue → Owner.Add, :226-248) and mark the status transition
Queuing→Dequeued (queueStateMarker :98-113).

The coordinator↔controller handshake race the reference has (SetQueueUnitOwner
skip-if-nil, SURVEY §7 hard parts) is designed out: the owner controller is a
required argument of ``enqueue_or_update``.
"""
from __future__ import annotations

import random
import threading
from typing import Callable, Dict, List, Optional

from tpu_on_k8s_torch.api.types import JobConditionType, TorchJob
from tpu_on_k8s_torch.client.cluster import InMemoryCluster, NotFoundError
from tpu_on_k8s_torch.coordinator.plugins import PluginConfig
from tpu_on_k8s_torch.coordinator.policy import (
    QueueSelector,
    SmoothWeightedRoundRobinSelector,
)
from tpu_on_k8s_torch.coordinator.queue import Queue
from tpu_on_k8s_torch.coordinator.types import Code, QueueUnit, Status
from tpu_on_k8s_torch.metrics import JobMetrics
from tpu_on_k8s_torch.utils import conditions
from tpu_on_k8s_torch.utils.logging import get_logger

_log = get_logger("coordinator")

DEFAULT_SCHEDULING_PERIOD_SECONDS = 0.1  # plugins/registry.go:27


class Coordinator:
    def __init__(
        self,
        cluster: InMemoryCluster,
        plugins: Optional[PluginConfig] = None,
        selector: Optional[QueueSelector] = None,
        metrics: Optional[JobMetrics] = None,
        period_seconds: float = DEFAULT_SCHEDULING_PERIOD_SECONDS,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.cluster = cluster
        self.plugins = plugins or PluginConfig.default(cluster)
        self.selector = selector or SmoothWeightedRoundRobinSelector()
        self.metrics = metrics or JobMetrics()
        self.period = period_seconds
        self._rng = rng or random.Random()
        self._lock = threading.RLock()
        self._queues: Dict[str, Queue] = {}
        self._uid_to_tenant: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._phase_sweep_countdown = 0    # 0 ⇒ next cycle sweeps

    # ------------------------------------------------------------------- intake
    def enqueue_or_update(self, job: TorchJob, owner) -> None:
        """EnqueueOrUpdate (coordinator.go:195-233): place/update the job's
        queue unit and mark it Queuing. ``owner`` is the reconciler Controller
        whose workqueue receives the request on dequeue — explicit, closing the
        reference's SetQueueUnitOwner race."""
        unit = QueueUnit.from_job(job, owner=owner)
        unit.tenant = self.plugins.tenant.tenant_name(unit) if self.plugins.tenant \
            else job.metadata.namespace
        with self._lock:
            queue = self._queues.setdefault(unit.tenant, Queue(unit.tenant))
            stale_tenant = self._uid_to_tenant.get(unit.uid)
            if stale_tenant is not None and stale_tenant != unit.tenant:
                old = self._queues.get(stale_tenant)
                if old is not None:
                    old.remove(unit.uid)
            queue.add_or_update(unit)
            self._uid_to_tenant[unit.uid] = unit.tenant
        self._mark_queuing(job, unit.tenant)
        self._update_depth_gauges()

    def dequeue(self, job: TorchJob, *, reason: str = "") -> None:
        """Remove without scheduling (job deleted / no longer coordinated)."""
        self._remove(job.metadata.uid)
        self._release_reservations(job.metadata.uid)
        self._update_depth_gauges()

    def is_queuing(self, uid: str) -> bool:
        with self._lock:
            tenant = self._uid_to_tenant.get(uid)
            return tenant is not None and uid in self._queues.get(tenant, Queue(""))

    def queued_count(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def _remove(self, uid: str) -> Optional[QueueUnit]:
        with self._lock:
            tenant = self._uid_to_tenant.pop(uid, None)
            if tenant is None:
                return None
            queue = self._queues.get(tenant)
            if queue is None:
                return None
            unit = queue.remove(uid)
            if len(queue) == 0:
                del self._queues[tenant]
            return unit

    def _release_reservations(self, uid: str) -> None:
        for plugin in (self.plugins.pre_dequeues or []):
            release = getattr(plugin, "release", None)
            if release is not None:
                release(uid)

    def observe_job_left_queued_state(self, job: TorchJob) -> None:
        """Reservation cleanup hook: once a dequeued job is Running/finished its
        usage is real (visible to quota status), so drop the assumed quota
        (quota.go:256-277)."""
        if not conditions.needs_coordinator_enqueue(job.status):
            self._release_reservations(job.metadata.uid)

    # ------------------------------------------------------------------ cycle
    #: scheduling cycles between job-phase gauge sweeps (~5 s at the
    #: 100 ms loop period) — the sweep LISTs every TorchJob
    PHASE_GAUGE_SWEEP_CYCLES = 50

    def schedule_once(self) -> Optional[str]:
        """One scheduling cycle (coordinator.go:310-374). Returns the dequeued
        job key, or None if nothing was schedulable."""
        self._maybe_sweep_phase_gauges()
        with self._lock:
            queues = list(self._queues.values())
        queue = self.selector.next(queues)
        if queue is None:
            return None

        acceptable: List[QueueUnit] = []
        for unit in queue.snapshot():
            status = self._acceptable(unit)
            if status.code == Code.ERROR:
                self.cluster.record_event(
                    unit.job, "Warning", "CoordinateFailed", "; ".join(status.reasons))
                continue
            if not status.ok:
                continue
            acceptable.append(unit)
        if not acceptable:
            return None

        chosen = self._select_max_score(acceptable)
        for plugin in (self.plugins.pre_dequeues or []):
            if not plugin.pre_dequeue(chosen).ok:
                return None
        return self._dequeue_to_owner(chosen)

    def _acceptable(self, unit: QueueUnit) -> Status:
        """isQueueUnitAcceptable (coordinator.go:389-430)."""
        if self.cluster.try_get(
                TorchJob, unit.job.metadata.namespace, unit.job.metadata.name) is None:
            # Stale unit: job vanished without a delete event reaching us.
            self._remove(unit.uid)
            return Status.skip("job no longer exists")
        for plugin in (self.plugins.pre_filters or []):
            status = plugin.pre_filter(unit)
            if not status.ok:
                return status
        for plugin in (self.plugins.filters or []):
            status = plugin.filter(unit)
            if not status.ok:
                return status
        return Status.success()

    def _select_max_score(self, units: List[QueueUnit]) -> QueueUnit:
        """Max score with reservoir tie-break (selectQueueUnit :456-476)."""
        best: List[QueueUnit] = []
        best_score = float("-inf")
        for unit in units:
            score = sum(p.score(unit) for p in (self.plugins.scorers or []))
            if score > best_score:
                best, best_score = [unit], score
            elif score == best_score:
                best.append(unit)
        return best[0] if len(best) == 1 else self._rng.choice(best)

    def _dequeue_to_owner(self, unit: QueueUnit) -> Optional[str]:
        """Dequeue (coordinator.go:226-248): push into the reconciler workqueue
        and mark the Queuing→Dequeued status transition."""
        self._remove(unit.uid)
        job = self.cluster.try_get(
            TorchJob, unit.job.metadata.namespace, unit.job.metadata.name)
        if job is not None:
            self._mark_dequeued(job)
        if unit.owner is not None:
            unit.owner.enqueue(unit.job.metadata.namespace, unit.job.metadata.name)
        self._update_depth_gauges()
        return unit.key

    def drain(self, max_cycles: int = 10_000) -> int:
        """Run cycles until a full queue rotation yields nothing schedulable
        (tests / local driver). Returns dequeue count."""
        n = 0
        idle = 0
        for _ in range(max_cycles):
            with self._lock:
                n_queues = len(self._queues)
            if n_queues == 0:
                return n
            if self.schedule_once() is None:
                idle += 1
                # One idle cycle is not proof of quiescence under WRR rotation.
                if idle > n_queues:
                    return n
            else:
                idle = 0
                n += 1
        return n

    # ------------------------------------------------------------- status marks
    def _mark_queuing(self, job: TorchJob, tenant: str) -> None:
        """queueStateMarker (coordinator.go:98-113). ``tenant`` is the
        placement captured under the queue lock by the caller — the
        mutate closure must not re-read ``_uid_to_tenant`` lock-free
        (the schedule thread's ``_remove`` pops it concurrently, and a
        conflict retry would re-read mid-removal)."""
        def mutate(j: TorchJob) -> None:
            conditions.update_job_conditions(
                j.status, JobConditionType.QUEUING, "JobEnqueued",
                f"job enqueued in tenant queue {tenant}")
        self._write_if_changed(job, mutate)

    def _mark_dequeued(self, job: TorchJob) -> None:
        def mutate(j: TorchJob) -> None:
            conditions.update_job_conditions(
                j.status, JobConditionType.QUEUING, "JobDequeued",
                "job dequeued by coordinator", cond_status="False")
        self._write_if_changed(job, mutate)

    def _write_if_changed(self, job: TorchJob, mutate: Callable[[TorchJob], None]) -> None:
        """No-op writes are suppressed: every MODIFIED event re-enters the
        watch path, so unconditional writes would livelock enqueue."""
        try:
            current = self.cluster.get(TorchJob, job.metadata.namespace, job.metadata.name)
        except NotFoundError:
            return
        before = [(c.type, c.status, c.reason) for c in current.status.conditions]
        mutate(current)
        after = [(c.type, c.status, c.reason) for c in current.status.conditions]
        if before == after:
            return
        try:
            self.cluster.update_with_retry(
                TorchJob, job.metadata.namespace, job.metadata.name, mutate,
                subresource="status")
        except NotFoundError:
            pass

    def _update_depth_gauges(self) -> None:
        with self._lock:
            for name, queue in self._queues.items():
                self.metrics.set_gauge("queue_pending", float(len(queue)), label=name)

    def _update_phase_gauges(self) -> None:
        """Cluster-wide job-phase gauges (reference metrics.go:33-124
        keeps running/pending next to the queue depths): unfinished jobs
        split by the Running condition. A full LIST — O(jobs) against
        the API server in CRR mode — so it runs on the slow sweep
        cadence below, never per enqueue/dequeue."""
        running = pending = 0
        for job in self.cluster.list(TorchJob):
            if conditions.is_finished(job.status):
                continue
            if conditions.is_running(job.status):
                running += 1
            else:
                pending += 1
        self.metrics.set_gauge("running", float(running))
        self.metrics.set_gauge("pending", float(pending))

    def _maybe_sweep_phase_gauges(self) -> None:
        """Every PHASE_GAUGE_SWEEP_CYCLES scheduling cycles (~5 s at the
        100 ms loop period); counter-based so no wall clock enters the
        scheduling path. The first cycle sweeps immediately. A failed
        LIST (an API-server blip in CRR mode) must not abort the
        scheduling cycle — it is counted, and the sweep retries next
        cycle instead of waiting out a full period."""
        if self._phase_sweep_countdown > 0:
            self._phase_sweep_countdown -= 1
            return
        try:
            self._update_phase_gauges()
        except Exception:
            self.metrics.error()
            _log.warning("job-phase gauge sweep failed; retrying next "
                         "cycle", exc_info=True)
            return               # countdown stays 0 → next cycle retries
        self._phase_sweep_countdown = self.PHASE_GAUGE_SWEEP_CYCLES - 1

    # --------------------------------------------------------------- run loop
    def run(self) -> None:
        """100ms schedule loop (coordinator.go:305-307), background thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.schedule_once()
                except Exception:  # cycle errors must not kill the loop
                    _log.exception("coordinator schedule cycle failed")
                    if self.metrics is not None:
                        self.metrics.error()
                self._stop.wait(self.period)

        # start before publishing: stop() must never observe (and join) a
        # created-but-unstarted thread
        t = threading.Thread(target=loop, daemon=True, name="coordinator")
        t.start()
        self._thread = t

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)
