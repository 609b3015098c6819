"""Coordinator plugins: quota (tenant + filter + pre-dequeue) and priority (the
counterpart of ``tpu_on_k8s/coordinator/plugins.py``).

Analog of pkg/coordinator/plugins/{quota.go,priority.go,
registry.go}. The quota plugin's *assumed quota* mechanism (quota.go:176-277)
carries over: a reservation is taken at pre-dequeue so back-to-back scheduling
cycles don't over-admit before the dequeued job's pods land in
``ResourceQuota.status.used``; reservations expire after a TTL or when the
coordinator observes the job leaving the queued state (``release``).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

from tpu_on_k8s_torch.api.core import PriorityClass, ResourceQuota
from tpu_on_k8s_torch.client.cluster import InMemoryCluster
from tpu_on_k8s_torch.coordinator.types import QueueUnit, Status
from tpu_on_k8s_torch.utils import resources as resmath

DEFAULT_ASSUME_TTL_SECONDS = 60.0  # quota.go:48


class QuotaPlugin:
    """Tenant + Filter + PreDequeue plugin (quota.go)."""

    name = "Quota"

    def __init__(self, cluster: InMemoryCluster, *,
                 assume_ttl_seconds: float = DEFAULT_ASSUME_TTL_SECONDS,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.cluster = cluster
        self.assume_ttl = assume_ttl_seconds
        self._clock = clock
        self._lock = threading.Lock()
        # uid → (tenant, resources, assumed-at)
        self._assumed: Dict[str, Tuple[str, Dict[str, float], float]] = {}

    # ---- TenantPlugin ---------------------------------------------------------
    def tenant_name(self, unit: QueueUnit) -> str:
        """SchedulingPolicy.Queue else namespace (quota.go:82-92)."""
        policy = unit.scheduling_policy
        if policy is not None and policy.queue:
            return policy.queue
        return unit.job.metadata.namespace

    # ---- FilterPlugin ---------------------------------------------------------
    def filter(self, unit: QueueUnit) -> Status:
        """Wait while the unit's request exceeds namespace quota minus assumed
        reservations (quota.go:97-131). Namespaces without any ResourceQuota
        are unlimited."""
        quotas = self.cluster.list(ResourceQuota, unit.job.metadata.namespace)
        if not quotas:
            return Status.success()
        hard: Dict[str, float] = {}
        used: Dict[str, float] = {}
        for q in quotas:
            hard = resmath.add(hard, q.spec.hard)
            used = resmath.add(used, q.status.used)
        available = resmath.subtract(hard, used)
        for _, res, _ in self._live_assumed(unit.job.metadata.namespace):
            available = resmath.subtract(available, res)
        if not resmath.fits(unit.resources, available):
            return Status.wait(
                f"quota exceeded in namespace {unit.job.metadata.namespace}: "
                f"request {unit.resources} > available {available}")
        return Status.success()

    # ---- PreDequeuePlugin -----------------------------------------------------
    def pre_dequeue(self, unit: QueueUnit) -> Status:
        """Optimistically reserve the unit's request (quota.go:176-181)."""
        with self._lock:
            self._assumed[unit.uid] = (
                unit.job.metadata.namespace, dict(unit.resources), self._clock())
        return Status.success()

    # ---- reservation lifecycle ------------------------------------------------
    def release(self, uid: str) -> None:
        """Drop a reservation once the job's usage is visible in quota status
        or the job left the queued state (quota.go:256-277)."""
        with self._lock:
            self._assumed.pop(uid, None)

    def _live_assumed(self, namespace: str) -> List[Tuple[str, Dict[str, float], float]]:
        now = self._clock()
        with self._lock:
            expired = [uid for uid, (_, _, at) in self._assumed.items()
                       if now - at > self.assume_ttl]
            for uid in expired:
                del self._assumed[uid]
            return [(uid, res, at) for uid, (ns, res, at) in self._assumed.items()
                    if ns == namespace]

    def assumed_count(self) -> int:
        with self._lock:
            return len(self._assumed)


class PriorityPlugin:
    """Score = SchedulingPolicy.Priority, else the PriorityClass value, else 0
    (priority.go:48-87)."""

    name = "Priority"

    def __init__(self, cluster: InMemoryCluster) -> None:
        self.cluster = cluster

    def score(self, unit: QueueUnit) -> float:
        if unit.priority is not None:
            return float(unit.priority)
        policy = unit.scheduling_policy
        if policy is not None and policy.priority_class_name:
            pc = self.cluster.try_get(PriorityClass, "", policy.priority_class_name)
            if pc is not None:
                return float(pc.value)
        return 0.0


@dataclass
class PluginConfig:
    """Default wiring (reference plugins/registry.go:36-49): Tenant=Quota,
    Filter=[Quota], Score=[Priority], PreDequeue=[Quota]."""

    tenant: object = None
    pre_filters: List[object] = None
    filters: List[object] = None
    scorers: List[object] = None
    pre_dequeues: List[object] = None

    @classmethod
    def default(cls, cluster: InMemoryCluster, *,
                assume_ttl_seconds: float = DEFAULT_ASSUME_TTL_SECONDS,
                clock: Callable[[], float] = time.monotonic) -> "PluginConfig":
        quota = QuotaPlugin(cluster, assume_ttl_seconds=assume_ttl_seconds, clock=clock)
        return cls(
            tenant=quota,
            pre_filters=[],
            filters=[quota],
            scorers=[PriorityPlugin(cluster)],
            pre_dequeues=[quota],
        )
