"""Coordinator data types and plugin contracts (the
counterpart of ``tpu_on_k8s/coordinator/types.py``).

Analog of pkg/coordinator/{types.go,interface.go}: the
``QueueUnit`` a tenant queue holds (types.go:46-79), scheduling-cycle status
codes (types.go:89-176), and the five plugin extension points
(interface.go:55-82). Plugins are plain objects implementing the protocols —
no reflection-based registry wiring (the reference's coordinator.go:116-162
reflection dance is replaced by an explicit PluginConfig).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional, Protocol, runtime_checkable

from tpu_on_k8s_torch.api.types import SchedulingPolicy, TorchJob
from tpu_on_k8s_torch.utils import resources as resmath


class Code(enum.IntEnum):
    """Cycle status codes (reference types.go:89-176)."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    WAIT = 3
    SKIP = 4


@dataclass
class Status:
    code: Code = Code.SUCCESS
    reasons: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.code == Code.SUCCESS

    @classmethod
    def success(cls) -> "Status":
        return cls(Code.SUCCESS)

    @classmethod
    def wait(cls, *reasons: str) -> "Status":
        return cls(Code.WAIT, list(reasons))

    @classmethod
    def error(cls, *reasons: str) -> "Status":
        return cls(Code.ERROR, list(reasons))

    @classmethod
    def unschedulable(cls, *reasons: str) -> "Status":
        return cls(Code.UNSCHEDULABLE, list(reasons))

    @classmethod
    def skip(cls, *reasons: str) -> "Status":
        return cls(Code.SKIP, list(reasons))


@dataclass
class QueueUnit:
    """One queued job (reference types.go:46-79). ``owner`` is the reconciler
    controller whose workqueue receives the request on dequeue
    (core/coordinator.go:226-248 Owner.Add)."""

    tenant: str = ""
    job: Optional[TorchJob] = None
    priority: Optional[int] = None
    scheduling_policy: Optional[SchedulingPolicy] = None
    resources: Dict[str, float] = field(default_factory=dict)
    spot_resources: Dict[str, float] = field(default_factory=dict)
    owner: object = None  # Controller with .enqueue(ns, name)

    @property
    def uid(self) -> str:
        return self.job.metadata.uid

    @property
    def key(self) -> str:
        return f"{self.job.metadata.namespace}/{self.job.metadata.name}"

    @classmethod
    def from_job(cls, job: TorchJob, owner=None, tenant: str = "") -> "QueueUnit":
        policy = job.spec.run_policy.scheduling_policy
        return cls(
            tenant=tenant,
            job=job,
            priority=policy.priority if policy else None,
            scheduling_policy=policy,
            resources=resmath.job_requests(job, include_spot=False),
            spot_resources=resmath.job_spot_requests(job),
            owner=owner,
        )

    def total_tasks(self) -> int:
        return sum(t.num_tasks for t in self.job.spec.tasks.values())


@runtime_checkable
class TenantPlugin(Protocol):
    """Maps a queue unit to its tenant queue name (interface.go TenantPlugin)."""

    def tenant_name(self, unit: QueueUnit) -> str: ...


@runtime_checkable
class PreFilterPlugin(Protocol):
    def pre_filter(self, unit: QueueUnit) -> Status: ...


@runtime_checkable
class FilterPlugin(Protocol):
    def filter(self, unit: QueueUnit) -> Status: ...


@runtime_checkable
class ScorePlugin(Protocol):
    def score(self, unit: QueueUnit) -> float: ...


@runtime_checkable
class PreDequeuePlugin(Protocol):
    def pre_dequeue(self, unit: QueueUnit) -> Status: ...
