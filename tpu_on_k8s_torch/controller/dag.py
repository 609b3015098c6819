"""DAG gating of task creation (the counterpart of
``tpu_on_k8s/controller/dag.py``).

Analog of controllers/common/dag.go:30-116: a task type's pods are
only created once each upstream task type has all replicas at-or-past the required
phase. Default edges (AIMaster→Master→Worker) are injected by defaulting.
"""
from __future__ import annotations

from typing import Dict, List

from tpu_on_k8s_torch.api.core import Pod, PodPhase
from tpu_on_k8s_torch.api.types import TaskType, TorchJob

# Phase ordering codes (dag.go:111-116): a pod at phase >= required satisfies the
# gate, except terminal Failed/Unknown never satisfies a Running requirement.
_PHASE_RANK = {
    PodPhase.PENDING: 0,
    PodPhase.RUNNING: 1,
    PodPhase.SUCCEEDED: 2,
    PodPhase.FAILED: -1,
    PodPhase.UNKNOWN: -2,
}


def upstream_tasks_ready(
    job: TorchJob,
    upstream: TaskType,
    required_phase: str,
    pods_by_type: Dict[TaskType, List[Pod]],
) -> bool:
    """All replicas of ``upstream`` exist and are at/past ``required_phase``
    (dag.go:83-109)."""
    spec = job.spec.tasks.get(upstream)
    if spec is None:
        return True  # edge to a task type the job doesn't declare: vacuous
    pods = pods_by_type.get(upstream, [])
    if len(pods) < spec.num_tasks:
        return False
    need = _PHASE_RANK.get(required_phase, 1)
    ok = 0
    for pod in pods:
        rank = _PHASE_RANK.get(pod.status.phase, -2)
        if rank >= need and rank >= 0:
            ok += 1
    return ok >= spec.num_tasks


def dag_conditions_ready(
    job: TorchJob,
    task_type: TaskType,
    pods_by_type: Dict[TaskType, List[Pod]],
) -> bool:
    """All DAG edges into ``task_type`` are satisfied (dag.go:30-54)."""
    spec = job.spec.tasks.get(task_type)
    if spec is None:
        return True
    for cond in spec.dag_conditions:
        if not upstream_tasks_ready(job, cond.upstream, cond.on_phase, pods_by_type):
            return False
    return True
