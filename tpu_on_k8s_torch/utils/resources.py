"""Resource math over plain quantity maps.

Analog of pkg/utils/resources/resources.go: pod requests are
``max(max(init containers), sum(containers))``; task/job requests multiply by
replica counts; spot replicas can be split out (JobResourceRequests,
resources.go:89-109). Quantities here are numeric (chips/cores/bytes), see
``tpu_on_k8s_torch.api.core.ResourceRequirements``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

from tpu_on_k8s_torch.api.core import PodSpec
from tpu_on_k8s_torch.api.types import TaskSpec, TorchJob

ResourceList = Dict[str, float]


def add(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    out: ResourceList = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) + v
    return out


def scale(a: Mapping[str, float], factor: float) -> ResourceList:
    return {k: v * factor for k, v in a.items()}


def maximum(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    out: ResourceList = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0.0), v)
    return out


def subtract(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    out: ResourceList = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) - v
    return out


def fits(request: Mapping[str, float], available: Mapping[str, float]) -> bool:
    """True if ``request`` fits into ``available`` for every resource named in
    ``available`` (resources absent from ``available`` are unlimited — the
    ResourceQuota semantics the coordinator's quota plugin needs)."""
    return all(request.get(k, 0.0) <= v for k, v in available.items())


def pod_requests(spec: PodSpec) -> ResourceList:
    """Effective pod request: max(any single init container, sum of main
    containers) — k8s scheduling semantics the reference mirrors
    (resources.go init-container max)."""
    main: ResourceList = {}
    for c in spec.containers:
        main = add(main, c.resources.requests)
    init: ResourceList = {}
    for c in spec.init_containers:
        init = maximum(init, c.resources.requests)
    return maximum(main, init)


def task_requests(task: TaskSpec, replicas: Optional[int] = None) -> ResourceList:
    n = task.num_tasks if replicas is None else replicas
    return scale(pod_requests(task.template.spec), n)


def job_requests(job: TorchJob, *, include_spot: bool = True) -> ResourceList:
    """Total job request (JobResourceRequests, resources.go:89-109); with
    ``include_spot=False`` spot replicas are excluded (the reference reports
    them separately in QueueUnit.SpotResources)."""
    total: ResourceList = {}
    for task in job.spec.tasks.values():
        n = task.num_tasks
        if not include_spot and task.spot_task_spec is not None:
            n = max(0, n - task.spot_task_spec.num_spot_tasks)
        total = add(total, task_requests(task, n))
    return total


def job_spot_requests(job: TorchJob) -> ResourceList:
    total: ResourceList = {}
    for task in job.spec.tasks.values():
        spot = task.spot_task_spec
        if spot is None or spot.num_spot_tasks <= 0:
            continue
        n = min(task.num_tasks, spot.num_spot_tasks)
        total = add(total, task_requests(task, n))
    return total
