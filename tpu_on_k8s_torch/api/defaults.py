"""TorchJob defaulting.

Analog of apis/train/v1alpha1/torchjob_defaults.go:29-197, with the
reference's known defaulting bugs fixed (SURVEY "fidelity notes"):

* ``setDefaults_TorchJobMinMembers`` iterated the (nil) ``MinMembers`` map and so
  never defaulted anything (torchjob_defaults.go:192-197) — here min-members are
  genuinely populated from the task map / slice topology.
"""
from __future__ import annotations

from typing import Dict

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Container, ContainerPort
from tpu_on_k8s_torch.api.types import (
    DAGCondition,
    RestartPolicy,
    SchedulingPolicy,
    TaskSpec,
    TaskType,
    TorchJob,
)
from tpu_on_k8s_torch.gang import topology as gpu_topology

_DEFAULT_RESTART = {
    # Master failures are classified by exit code so preemptions retry but user
    # bugs fail fast (reference constants.go:101-110).
    TaskType.MASTER: RestartPolicy.ON_EXIT_CODE,
    TaskType.WORKER: RestartPolicy.ON_FAILURE,
    TaskType.AIMASTER: RestartPolicy.ON_FAILURE,
}


def set_defaults_torchjob(job: TorchJob) -> TorchJob:
    """Mutate ``job`` in place, filling all defaulted fields; returns the job."""
    _normalize_task_keys(job)
    for task_type, task in job.spec.tasks.items():
        if task.num_tasks <= 0:
            task.num_tasks = 1
        if task.restart_policy is None:
            task.restart_policy = _DEFAULT_RESTART[task_type]
        _default_container(task)
        _default_port(task)
    _default_dag_edges(job)
    _default_elastic(job)
    _default_min_members(job)
    return job


def _normalize_task_keys(job: TorchJob) -> None:
    """Case-normalize task-type keys (reference torchjob_defaults.go:33-45).
    Keys may arrive as raw strings from YAML."""
    normalized: Dict[TaskType, TaskSpec] = {}
    for key, task in job.spec.tasks.items():
        tt = key if isinstance(key, TaskType) else TaskType.normalize(str(key))
        normalized[tt] = task
    job.spec.tasks = normalized


def _default_container(task: TaskSpec) -> None:
    spec = task.template.spec
    if not spec.containers:
        spec.containers.append(Container(name=constants.DEFAULT_CONTAINER_NAME))
    for c in spec.containers:
        if not c.name:
            c.name = constants.DEFAULT_CONTAINER_NAME
        if not c.termination_message_policy:
            # Surface the last chunk of logs as the termination message so the
            # failover classifier has context (reference torchjob_defaults.go).
            c.termination_message_policy = "FallbackToLogsOnError"


def _default_port(task: TaskSpec) -> None:
    """Ensure the default container exposes the coordinator port
    (reference torchjob_defaults.go:150-178)."""
    container = task.template.spec.container(constants.DEFAULT_CONTAINER_NAME)
    if container is None:
        container = task.template.spec.containers[0]
    for p in container.ports:
        if p.name == constants.DEFAULT_PORT_NAME:
            return
    container.ports.append(
        ContainerPort(
            name=constants.DEFAULT_PORT_NAME,
            container_port=constants.DEFAULT_COORDINATOR_PORT,
        )
    )


def _default_dag_edges(job: TorchJob) -> None:
    """Inject default DAG edges AIMaster→Master→Worker
    (reference torchjob_defaults.go:95-124): Master waits for AIMaster Running,
    Worker waits for Master Running."""
    tasks = job.spec.tasks
    if TaskType.MASTER in tasks and TaskType.AIMASTER in tasks:
        if not tasks[TaskType.MASTER].dag_conditions:
            tasks[TaskType.MASTER].dag_conditions = [
                DAGCondition(upstream=TaskType.AIMASTER, on_phase="Running")
            ]
    if TaskType.WORKER in tasks:
        upstream = (
            TaskType.MASTER
            if TaskType.MASTER in tasks
            else (TaskType.AIMASTER if TaskType.AIMASTER in tasks else None)
        )
        if upstream is not None and not tasks[TaskType.WORKER].dag_conditions:
            tasks[TaskType.WORKER].dag_conditions = [
                DAGCondition(upstream=upstream, on_phase="Running")
            ]


def _default_elastic(job: TorchJob) -> None:
    """Clamp elastic bounds and worker count — snapped to slice-legal host
    quanta (the ElasticPolicy contract in types.py): e.g. min=3 on v5e becomes
    4, because no 3-host v5e topology exists."""
    ep = job.spec.elastic_policy
    if ep is None:
        return
    acc = job.spec.gpu_policy.accelerator
    ep.min_replicas = gpu_topology.snap_host_count(acc, max(ep.min_replicas, 1))
    if ep.max_replicas < ep.min_replicas:
        ep.max_replicas = ep.min_replicas
    else:
        # Largest legal quantum not exceeding the requested max.
        legal = [c for c in gpu_topology.legal_host_counts(acc)
                 if ep.min_replicas <= c <= ep.max_replicas]
        ep.max_replicas = legal[-1] if legal else ep.min_replicas
    worker = job.spec.tasks.get(TaskType.WORKER)
    if worker is not None:
        clamped = min(max(worker.num_tasks, ep.min_replicas), ep.max_replicas)
        worker.num_tasks = gpu_topology.snap_host_count(acc, clamped)
    if ep.nproc_per_node <= 0:
        # A "proc" is one host process driving that host's GPUs.
        ep.nproc_per_node = 1
    if not ep.rendezvous_backend:
        ep.rendezvous_backend = "c10d"


def _default_min_members(job: TorchJob) -> None:
    """Populate SchedulingPolicy.min_members for every task type (fixing the
    reference's no-op, torchjob_defaults.go:192-197). The slice rule: a slice is
    allocated atomically, so a task type whose pods form a slice defaults
    MinMember to the slice host count (SURVEY §2.8), while
    auxiliary types default to their full replica count."""
    policy = job.spec.run_policy.scheduling_policy
    if policy is None:
        policy = SchedulingPolicy()
        job.spec.run_policy.scheduling_policy = policy
    for task_type, task in job.spec.tasks.items():
        if task_type in policy.min_members:
            continue
        # Slices are allocated atomically and every task pod is a slice
        # host, so a partial gang is never useful: the gang floor is the full
        # replica count (covers num_slices > 1, where workers span all slices).
        policy.min_members[task_type] = task.num_tasks
