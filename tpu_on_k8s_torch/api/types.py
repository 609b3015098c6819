"""TorchJob API types.

The GPU flavour of ``tpu_on_k8s/api/types.py`` (after the reference
operator's apis/train/v1alpha1/torchjob_types.go): a job is a map of
task-type → TaskSpec plus a RunPolicy, an ElasticPolicy and a GPUPolicy that
pins the job to a GPU slice shape. A *task* is a **host of a GPU slice**, so
replica counts are only legal in slice-topology quanta: free-form NumTasks
doubling (reference torchelastic job.go:102-104) is not allowed here; see
``tpu_on_k8s_torch.gang.topology``.
"""
from __future__ import annotations

import datetime as _dt
import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import ObjectMeta, PodTemplateSpec
from tpu_on_k8s_torch.api.model_types import ModelVersionSpec


class TaskType(str, enum.Enum):
    """Reference torchjob_types.go:34-42. AIMaster is an optional user-supplied
    controller task that coordinates checkpoints for elastic scaling."""

    AIMASTER = "AIMaster"
    MASTER = "Master"
    WORKER = "Worker"

    @classmethod
    def normalize(cls, raw: str) -> "TaskType":
        """Case-insensitive task-type normalization (reference defaulting step 1,
        torchjob_defaults.go:33-45)."""
        for t in cls:
            if t.value.lower() == raw.lower():
                return t
        raise ValueError(f"unknown task type {raw!r}")


class RestartPolicy(str, enum.Enum):
    """Reference torchjob_types.go:64-74. ON_EXIT_CODE defers restart decisions to
    the exit-code classifier in ``tpu_on_k8s_torch.controller.failover``."""

    ALWAYS = "Always"
    ON_FAILURE = "OnFailure"
    NEVER = "Never"
    ON_EXIT_CODE = "OnExitCode"


class CleanPodPolicy(str, enum.Enum):
    RUNNING = "Running"  # delete only still-running pods at job end
    ALL = "All"
    NONE = "None"


class JobConditionType(str, enum.Enum):
    """Job lifecycle FSM states (reference torchjob_types.go:226-239 + utils)."""

    CREATED = "Created"
    QUEUING = "Queuing"
    RUNNING = "Running"
    RESTARTING = "Restarting"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclass
class DAGCondition:
    """Gate creating a task type until an upstream type reaches a phase
    (reference torchjob_types.go:79-84; evaluated by controller.dag)."""

    upstream: TaskType = TaskType.MASTER
    on_phase: str = "Running"


@dataclass
class SpotTaskSpec:
    """Subset of a task's replicas to run at spot priority
    (reference torchjob_types.go SpotTaskSpec; applied in pod creation)."""

    num_spot_tasks: int = 0
    priority_class_name: str = ""
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class TaskSpec:
    """One task type's replica group (reference torchjob_types.go:88-104)."""

    num_tasks: int = 1
    restart_policy: Optional[RestartPolicy] = None
    template: PodTemplateSpec = field(default_factory=PodTemplateSpec)
    spot_task_spec: Optional[SpotTaskSpec] = None
    dag_conditions: List[DAGCondition] = field(default_factory=list)


@dataclass
class SchedulingPolicy:
    """Gang/queue knobs (reference torchjob_types.go:120-135)."""

    min_available: Optional[int] = None
    queue: str = ""
    priority: Optional[int] = None
    priority_class_name: str = ""
    min_members: Dict[TaskType, int] = field(default_factory=dict)


@dataclass
class RunPolicy:
    """Lifecycle policy (reference torchjob_types.go:139-154)."""

    clean_pod_policy: CleanPodPolicy = CleanPodPolicy.RUNNING
    ttl_seconds_after_finished: Optional[int] = None
    active_deadline_seconds: Optional[int] = None
    backoff_limit: Optional[int] = None
    scheduling_policy: Optional[SchedulingPolicy] = None


@dataclass
class ElasticPolicy:
    """Elastic-training policy (reference TorchElasticPolicy,
    torchjob_types.go:160-173). Min/max replicas are expressed in *hosts*
    and must land on slice-legal quanta; an explicit rendezvous
    backend/endpoint may be given. The default backend is torchrun's
    ``c10d`` (the reference operator's, torchjob_controller.go:385-417):
    torchrun has no ``xla`` backend, the JAX package's default."""

    min_replicas: int = 1
    max_replicas: int = 1
    rendezvous_backend: str = "c10d"
    rendezvous_endpoint: str = ""
    nproc_per_node: int = 1
    max_restarts: Optional[int] = None
    # live mesh reconfiguration (tpu_on_k8s_torch/parallel/reshard.py): rescale
    # decisions are delivered to the pods as (hosts, mesh shape) reshard
    # requests — training state transforms in place and the run never
    # exits; a failed transform falls back to the checkpoint-restart path
    live_reshard: bool = False


@dataclass
class GPUPolicy:
    """GPU slice binding. Drives ``nvidia.com/gpu`` resource requests, the
    GKE accelerator nodeSelector, and gang MinMember (= slice host count)."""

    accelerator: str = "nvidia-h100-80gb"  # GKE gke-accelerator value
    topology: str = "2x8"                  # hosts x GPUs (gang/topology.py)
    num_slices: int = 1                    # >1 => several slices in one job


@dataclass
class JobCondition:
    type: JobConditionType = JobConditionType.CREATED
    status: str = "True"
    reason: str = ""
    message: str = ""
    last_transition_time: Optional[_dt.datetime] = None
    last_update_time: Optional[_dt.datetime] = None


@dataclass
class ReplicaStatus:
    """Per-task-type counts (reference TaskStatus)."""

    active: int = 0
    ready: int = 0
    succeeded: int = 0
    failed: int = 0
    evicted: int = 0


@dataclass
class ElasticStatus:
    """Per-task-type elastic observation record (reference TorchElasticStatus,
    torchjob_types.go:276-289)."""

    replicas: int = 0
    last_replicas: int = 0
    continue_scaling: bool = False
    message: str = ""
    current_latency: float = 0.0
    last_latency: float = 0.0
    start_time: Optional[_dt.datetime] = None
    last_update_time: Optional[_dt.datetime] = None


@dataclass
class JobStatus:
    """Reference torchjob_types.go:295-310."""

    conditions: List[JobCondition] = field(default_factory=list)
    task_statuses: Dict[TaskType, ReplicaStatus] = field(default_factory=dict)
    start_time: Optional[_dt.datetime] = None
    completion_time: Optional[_dt.datetime] = None
    elastic_statuses: Dict[TaskType, ElasticStatus] = field(default_factory=dict)
    model_version_name: str = ""


@dataclass
class TorchJobSpec:
    tasks: Dict[TaskType, TaskSpec] = field(default_factory=dict)
    run_policy: RunPolicy = field(default_factory=RunPolicy)
    elastic_policy: Optional[ElasticPolicy] = None
    gpu_policy: GPUPolicy = field(default_factory=GPUPolicy)
    # ModelVersion template: when set, task pods get the model volume + path env
    # and a ModelVersion is emitted on success (reference TorchJobSpec's embedded
    # model output spec; controllers/common/job.go:465-508,557-581).
    model_version: Optional[ModelVersionSpec] = None


@dataclass
class TorchJob:
    api_version: str = f"{constants.API_GROUP}/{constants.API_VERSION}"
    kind: str = constants.KIND_TORCHJOB
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: TorchJobSpec = field(default_factory=TorchJobSpec)
    status: JobStatus = field(default_factory=JobStatus)


def extract_meta_fields(job: TorchJob):
    """(tasks, status, scheduling_policy) for the generic engine/coordinator
    (reference apis/train/v1alpha1/common.go:45-55)."""
    return job.spec.tasks, job.status, job.spec.run_policy.scheduling_policy
