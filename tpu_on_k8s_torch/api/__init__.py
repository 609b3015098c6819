"""API layer (L1): TorchJob / Model / ModelVersion types, constants and defaulting.

Mirrors the capability surface of the reference's ``apis/`` tree
(apis/train/v1alpha1/torchjob_types.go,
apis/model/v1alpha1/) in the GPU flavour of ``tpu_on_k8s/api``.
"""

from tpu_on_k8s_torch.api.core import (
    Condition,
    Container,
    ContainerPort,
    ContainerStateTerminated,
    ContainerStatus,
    EnvVar,
    ObjectMeta,
    OwnerReference,
    PodSpec,
    PodStatus,
    PodTemplateSpec,
    ResourceRequirements,
    Volume,
    VolumeMount,
)
from tpu_on_k8s_torch.api.types import (
    ElasticPolicy,
    JobCondition,
    JobConditionType,
    JobStatus,
    ReplicaStatus,
    RestartPolicy,
    RunPolicy,
    SchedulingPolicy,
    SpotTaskSpec,
    TaskSpec,
    TaskType,
    TorchJob,
    TorchJobSpec,
    GPUPolicy,
    ElasticStatus,
)
from tpu_on_k8s_torch.api.model_types import (
    Model,
    ModelSpec,
    ModelStatus,
    ModelVersion,
    ModelVersionSpec,
    ModelVersionStatus,
    Storage,
    LocalStorage,
    NFSStorage,
    GCSStorage,
)
from tpu_on_k8s_torch.api.defaults import set_defaults_torchjob
from tpu_on_k8s_torch.api import constants

__all__ = [
    "Condition", "Container", "ContainerPort", "ContainerStateTerminated",
    "ContainerStatus", "EnvVar", "ObjectMeta", "OwnerReference", "PodSpec",
    "PodStatus", "PodTemplateSpec", "ResourceRequirements", "Volume", "VolumeMount",
    "ElasticPolicy", "ElasticStatus", "JobCondition", "JobConditionType", "JobStatus",
    "ReplicaStatus", "RestartPolicy", "RunPolicy", "SchedulingPolicy", "SpotTaskSpec",
    "TaskSpec", "TaskType", "TorchJob", "TorchJobSpec", "GPUPolicy",
    "Model", "ModelSpec", "ModelStatus", "ModelVersion", "ModelVersionSpec",
    "ModelVersionStatus", "Storage", "LocalStorage", "NFSStorage", "GCSStorage",
    "set_defaults_torchjob", "constants",
]
