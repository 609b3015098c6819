"""REST resource registry: kind ↔ (group, version, plural) ↔ Python class.

The reference gets this mapping from apimachinery scheme registration
(apis/add_types.go:25-37) plus the generated clientset's
per-resource REST paths (client/clientset/versioned/typed/train/v1alpha1/
torchjob.go). Here one explicit table serves both the API server's router
and the typed REST client.

Scoping matches real Kubernetes: PersistentVolume and PriorityClass are
cluster-scoped (no ``namespaces/{ns}`` path segment); everything else is
namespaced.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import (
    ConfigMap,
    Event,
    Pod,
    PriorityClass,
    ResourceQuota,
    Service,
)
from tpu_on_k8s_torch.api.crr import ContainerRecreateRequest
from tpu_on_k8s_torch.api.inference_types import InferenceService
from tpu_on_k8s_torch.api.model_types import Model, ModelVersion
from tpu_on_k8s_torch.api.types import TorchJob


@dataclass(frozen=True)
class ResourceType:
    kind: str
    cls: type
    group: str          # "" = core ("/api/v1")
    version: str
    plural: str
    namespaced: bool = True

    @property
    def prefix(self) -> str:
        if not self.group:
            return f"/api/{self.version}"
        return f"/apis/{self.group}/{self.version}"

    def collection_path(self, namespace: str) -> str:
        if not self.namespaced:
            return f"{self.prefix}/{self.plural}"
        return f"{self.prefix}/namespaces/{namespace}/{self.plural}"

    def item_path(self, namespace: str, name: str) -> str:
        return f"{self.collection_path(namespace)}/{name}"

    def all_namespaces_path(self) -> str:
        return f"{self.prefix}/{self.plural}"


def _build() -> Tuple[Dict[str, ResourceType], Dict[Tuple[str, str], ResourceType]]:
    # Imported lazily where needed to respect the api→gang→client cycle
    # anchored in client/__init__.py; these live outside tpu_on_k8s_torch.api.
    from tpu_on_k8s_torch.controller.leaderelection import Lease
    from tpu_on_k8s_torch.gang.scheduler import PodGroup
    from tpu_on_k8s_torch.storage.providers import (
        PersistentVolume,
        PersistentVolumeClaim,
    )

    job_group = constants.API_GROUP
    job_ver = constants.API_VERSION
    rows = [
        ResourceType("Pod", Pod, "", "v1", "pods"),
        ResourceType("Service", Service, "", "v1", "services"),
        ResourceType("ConfigMap", ConfigMap, "", "v1", "configmaps"),
        ResourceType("ResourceQuota", ResourceQuota, "", "v1", "resourcequotas"),
        ResourceType("Event", Event, "", "v1", "events"),
        ResourceType("PersistentVolume", PersistentVolume, "", "v1",
                     "persistentvolumes", namespaced=False),
        ResourceType("PersistentVolumeClaim", PersistentVolumeClaim, "", "v1",
                     "persistentvolumeclaims"),
        ResourceType("PriorityClass", PriorityClass, "scheduling.k8s.io", "v1",
                     "priorityclasses", namespaced=False),
        ResourceType("Lease", Lease, "coordination.k8s.io", "v1", "leases"),
        ResourceType("PodGroup", PodGroup, "scheduling.distributed.torch.io",
                     "v1beta1", "podgroups"),
        ResourceType("ContainerRecreateRequest", ContainerRecreateRequest,
                     "apps.distributed.torch.io", "v1alpha1",
                     "containerrecreaterequests"),
        ResourceType(constants.KIND_TORCHJOB, TorchJob, job_group, job_ver,
                     "torchjobs"),
        ResourceType(constants.KIND_MODEL, Model, job_group, job_ver, "models"),
        ResourceType(constants.KIND_MODELVERSION, ModelVersion, job_group,
                     job_ver, "modelversions"),
        ResourceType(constants.KIND_INFERENCESERVICE, InferenceService,
                     job_group, job_ver, "inferenceservices"),
    ]
    return ({r.kind: r for r in rows},
            {(r.group, r.plural): r for r in rows})


_BY_KIND: Optional[Dict[str, ResourceType]] = None
_BY_ROUTE: Optional[Dict[Tuple[str, str], ResourceType]] = None


def _ensure() -> None:
    global _BY_KIND, _BY_ROUTE
    if _BY_KIND is None:
        _BY_KIND, _BY_ROUTE = _build()


def by_kind(kind: str) -> ResourceType:
    _ensure()
    rt = _BY_KIND.get(kind)
    if rt is None:
        raise KeyError(f"unregistered kind {kind!r}")
    return rt


def by_class(cls: type) -> ResourceType:
    kind = cls.__dataclass_fields__["kind"].default  # type: ignore[attr-defined]
    return by_kind(kind)


def by_route(group: str, plural: str) -> Optional[ResourceType]:
    _ensure()
    return _BY_ROUTE.get((group, plural))


def all_types() -> list:
    _ensure()
    return list(_BY_KIND.values())
