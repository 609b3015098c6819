"""Core object model: the slice of corev1/metav1 the framework needs.

The reference imports k8s.io/api/core/v1 wholesale; this framework only touches a
narrow surface (pods, services, env, volumes, resource lists), so that surface is
defined here as plain dataclasses. Everything round-trips through
``tpu_on_k8s_torch.utils.serde`` — no generated code.
"""
from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tpu_on_k8s_torch.utils import serde


def utcnow() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False
    block_owner_deletion: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    finalizers: List[str] = field(default_factory=list)
    owner_references: List[OwnerReference] = field(default_factory=list)
    creation_timestamp: Optional[_dt.datetime] = None
    deletion_timestamp: Optional[_dt.datetime] = None
    generation: int = 0
    resource_version: int = 0

    def controller_ref(self) -> Optional[OwnerReference]:
        for ref in self.owner_references:
            if ref.controller:
                return ref
        return None


@dataclass
class EnvVarSource:
    """Downward-API field reference. The reference uses
    ``fieldRef: metadata.annotations['distributed.io/world-size']`` so an in-place
    restarted container observes the *new* world size
    (controllers/train/torchjob_controller.go:419-439).

    Wire shape is core/v1's ``valueFrom: {fieldRef: {fieldPath: ...}}``
    nesting (the flat form is internal only)."""

    field_path: str = ""

    @staticmethod
    def __wire_out__(d: Dict[str, object]) -> Dict[str, object]:
        fp = d.pop("fieldPath", None)
        return {"fieldRef": {"fieldPath": fp}} if fp else d

    @staticmethod
    def __wire_in__(d: Dict[str, object]) -> Dict[str, object]:
        fr = d.get("fieldRef")
        if isinstance(fr, dict) and "fieldPath" in fr:
            d = dict(d)
            d["field_path"] = fr["fieldPath"]
        return d


@dataclass
class EnvVar:
    name: str = ""
    value: str = ""
    value_from: Optional[EnvVarSource] = None


@dataclass
class ContainerPort:
    name: str = ""
    container_port: int = 0
    host_port: int = 0


@dataclass
class ResourceRequirements:
    """Resource requests/limits as plain quantity maps.

    Quantities are numeric (chips, cores, bytes) rather than k8s quantity strings —
    the GPU resource key is ``nvidia.com/gpu`` (GPUs per host).
    """

    requests: Dict[str, float] = field(default_factory=dict)
    limits: Dict[str, float] = field(default_factory=dict)


@dataclass
class VolumeMount:
    name: str = ""
    mount_path: str = ""
    read_only: bool = False


@dataclass
class Volume:
    """Tagged-union volume source: exactly one of the source fields is set.
    ``items`` maps source keys to file paths under the mount (configmap/secret
    projections, e.g. ``.dockerconfigjson`` → ``config.json``)."""

    name: str = ""
    host_path: Optional[str] = None
    nfs_server: Optional[str] = None
    nfs_path: Optional[str] = None
    pvc_claim_name: Optional[str] = None
    config_map_name: Optional[str] = None
    secret_name: Optional[str] = None
    empty_dir: bool = False
    items: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def __wire_out__(d: Dict[str, object]) -> Dict[str, object]:
        """Emit core/v1's nested volume sources (``hostPath: {path}``,
        ``nfs: {server, path}``, ``persistentVolumeClaim: {claimName}``, …) —
        a real apiserver rejects the internal flat-string form."""
        items = d.pop("items", None) or {}
        wire_items = [{"key": k, "path": p} for k, p in items.items()]
        out: Dict[str, object] = {"name": d.get("name", "")}
        if d.get("hostPath"):
            out["hostPath"] = {"path": d["hostPath"]}
        if d.get("nfsServer"):
            out["nfs"] = {"server": d["nfsServer"],
                          "path": d.get("nfsPath") or ""}
        if d.get("pvcClaimName"):
            out["persistentVolumeClaim"] = {"claimName": d["pvcClaimName"]}
        if d.get("configMapName"):
            cm: Dict[str, object] = {"name": d["configMapName"]}
            if wire_items:
                cm["items"] = wire_items
            out["configMap"] = cm
        if d.get("secretName"):
            sec: Dict[str, object] = {"secretName": d["secretName"]}
            if wire_items:
                sec["items"] = wire_items
            out["secret"] = sec
        if d.get("emptyDir"):
            out["emptyDir"] = {}
        return out

    @staticmethod
    def __wire_in__(d: Dict[str, object]) -> Dict[str, object]:
        sources = ("hostPath", "nfs", "persistentVolumeClaim", "configMap",
                   "secret", "emptyDir")
        if not any(k in d for k in sources):
            return d  # internal snake_case / legacy flat form
        out: Dict[str, object] = {"name": d.get("name", "")}
        hp = d.get("hostPath")
        out["host_path"] = hp.get("path") if isinstance(hp, dict) else hp
        nfs = d.get("nfs")
        if isinstance(nfs, dict):
            out["nfs_server"] = nfs.get("server")
            out["nfs_path"] = nfs.get("path")
        pvc = d.get("persistentVolumeClaim")
        if isinstance(pvc, dict):
            out["pvc_claim_name"] = pvc.get("claimName")
        items = None
        cm = d.get("configMap")
        if isinstance(cm, dict):
            out["config_map_name"] = cm.get("name")
            items = cm.get("items")
        sec = d.get("secret")
        if isinstance(sec, dict):
            out["secret_name"] = sec.get("secretName")
            items = items or sec.get("items")
        ed = d.get("emptyDir")
        out["empty_dir"] = True if isinstance(ed, dict) else bool(ed)
        if isinstance(items, list):
            out["items"] = {e["key"]: e["path"] for e in items}
        elif isinstance(d.get("items"), dict):
            out["items"] = d["items"]
        return out


@dataclass
class Container:
    name: str = ""
    image: str = ""
    command: List[str] = field(default_factory=list)
    args: List[str] = field(default_factory=list)
    env: List[EnvVar] = field(default_factory=list)
    ports: List[ContainerPort] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    volume_mounts: List[VolumeMount] = field(default_factory=list)
    working_dir: str = ""
    termination_message_policy: str = ""

    def env_map(self) -> Dict[str, str]:
        return {e.name: e.value for e in self.env}

    def set_env(self, name: str, value: str = "", value_from: Optional[EnvVarSource] = None) -> None:
        for e in self.env:
            if e.name == name:
                e.value, e.value_from = value, value_from
                return
        self.env.append(EnvVar(name=name, value=value, value_from=value_from))


@dataclass
class PodSpec:
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    restart_policy: str = "Never"  # pod-level: Never|OnFailure|Always
    node_selector: Dict[str, str] = field(default_factory=dict)
    scheduler_name: str = ""
    priority_class_name: str = ""
    priority: Optional[int] = None
    host_network: bool = False
    hostname: str = ""
    subdomain: str = ""
    node_name: str = ""
    volumes: List[Volume] = field(default_factory=list)

    def container(self, name: str) -> Optional[Container]:
        for c in self.containers:
            if c.name == name:
                return c
        return None

    def default_container(self) -> Optional[Container]:
        """The conventional main container ("torch"), falling back to the first
        (single shared lookup — the reference re-implemented this scan in three
        places, one with an index bug, hostnetwork.go:54-62)."""
        from tpu_on_k8s_torch.api import constants  # late: constants has no deps

        return self.container(constants.DEFAULT_CONTAINER_NAME) or (
            self.containers[0] if self.containers else None
        )

    def coordinator_port(self) -> int:
        """The declared coordinator port of the default container, or the
        framework default."""
        from tpu_on_k8s_torch.api import constants

        c = self.default_container()
        if c is not None:
            for p in c.ports:
                if p.name == constants.DEFAULT_PORT_NAME:
                    return p.container_port
        return constants.DEFAULT_COORDINATOR_PORT


@dataclass
class ContainerStateTerminated:
    exit_code: int = 0
    reason: str = ""
    message: str = ""


@dataclass
class ContainerStatus:
    name: str = ""
    ready: bool = False
    restart_count: int = 0
    terminated: Optional[ContainerStateTerminated] = None

    @staticmethod
    def __wire_out__(d: Dict[str, object]) -> Dict[str, object]:
        """core/v1 nests termination under ``state: {terminated: {...}}``;
        the flat ``terminated`` is internal only."""
        t = d.pop("terminated", None)
        if t is not None:
            d["state"] = {"terminated": t}
        return d

    @staticmethod
    def __wire_in__(d: Dict[str, object]) -> Dict[str, object]:
        st = d.get("state")
        if (isinstance(st, dict) and "terminated" not in d
                and st.get("terminated") is not None):
            d = dict(d)
            d["terminated"] = st["terminated"]
        return d


@dataclass
class Condition:
    type: str = ""
    status: str = "True"  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: Optional[_dt.datetime] = None


class PodPhase:
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    UNKNOWN = "Unknown"

    ORDER = {PENDING: 0, RUNNING: 1, SUCCEEDED: 2, FAILED: 3, UNKNOWN: 4}


@dataclass
class PodStatus:
    phase: str = PodPhase.PENDING
    reason: str = ""
    message: str = ""
    pod_ip: str = ""
    host_ip: str = ""
    start_time: Optional[_dt.datetime] = None
    conditions: List[Condition] = field(default_factory=list)
    container_statuses: List[ContainerStatus] = field(default_factory=list)

    def is_ready(self) -> bool:
        return any(c.type == "Ready" and c.status == "True" for c in self.conditions)


@dataclass
class PodTemplateSpec:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)


@dataclass
class Pod:
    api_version: str = "v1"
    kind: str = "Pod"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)


@dataclass
class ServicePort:
    name: str = ""
    port: int = 0
    target_port: int = 0


@dataclass
class ServiceSpec:
    cluster_ip: str = ""  # "None" => headless
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)


@dataclass
class Service:
    api_version: str = "v1"
    kind: str = "Service"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ServiceSpec = field(default_factory=ServiceSpec)


@dataclass
class ResourceQuotaSpec:
    hard: Dict[str, float] = field(default_factory=dict)


@dataclass
class ResourceQuotaStatus:
    used: Dict[str, float] = field(default_factory=dict)


@dataclass
class ResourceQuota:
    """Namespace resource budget — the quota surface the coordinator's quota
    plugin sums (reference plugins/quota.go:97-131)."""

    api_version: str = "v1"
    kind: str = "ResourceQuota"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ResourceQuotaSpec = field(default_factory=ResourceQuotaSpec)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)


@dataclass
class ConfigMap:
    """Plain key→value config object (the model pipeline's dockerfile carrier,
    reference modelversion_controller.go:286-311)."""

    api_version: str = "v1"
    kind: str = "ConfigMap"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class PriorityClass:
    """Priority class value source for the coordinator's priority plugin
    (reference plugins/priority.go:74-87)."""

    api_version: str = "scheduling.k8s.io/v1"
    kind: str = "PriorityClass"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0


@dataclass
class ObjectReference:
    """core/v1 ObjectReference (the involvedObject of an Event)."""

    api_version: str = ""
    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Event:
    """Real core/v1 Event object (reference record.EventRecorder emits these;
    round 2 stored ad-hoc tuples — a conformant apiserver only accepts this
    shape)."""

    api_version: str = "v1"
    kind: str = "Event"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    type: str = "Normal"          # Normal | Warning
    reason: str = ""
    message: str = ""
    count: int = 1
    first_timestamp: Optional[_dt.datetime] = None
    last_timestamp: Optional[_dt.datetime] = None
    reporting_component: str = "tpu-on-k8s-manager"


def deep_copy(obj):
    return serde.deep_copy(obj)
