"""Storage providers: PV creation + pod volume injection per storage flavor.

Analog of pkg/storage/{interface.go,local_storage.go,nfs.go,
registry/registry.go}: the provider is picked by which field of the tagged
``Storage`` union is set (registry.go:36-44). GCS is new — the idiomatic artifact
store on GKE (mounted via GCS FUSE CSI in a real cluster; modeled as a
volume here).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import ObjectMeta, PodSpec, Volume, VolumeMount
from tpu_on_k8s_torch.api.model_types import ModelVersion, Storage


@dataclass
class PersistentVolumeSpec:
    """Flat internal fields; the wire hooks speak real core/v1
    PersistentVolumeSpec — ``capacity: {storage: "NGi"}``, nested
    ``hostPath``/``nfs`` sources, ``claimRef: {namespace, name}``,
    ``nodeAffinity`` for the local pin, and the GCS flavor as the GKE
    GCS-FUSE CSI source (``csi.driver: gcsfuse.csi.storage.gke.io``) — so a
    real apiserver accepts the ModelVersion pipeline's PVs instead of
    pruning them to empty specs."""

    capacity_gi: int = 10
    access_modes: list = field(default_factory=lambda: ["ReadWriteOnce"])
    host_path: Optional[str] = None
    node_name: Optional[str] = None  # node-affinity pin for local storage
    nfs_server: Optional[str] = None
    nfs_path: Optional[str] = None
    gcs_bucket: Optional[str] = None
    gcs_prefix: Optional[str] = None
    claim_ref: str = ""              # "namespace/name" of the bound claim

    _GCS_DRIVER = "gcsfuse.csi.storage.gke.io"

    @staticmethod
    def __wire_out__(d):
        out: dict = {"capacity": {"storage": f"{d.pop('capacityGi', 10)}Gi"}}
        if d.get("accessModes"):
            out["accessModes"] = d["accessModes"]
        if d.get("hostPath"):
            out["hostPath"] = {"path": d["hostPath"]}
        if d.get("nfsServer"):
            out["nfs"] = {"server": d["nfsServer"],
                          "path": d.get("nfsPath") or ""}
        if d.get("gcsBucket"):
            attrs = {}
            if d.get("gcsPrefix"):
                attrs["mountOptions"] = f"only-dir={d['gcsPrefix']}"
            out["csi"] = {"driver": PersistentVolumeSpec._GCS_DRIVER,
                          "volumeHandle": d["gcsBucket"],
                          **({"volumeAttributes": attrs} if attrs else {})}
        if d.get("claimRef"):
            ns, sep, name = d["claimRef"].partition("/")
            if not sep:                      # bare claim name, no namespace
                ns, name = "", ns
            out["claimRef"] = {**({"namespace": ns} if ns else {}),
                               "name": name,
                               "kind": "PersistentVolumeClaim",
                               "apiVersion": "v1"}
        if d.get("nodeName"):
            out["nodeAffinity"] = {"required": {"nodeSelectorTerms": [
                {"matchExpressions": [{"key": "kubernetes.io/hostname",
                                       "operator": "In",
                                       "values": [d["nodeName"]]}]}]}}
        return out

    @staticmethod
    def __wire_in__(d):
        if "capacity" not in d and "claimRef" not in d and \
                "nodeAffinity" not in d and not any(
                    isinstance(d.get(k), dict) for k in ("hostPath", "nfs",
                                                         "csi")):
            return d  # internal snake_case form
        out: dict = {}
        cap = d.get("capacity")
        if isinstance(cap, dict) and cap.get("storage"):
            out["capacity_gi"] = _parse_gi(cap["storage"])
        if d.get("accessModes"):
            out["access_modes"] = d["accessModes"]
        hp = d.get("hostPath")
        if isinstance(hp, dict):
            out["host_path"] = hp.get("path")
        nfs = d.get("nfs")
        if isinstance(nfs, dict):
            out["nfs_server"] = nfs.get("server")
            out["nfs_path"] = nfs.get("path")
        csi = d.get("csi")
        if isinstance(csi, dict) and \
                csi.get("driver") == PersistentVolumeSpec._GCS_DRIVER:
            out["gcs_bucket"] = csi.get("volumeHandle")
            mo = (csi.get("volumeAttributes") or {}).get("mountOptions", "")
            if mo.startswith("only-dir="):
                out["gcs_prefix"] = mo[len("only-dir="):]
        cr = d.get("claimRef")
        if isinstance(cr, dict):
            ns, name = cr.get("namespace", ""), cr.get("name", "")
            out["claim_ref"] = f"{ns}/{name}" if ns else name
        na = d.get("nodeAffinity")
        if isinstance(na, dict):
            try:
                expr = na["required"]["nodeSelectorTerms"][0][
                    "matchExpressions"][0]
                if expr.get("key") == "kubernetes.io/hostname":
                    out["node_name"] = expr["values"][0]
            except (KeyError, IndexError):
                pass
        return out


def _parse_gi(quantity) -> int:
    """Any k8s quantity → whole Gi ('10Gi'→10, '500Mi'→1, '1Ti'→1024).

    Delegates to serde's general quantity parser; floors at 1Gi since the
    internal fields are whole-Gi sizes."""
    from tpu_on_k8s_torch.utils.serde import _parse_quantity

    if isinstance(quantity, (int, float)):
        return max(1, round(float(quantity) / 2**30))
    return max(1, round(_parse_quantity(str(quantity)) / 2**30))


@dataclass
class PersistentVolume:
    api_version: str = "v1"
    kind: str = "PersistentVolume"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeSpec = field(default_factory=PersistentVolumeSpec)


@dataclass
class PersistentVolumeClaimStatus:
    phase: str = "Pending"  # Pending | Bound


@dataclass
class PersistentVolumeClaimSpec:
    """Wire hooks emit the conformant core/v1 shape: ``resources.requests.
    storage`` as a quantity and ``accessModes`` (required by real apiserver
    validation — a claim without them is rejected)."""

    volume_name: str = ""
    storage_gi: int = 10
    access_modes: list = field(default_factory=lambda: ["ReadWriteOnce"])

    @staticmethod
    def __wire_out__(d):
        out: dict = {
            "accessModes": d.get("accessModes") or ["ReadWriteOnce"],
            "resources": {"requests": {
                "storage": f"{d.get('storageGi', 10)}Gi"}},
        }
        if d.get("volumeName"):
            out["volumeName"] = d["volumeName"]
        return out

    @staticmethod
    def __wire_in__(d):
        res = d.get("resources")
        if not isinstance(res, dict):
            return d  # internal snake_case form
        out: dict = {"volume_name": d.get("volumeName") or ""}
        if d.get("accessModes"):
            out["access_modes"] = d["accessModes"]
        storage = (res.get("requests") or {}).get("storage")
        if storage is not None:
            out["storage_gi"] = _parse_gi(storage)
        return out


@dataclass
class PersistentVolumeClaim:
    api_version: str = "v1"
    kind: str = "PersistentVolumeClaim"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PersistentVolumeClaimSpec = field(default_factory=PersistentVolumeClaimSpec)
    status: PersistentVolumeClaimStatus = field(default_factory=PersistentVolumeClaimStatus)


class StorageProvider(Protocol):
    """Reference Storage interface (pkg/storage/interface.go:26-35)."""

    def create_persistent_volume(self, mv: ModelVersion, pv_name: str) -> PersistentVolume: ...
    def add_model_volume_to_pod_spec(self, mv: ModelVersion, spec: PodSpec) -> None: ...
    def get_model_mount_path(self, mv: ModelVersion) -> str: ...


def _mount(spec: PodSpec, volume: Volume, mount_path: str) -> None:
    if not any(v.name == volume.name for v in spec.volumes):
        spec.volumes.append(volume)
    for c in spec.containers:
        if not any(m.name == volume.name for m in c.volume_mounts):
            c.volume_mounts.append(VolumeMount(name=volume.name, mount_path=mount_path))


class LocalStorageProvider:
    """hostPath PV + node-affinity pin (reference local_storage.go:36-106)."""

    def create_persistent_volume(self, mv: ModelVersion, pv_name: str) -> PersistentVolume:
        ls = mv.spec.storage.local_storage
        return PersistentVolume(
            metadata=ObjectMeta(name=pv_name, namespace=""),
            spec=PersistentVolumeSpec(
                host_path=ls.path, node_name=ls.node_name,
                claim_ref=f"{mv.metadata.namespace}/{pv_name}"),
        )

    def add_model_volume_to_pod_spec(self, mv: ModelVersion, spec: PodSpec) -> None:
        ls = mv.spec.storage.local_storage
        _mount(spec, Volume(name="model-volume", host_path=ls.path),
               self.get_model_mount_path(mv))
        if ls.node_name:
            spec.node_name = ls.node_name

    def get_model_mount_path(self, mv: ModelVersion) -> str:
        return constants.DEFAULT_MODEL_PATH


class NFSProvider:
    """Reference nfs.go:37-90."""

    def create_persistent_volume(self, mv: ModelVersion, pv_name: str) -> PersistentVolume:
        nfs = mv.spec.storage.nfs
        return PersistentVolume(
            metadata=ObjectMeta(name=pv_name, namespace=""),
            spec=PersistentVolumeSpec(
                nfs_server=nfs.server, nfs_path=nfs.path,
                access_modes=["ReadWriteMany"],
                claim_ref=f"{mv.metadata.namespace}/{pv_name}"),
        )

    def add_model_volume_to_pod_spec(self, mv: ModelVersion, spec: PodSpec) -> None:
        nfs = mv.spec.storage.nfs
        _mount(spec, Volume(name="model-volume", nfs_server=nfs.server, nfs_path=nfs.path),
               self.get_model_mount_path(mv))

    def get_model_mount_path(self, mv: ModelVersion) -> str:
        return mv.spec.storage.nfs.mounted_path or constants.DEFAULT_MODEL_PATH


class GCSProvider:
    """GCS bucket (new): PV modeled as a bucket reference; in-cluster this is a
    GCS FUSE CSI volume."""

    def create_persistent_volume(self, mv: ModelVersion, pv_name: str) -> PersistentVolume:
        gcs = mv.spec.storage.gcs
        return PersistentVolume(
            metadata=ObjectMeta(name=pv_name, namespace=""),
            spec=PersistentVolumeSpec(
                gcs_bucket=gcs.bucket, gcs_prefix=gcs.prefix,
                access_modes=["ReadWriteMany"],
                claim_ref=f"{mv.metadata.namespace}/{pv_name}"),
        )

    def add_model_volume_to_pod_spec(self, mv: ModelVersion, spec: PodSpec) -> None:
        gcs = mv.spec.storage.gcs
        _mount(spec, Volume(name="model-volume", host_path=f"gcs://{gcs.bucket}/{gcs.prefix}"),
               self.get_model_mount_path(mv))

    def get_model_mount_path(self, mv: ModelVersion) -> str:
        return mv.spec.storage.gcs.mounted_path or constants.DEFAULT_MODEL_PATH


def provider_for_storage(storage: Storage) -> Optional[StorageProvider]:
    """Pick by set field (reference registry.go:36-44)."""
    if storage.local_storage is not None:
        return LocalStorageProvider()
    if storage.nfs is not None:
        return NFSProvider()
    if storage.gcs is not None:
        return GCSProvider()
    return None


def volume_for_storage(storage: Storage) -> Optional[Volume]:
    """The model-output volume injected into training pods
    (reference addModelPathEnv, controllers/common/job.go:557-581)."""
    if storage.local_storage is not None:
        return Volume(name="model-volume", host_path=storage.local_storage.path)
    if storage.nfs is not None:
        return Volume(name="model-volume", nfs_server=storage.nfs.server,
                      nfs_path=storage.nfs.path)
    if storage.gcs is not None:
        return Volume(name="model-volume",
                      host_path=f"gcs://{storage.gcs.bucket}/{storage.gcs.prefix}")
    return None
