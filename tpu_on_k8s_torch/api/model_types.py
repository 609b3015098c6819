"""Model / ModelVersion API types.

Analog of apis/model/v1alpha1/{model_types.go,modelversion_types.go}:
a ``Model`` names a trained model and points at its latest version; a
``ModelVersion`` is one trained artifact with a storage binding and an OCI image
build status. Storage adds GCS (the default on GCP) alongside the
reference's NFS/LocalStorage.
"""
from __future__ import annotations

import datetime as _dt
import enum
from dataclasses import dataclass, field
from typing import Optional

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import ObjectMeta


@dataclass
class LocalStorage:
    """hostPath-backed storage pinned to one node
    (reference modelversion_types.go:26-56 / pkg/storage/local_storage.go)."""

    path: str = ""
    node_name: str = ""


@dataclass
class NFSStorage:
    server: str = ""
    path: str = ""
    mounted_path: str = ""


@dataclass
class GCSStorage:
    """GCS bucket storage (new; idiomatic for GKE artifacts)."""

    bucket: str = ""
    prefix: str = ""
    mounted_path: str = ""


@dataclass
class Storage:
    """Tagged union — exactly one provider field set
    (reference Storage struct; provider picked by which field is non-nil,
    pkg/storage/registry/registry.go:36-44)."""

    local_storage: Optional[LocalStorage] = None
    nfs: Optional[NFSStorage] = None
    gcs: Optional[GCSStorage] = None


class ImageBuildPhase(str, enum.Enum):
    BUILDING = "ImageBuilding"
    FAILED = "ImageBuildFailed"
    SUCCEEDED = "ImageBuildSucceeded"


@dataclass
class ModelSpec:
    description: str = ""


@dataclass
class ModelStatus:
    latest_version_name: str = ""
    latest_image: str = ""


@dataclass
class Model:
    api_version: str = f"{constants.API_GROUP}/{constants.API_VERSION}"
    kind: str = constants.KIND_MODEL
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ModelSpec = field(default_factory=ModelSpec)
    status: ModelStatus = field(default_factory=ModelStatus)


@dataclass
class ModelVersionSpec:
    """Reference modelversion_types.go:59-79."""

    model_name: str = ""
    created_by: str = ""  # the TorchJob that produced this artifact
    storage: Storage = field(default_factory=Storage)
    image_repo: str = ""
    image_tag: str = ""


@dataclass
class ModelVersionStatus:
    """Reference modelversion_types.go:83-101."""

    image: str = ""
    image_build_phase: Optional[ImageBuildPhase] = None
    message: str = ""
    finish_time: Optional[_dt.datetime] = None


@dataclass
class ModelVersion:
    api_version: str = f"{constants.API_GROUP}/{constants.API_VERSION}"
    kind: str = constants.KIND_MODELVERSION
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ModelVersionSpec = field(default_factory=ModelVersionSpec)
    status: ModelVersionStatus = field(default_factory=ModelVersionStatus)
