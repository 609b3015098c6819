"""Model-artifact storage providers (reference pkg/storage/)."""

from tpu_on_k8s_torch.storage.providers import (
    GCSProvider,
    LocalStorageProvider,
    NFSProvider,
    PersistentVolume,
    PersistentVolumeClaim,
    PersistentVolumeClaimSpec,
    PersistentVolumeSpec,
    provider_for_storage,
    volume_for_storage,
)
