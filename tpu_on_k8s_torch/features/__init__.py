"""Feature gates (reference pkg/features/features.go:30-63)."""

from tpu_on_k8s_torch.features.features import FeatureGates, default_gates, gates
