"""Cluster client layer (L2).

The reference generates a typed clientset + fake clientset from its CRDs
(client/, hack/update-codegen.sh). Here the same role is played by
a small hand-written client API (`ClusterClient`) with two backends:

* `InMemoryCluster` — a faithful in-process stand-in for the k8s API server
  (resource versions, conflicts, finalizers, deletionTimestamp, ownerRef cascade
  GC, label selection, watch events). This is both the test substrate (the
  reference's fake clientset analog) and the default runtime backend when no real
  cluster is configured.
* A real-cluster backend can implement the same `ClusterBackend` protocol over
  the k8s REST API; the controllers never know the difference.
"""

import tpu_on_k8s_torch.api  # noqa: F401  — anchors the api→defaults→gang→
                             # client import cycle so `import
                             # tpu_on_k8s_torch.client.*` works as the first
                             # framework import

from tpu_on_k8s_torch.client.cluster import (
    ApiError,
    ConflictError,
    ConflictRetriesExhausted,
    InMemoryCluster,
    NotFoundError,
    WatchEvent,
)
from tpu_on_k8s_torch.client.testing import KubeletLoop, KubeletSim
