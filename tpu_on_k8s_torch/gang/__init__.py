"""Gang scheduling: GPU-slice host topology and the PodGroup kind.

The GPU flavour of ``tpu_on_k8s/gang``: PodGroup MinMember derives from the
slice's host count (``tpu_on_k8s_torch.gang.topology``).
"""

from tpu_on_k8s_torch.gang.scheduler import PodGroup
from tpu_on_k8s_torch.gang.topology import (
    SliceShape,
    chips_in_topology,
    chips_per_host,
    hosts_per_slice,
    legal_host_counts,
    next_legal_host_count,
    topology_for_hosts,
)
