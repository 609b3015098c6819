"""Gang scheduling: atomic GPU-slice allocation.

The GPU flavour of ``tpu_on_k8s/gang``: PodGroup MinMember derives from the
slice's host count (``tpu_on_k8s_torch.gang.topology``, 8 GPUs a host).
"""

from tpu_on_k8s_torch.gang.scheduler import (
    GANG_SCHEDULER_NAME,
    GangRegistry,
    PodGroup,
    SliceGangAdmission,
    SliceGangScheduler,
    default_registry,
    podgroup_name,
)
from tpu_on_k8s_torch.gang.topology import (
    SliceShape,
    chips_in_topology,
    chips_per_host,
    hosts_per_slice,
    legal_host_counts,
    next_legal_host_count,
    topology_for_hosts,
)
