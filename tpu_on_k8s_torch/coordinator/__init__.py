"""Job coordinator (L4): multi-tenant queueing + plugin-driven admission,
and the capacity broker under it (the counterpart of
``tpu_on_k8s/coordinator/``).

Analog of pkg/coordinator/ (SURVEY §2.7). Tenant queues double as the
multi-slice coordination surface: each queue maps to a pool of 8-GPU hosts
and the smooth-WRR selector apportions dequeues across pools.

* ``types``: ``Code``, ``Status``, ``QueueUnit`` (one queued TorchJob) and
  the plugin protocols;
* ``queue``: ``Queue``, one tenant queue;
* ``policy``: the queue selectors, ``RoundRobinSelector`` and
  ``SmoothWeightedRoundRobinSelector``, over ``SmoothWRR``, the core the
  serving plane's tenant scheduler and version router reuse;
* ``plugins``: ``PluginConfig``, ``QuotaPlugin`` (tenant, filter and
  assumed-quota pre-dequeue) and ``PriorityPlugin``;
* ``core``: ``Coordinator``, the scheduling cycle;
* ``broker``: ``CapacityBroker``, the chip-capacity layer UNDER the queues:
  one slice market every consumer — serving fleets, elastic training, the
  warm floor, and the preemptible batch lane — bids on, cleared each tick
  with a degrade-before-take escalation ladder and every
  grant/preempt/refusal on the decision ledger.
"""

from tpu_on_k8s_torch.coordinator.broker import (
    KIND_BATCH,
    KIND_SERVING,
    KIND_TRAINING,
    KIND_WARM,
    PRIORITY_BATCH,
    PRIORITY_SERVING,
    PRIORITY_TRAINING,
    PRIORITY_WARM,
    Bid,
    CapacityBroker,
)
from tpu_on_k8s_torch.coordinator.core import (
    DEFAULT_SCHEDULING_PERIOD_SECONDS,
    Coordinator,
)
from tpu_on_k8s_torch.coordinator.plugins import (
    PluginConfig,
    PriorityPlugin,
    QuotaPlugin,
)
from tpu_on_k8s_torch.coordinator.policy import (
    RoundRobinSelector,
    SmoothWeightedRoundRobinSelector,
)
from tpu_on_k8s_torch.coordinator.queue import Queue
from tpu_on_k8s_torch.coordinator.types import Code, QueueUnit, Status
