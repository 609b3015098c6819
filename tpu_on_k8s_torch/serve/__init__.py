"""The serving request plane over the port's engine: admission, fairness,
lifecycle, gateway, and the fleet layer above them.

Counterpart of ``tpu_on_k8s/serve/``. ``ContinuousBatchingEngine``
(``tpu_on_k8s_torch/models/serving.py``) is the compute plane; this
package is the layer between it and a service:

* ``admission``: bounded queue, load shedding, tenant token budgets,
  typed 429-style ``Rejected``;
* ``scheduler``: priority lanes and smooth-WRR tenant fairness;
* ``lifecycle``: request states, deadlines, cancellation, drain;
* ``gateway``: ``ServingGateway``, the single front door to one engine,
  with crash replay (``ReplayPolicy``);
* ``router``: prefix-affinity consistent hashing, bounded-load
  least-outstanding-tokens and weighted canary splits;
* ``health``: replica readiness (slow start) and liveness probes;
* ``fleet``: ``ServingFleet``, many replicas behind one routed front door,
  with ejection, cross-replica replay and zero-loss rolling rollouts;
* ``disagg``: ``DisaggFleet``, prefill and decode as separately scaled
  pools with a checksummed KV handoff between them;
* ``kvstore``: ``FleetPrefixStore``, a fleet-wide content-addressed
  prefix KV store with a host-RAM overflow tier;
* ``modelpool``: ``ModelPool``, several same-config models multiplexed
  over one engine by params swaps, LRU residency and a deterministic
  per-model-lane swap scheduler;
* ``cli``: the serving entry point, ``python -m tpu_on_k8s_torch.serve``
  (``main``).
"""
from tpu_on_k8s_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    Rejected,
)
from tpu_on_k8s_torch.serve.cli import main
from tpu_on_k8s_torch.serve.disagg import DisaggFleet, DisaggPool, PoolReplica
from tpu_on_k8s_torch.serve.fleet import (
    FleetRolloutPolicy,
    Replica,
    RolloutPhase,
    ServingFleet,
)
from tpu_on_k8s_torch.serve.gateway import ReplayPolicy, ServingGateway
from tpu_on_k8s_torch.serve.health import (
    HealthMonitor,
    ProbeConfig,
    ReplicaState,
)
from tpu_on_k8s_torch.serve.kvstore import FleetPrefixStore, prefix_hash
from tpu_on_k8s_torch.serve.lifecycle import (
    GatewayRequest,
    RequestResult,
    RequestState,
)
from tpu_on_k8s_torch.serve.modelpool import ModelPool
from tpu_on_k8s_torch.serve.router import Router
from tpu_on_k8s_torch.serve.scheduler import FairScheduler

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "DisaggFleet",
    "DisaggPool",
    "FairScheduler",
    "FleetPrefixStore",
    "FleetRolloutPolicy",
    "GatewayRequest",
    "PoolReplica",
    "prefix_hash",
    "HealthMonitor",
    "ModelPool",
    "ProbeConfig",
    "Rejected",
    "Replica",
    "ReplicaState",
    "ReplayPolicy",
    "RequestResult",
    "RequestState",
    "RolloutPhase",
    "Router",
    "ServingFleet",
    "ServingGateway",
    "main",
]
