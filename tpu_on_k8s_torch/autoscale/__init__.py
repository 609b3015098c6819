"""Autoscaling's signals and policy (the counterpart of
``tpu_on_k8s/autoscale/``):

* `signals` — windowed aggregation of per-replica gateway/fleet metrics
  (TTFT p95, queue-wait p95, queue depth, tokens-in-flight per slot)
  into a ``FleetObservation``, with an explicit staleness bit so a dead
  scrape is "no data", never "zero load";
* `policy`  — ``Recommender``: a deterministic target-tracking policy
  (SLO targets + utilization band) producing **slice-legal** replica
  targets via `gang/topology.next_legal_host_count`, with hysteresis,
  separate up/down cooldowns, flap damping, bounded step size, and a
  ``min_warm`` warm floor.

Execution lives in `controller/fleetautoscaler.FleetAutoscaler`, the
second control loop over the ``InferenceService`` CRD: it patches
``spec.replicas`` and lets the reconciler's surge/drain machinery (and,
in-process, ``ServingFleet.scale_to``) do the rest. Training replicas
scale elastically through `controller/autoscaler.ElasticAutoscaler`, which
shares ``Decision`` and the ``ACTION_*`` vocabulary with the policy.
"""
from tpu_on_k8s_torch.autoscale.policy import (
    ACTION_DOWN,
    ACTION_HOLD,
    ACTION_UP,
    Decision,
    Recommender,
)
from tpu_on_k8s_torch.autoscale.signals import (
    NO_DATA,
    FleetObservation,
    FleetSample,
    FleetScraper,
    SignalAggregator,
    dead_sample,
    line_watermark,
    sample_from_line,
)

__all__ = [
    "ACTION_DOWN",
    "ACTION_HOLD",
    "ACTION_UP",
    "Decision",
    "FleetObservation",
    "FleetSample",
    "FleetScraper",
    "NO_DATA",
    "Recommender",
    "SignalAggregator",
    "dead_sample",
    "line_watermark",
    "sample_from_line",
]
