"""The port's serving autoscaler (``controller/fleetautoscaler.py`` over
``autoscale/`` and ``ServingFleet.scale_to``) against the reference on the
CPU.

``tests/test_autoscale.py``'s serving cases run against the port through
``test_torch_api.reference_cases``, on the port's engines built from the
reference's tiny parameters (``TransformerConfig.tiny()`` in fp32,
``max_seq_len`` 64, initialised by the JAX package from key 1 and carried
across with ``from_jax_params``; the harness of
``test_torch_serve_gateway.make_setup``):

* ``TestFleetScaleTo``: scale-up slow starts, scale-down drains and reaps
  with zero loss, backlog rebalancing, the refusal mid-rollout, reclaimed
  draining victims, queued eviction order, the windowed observation line;
* ``TestClosedLoopE2E``: the seeded bursty trace through ``ServingFleet``
  and ``FleetAutoscaler`` on a fake clock (up, then back down, slice-legal
  targets on 8-GPU hosts, cooldowns and the flap guard, byte-identical
  decision logs across runs, ``autoscale_under_crash``, the failed patch
  that burns no cooldown);
* ``TestCRDPlane``: observation lines in replica pod logs → the
  ``spec.replicas`` patch → the InferenceService reconciler's replica
  gangs, the per-pod watermarks, the sequence across an outage;
* ``test_autoscale_metrics_exposition`` and
  ``TestSignals.test_scraper_reads_deltas_only`` (the rest of
  ``TestSignals``, with ``TestPolicy``, runs in
  ``tests/test_torch_loopkernel.py``).

The reference's module imports the JAX models for its fixture; here the
fixture is the port's, and its engine factory serves on the CPU.
``tests/test_torch_autoscale_diff.py`` holds the closed loop against the
JAX package's, decision log for decision log.
"""
from __future__ import annotations

import pytest
import torch

from test_torch_api import reference_cases, slice_literals
from test_torch_serve_gateway import make_setup, port_config

torch.set_num_threads(1)

#: the reference's metrics module and chaos package are one module each
#: in the port
METRICS = (r"tpu_on_k8s_torch\.metrics\.metrics\b", "tpu_on_k8s_torch.metrics")
SCENARIOS = (r"from tpu_on_k8s_torch\.chaos import scenarios",
             "from tpu_on_k8s_torch import chaos as scenarios")
CHAOS = (r"from tpu_on_k8s import chaos", "from tpu_on_k8s_torch import chaos")
#: the port's engines serve on the CPU here (their default is the card)
CPU_ENGINE = (r"ContinuousBatchingEngine\(cfg, params, n_slots=n_slots\)",
              'ContinuousBatchingEngine(cfg, params, n_slots=n_slots, '
              'device="cpu")')
SUBS = (slice_literals, METRICS, SCENARIOS, CHAOS, CPU_ENGINE)
#: what this file runs of the reference's module
CASES = ("TestFleetScaleTo", "TestClosedLoopE2E", "TestCRDPlane",
         "test_autoscale_metrics_exposition", "TestSignals")

_cases = reference_cases("test_autoscale", only=CASES, subs=SUBS)
_cases.pop("setup")                 # the reference's JAX fixture
globals().update(_cases)
for _name in [n for n in vars(TestSignals) if n.startswith("test_")
              and n != "test_scraper_reads_deltas_only"]:
    delattr(TestSignals, _name)


@pytest.fixture(scope="module")
def setup():
    """The reference fixture's model in the port: the config and the
    parameters the JAX package initialises from key 1."""
    planes = make_setup({"v1": 1})
    return port_config(planes.cfg), planes.port.trees["v1"]


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert set(CASES) <= names
    assert [n for n in vars(TestSignals) if n.startswith("test_")] == [
        "test_scraper_reads_deltas_only"]
    assert {"test_burst_scales_up_then_down",
            "test_autoscale_under_crash_converges_without_thrash",
            "test_failed_patch_burns_no_cooldown"} <= set(vars(TestClosedLoopE2E))
