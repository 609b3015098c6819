"""The port's control-loop kernel (``controller/loopkernel.py``), decision
ledger (``obs/ledger.py``, ``obs/dumpio.py``) and autoscaling policy
(``autoscale/policy.py``, ``autoscale/signals.py``) against the reference
on the CPU.

The reference's test modules run against the port through
``test_torch_api.reference_cases``:

* from ``tests/test_ledger.py``: ``TestDecisionLineSerde``,
  ``TestDecisionLedger`` (but ``test_metrics_feed``, which tests
  ``LedgerMetrics``, the coordinator's slice), ``TestCooldownGate``,
  ``TestLoopKernel``, ``TestElasticLedger`` (the elastic autoscaler's
  decisions through the kernel, on ``tests/test_autoscaler.py``'s
  helpers run against the port) and ``TestFleetAutoscalerLedger`` (the
  serving autoscaler's decisions, commits, chaos triggers, abandoned
  horizons and SLO-page chains through the kernel, on the port's fleet of
  engines built from the reference fixture's tiny parameters). Until the
  coordinator's slice ports ``LedgerMetrics``, the ledger's metrics sink
  in those cases is the reference's class (duck-typed: ``inc`` and
  ``set_gauge``);
* from ``tests/test_autoscale.py``: ``TestPolicy`` (the ``Recommender`` on
  legal host counts of 8-GPU hosts) and ``TestSignals`` but
  ``test_scraper_reads_deltas_only``, which runs with the serving cases in
  ``tests/test_torch_autoscale.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_api import reference_cases, slice_literals
from test_torch_autoscale import CHAOS, METRICS
from test_torch_elastic import port_module
from test_torch_serve_gateway import port_config
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s_torch.models import params as pparams

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

#: ``LedgerMetrics`` comes with the coordinator's slice: the reference's
#: class stands in as the ledger's metrics sink until then
LEDGER_METRICS = (r"from tpu_on_k8s_torch\.metrics\.metrics import "
                  r"LedgerMetrics",
                  "from tpu_on_k8s.metrics.metrics import LedgerMetrics")
#: the reference's chaos package is one module in the port
SCENARIOS = (r"from tpu_on_k8s_torch\.chaos import scenarios",
             "from tpu_on_k8s_torch import chaos as scenarios")
#: the fleet's engines serve on the CPU here (their default is the card)
CPU_ENGINE = (r"ContinuousBatchingEngine\(cfg, params, n_slots=2, "
              r"max_len=32,",
              'ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=32, '
              'device="cpu",')

# the helpers TestElasticLedger takes from tests/test_autoscaler.py
reference_cases("test_autoscaler", only=(), subs=(slice_literals,))
_ledger = reference_cases(
    "test_ledger",
    only=("TestDecisionLineSerde", "TestDecisionLedger", "TestCooldownGate",
          "TestLoopKernel", "TestElasticLedger", "TestFleetAutoscalerLedger"),
    skip=("TestDecisionLedger.test_metrics_feed",),
    subs=(slice_literals, LEDGER_METRICS, METRICS, SCENARIOS, CHAOS,
          CPU_ENGINE, port_module("test_autoscaler")))
_ledger.pop("tiny")                 # the reference's JAX fixture
globals().update(_ledger)
globals().update(reference_cases(
    "test_autoscale", only=("TestPolicy", "TestSignals"),
    skip=("TestSignals.test_scraper_reads_deltas_only",),
    subs=(slice_literals, METRICS, SCENARIOS, CHAOS)))


@pytest.fixture(scope="module")
def tiny():
    """``tests/test_ledger.py``'s fixture in the port: the tiny fp32 model
    the JAX package initialises from key 0, carried across."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               max_seq_len=64)
    probe = jax.random.randint(jax.random.key(1), (1, 8), 0,
                               jcfg.vocab_size, jnp.int32)
    tree = JTransformer(jcfg).init(jax.random.key(0), probe)["params"]
    return port_config(jcfg), pparams.from_jax_params(
        jax.tree.map(np.asarray, tree), device="cpu")


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestDecisionLineSerde", "TestDecisionLedger", "TestCooldownGate",
            "TestLoopKernel", "TestElasticLedger", "TestFleetAutoscalerLedger",
            "TestPolicy", "TestSignals"} <= names
    assert not hasattr(TestDecisionLedger, "test_metrics_feed")
    assert hasattr(TestDecisionLedger, "test_monotone_seq_and_deterministic_dump")


def test_ledger_dump_is_byte_identical_to_the_reference(tmp_path):
    """The same decisions and horizons through both packages' ledgers on one
    fake clock dump the same bytes, plain and gzipped, and each package
    loads the other's file."""
    from tpu_on_k8s.obs import ledger as rledger
    from tpu_on_k8s_torch.obs import ledger as pledger

    def drive(mod):
        t = iter(range(100))
        led = mod.DecisionLedger(lambda: float(next(t)) / 4)
        led.decision(loop="a", tick=1, action="up", current=1, target=2,
                     reason="r x", commit=mod.COMMIT_LANDED,
                     signals=(("latency", "1.000000"),), exemplars=(3,),
                     horizon_open=True)
        led.decision(loop="a", tick=2, action="hold", current=2, target=2,
                     reason="steady", parent=1, trigger="chaos#1")
        led.horizon(1, loop="a", event=mod.HORIZON_REPLICAS_READY,
                    closing=True)
        return led

    for suffix in ("json", "json.gz"):
        ref, port = tmp_path / f"r.{suffix}", tmp_path / f"p.{suffix}"
        drive(rledger).dump(str(ref), extra={"slo": []})
        drive(pledger).dump(str(port), extra={"slo": []})
        assert ref.read_bytes() == port.read_bytes()
        assert rledger.load_ledger(str(port)) == pledger.load_ledger(str(ref))
    assert drive(pledger).lines() == drive(rledger).lines()
