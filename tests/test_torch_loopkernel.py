"""The port's control-loop kernel (``controller/loopkernel.py``), decision
ledger (``obs/ledger.py``, ``obs/dumpio.py``) and autoscaling policy
(``autoscale/policy.py``, ``autoscale/signals.py``) against the reference
on the CPU.

The reference's test modules run against the port through
``test_torch_api.reference_cases``:

* from ``tests/test_ledger.py``: ``TestDecisionLineSerde``,
  ``TestDecisionLedger`` (but ``test_metrics_feed``, which needs
  ``LedgerMetrics``, the coordinator's slice), ``TestCooldownGate``,
  ``TestLoopKernel`` and ``TestElasticLedger`` (the elastic autoscaler's
  decisions through the kernel, on ``tests/test_autoscaler.py``'s
  helpers run against the port);
* from ``tests/test_autoscale.py``: ``TestPolicy`` (the ``Recommender`` on
  legal host counts of 8-GPU hosts) and ``TestSignals`` but
  ``test_scraper_reads_deltas_only``, whose fleet serves from the
  reference's JAX engine (the port's ``FleetScraper`` is held against the
  JAX fleet in ``tests/test_torch_serve_fleet.py``).

Both modules import the serving autoscaler, its metrics and the JAX
models at module level, which this slice does not port; those imports are
left unexecuted (``LATER``), and the classes run here use none of them.
"""
from __future__ import annotations

import torch

from test_torch_api import reference_cases, slice_literals
from test_torch_elastic import port_module

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

#: module-level imports of what later slices port (the serving autoscaler
#: and inference-service controller, the metrics classes) and of the JAX
#: models the serving fixtures build: left unexecuted, line for line
LATER = (r"(?m)^from (tpu_on_k8s_torch\.(?:controller\.fleetautoscaler|"
         r"controller\.inferenceservice|metrics\.metrics|models\.[a-z]+)) "
         r"import", r"if False: from \1 import")
#: the reference's chaos package is one module in the port
SCENARIOS = (r"from tpu_on_k8s_torch\.chaos import scenarios",
             "from tpu_on_k8s_torch import chaos as scenarios")

# the helpers TestElasticLedger takes from tests/test_autoscaler.py
reference_cases("test_autoscaler", only=(), subs=(slice_literals,))
globals().update(reference_cases(
    "test_ledger",
    only=("TestDecisionLineSerde", "TestDecisionLedger", "TestCooldownGate",
          "TestLoopKernel", "TestElasticLedger"),
    skip=("TestDecisionLedger.test_metrics_feed",),
    subs=(slice_literals, LATER, SCENARIOS, port_module("test_autoscaler"))))
globals().update(reference_cases(
    "test_autoscale", only=("TestPolicy", "TestSignals"),
    skip=("TestSignals.test_scraper_reads_deltas_only",),
    subs=(slice_literals, LATER, SCENARIOS)))


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestDecisionLineSerde", "TestDecisionLedger", "TestCooldownGate",
            "TestLoopKernel", "TestElasticLedger", "TestPolicy",
            "TestSignals"} <= names
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
