"""The port's scenario fuzzer (``tpu_on_k8s_torch/sim/fuzz/``: ``mutate``,
``oracle``, ``shrink``, ``corpus``, ``search``, with ``metrics.FuzzMetrics``)
against the reference on the CPU.

The reference's ``tests/test_fuzz.py`` runs against the port through
``test_torch_api.reference_cases``: scenario documents, the preset
registry, mutation, the oracle's checks on synthetic records and on the
presets (its ``slow`` mark kept on the three long presets), shrinking, the
corpus and the search, and every entry of ``tests/fuzz_corpus/`` replayed
under the port's ``fuzz_run.oracle_config`` (``TOOLS``). A corpus entry's
scenario carries the reference's TPU training slice; it is carried to the
port with its topology mapped by host count
(``test_torch_sim.port_scenario_doc``) before it replays.

Here too, the same seeds through both packages: ``mutate`` from the same
``random.Random`` gives the same mutant and the same mutator names,
``shrink`` the same minimum by the same passes and evaluations, and
``fuzz(..., seed=7, budget=4)`` over the reference's ``_tiny`` base the same
``FuzzResult.to_doc()``, the same corpus entries and the same
``FuzzMetrics`` counters. The one mapped difference: an entry's name is a
digest of its scenario document, which names the GPU slice (``2x8``), so
the port's entries are compared with the slice mapped back and the digest
taken again.
"""
from __future__ import annotations

import dataclasses
import random
import sys

import pytest

import test_fuzz as rtests
from test_torch_api import TOOLS, reference_cases
from test_torch_autoscale import METRICS
from test_torch_sim import ref_scenario_doc
from tpu_on_k8s.metrics.metrics import FuzzMetrics as RFuzzMetrics
from tpu_on_k8s.sim import fuzz as rfz
from tpu_on_k8s.sim import scenario as rscenario
from tpu_on_k8s_torch.metrics import FuzzMetrics
from tpu_on_k8s_torch.sim import fuzz as pfz
from tpu_on_k8s_torch.sim import scenario as pscenario

#: the reference corpus's documents carried to the port (topology mapped)
CORPUS = ((r"(?m)^import random$",
           "import random; from test_torch_sim import port_corpus_entries"),
          (r"return fz\.load_entries\(CORPUS_DIR\)",
           "return port_corpus_entries(fz.load_entries(CORPUS_DIR))"))

globals().update(reference_cases("test_fuzz",
                                 subs=(METRICS, *TOOLS, *CORPUS)))

_port = sys.modules["_port_test_fuzz"]


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestScenarioDocs", "TestPresetRegistry", "TestMutate",
            "TestOracleChecks", "TestOracleOnPresets", "TestShrink",
            "TestCorpus", "TestSearch",
            "test_corpus_entry_replays_to_its_pinned_verdict",
            "test_corpus_is_not_empty"} <= names
    # the corpus the port replays is the reference's, slice mapped
    entries = _port._corpus_entries()
    assert len(entries) == len(rtests._corpus_entries()) >= 2
    assert all(e["scenario"]["train_topology"] == "2x8"
               for _, e in entries)


def _mapped(sc) -> dict:
    """A port scenario as the reference's document."""
    return ref_scenario_doc(pscenario.scenario_to_doc(sc))


def _ref_doc(sc) -> dict:
    return rscenario.scenario_to_doc(sc)


@pytest.mark.parametrize("base", ["smoke", "broker_contention",
                                  "multi_model_density", "slo_regression"])
def test_mutate_equals_the_reference(base):
    for seed in range(12):
        p_sc, p_names = pfz.mutate(random.Random(seed),
                                   pscenario.preset(base), 3)
        r_sc, r_names = rfz.mutate(random.Random(seed),
                                   rscenario.preset(base), 3)
        assert p_names == r_names
        assert _mapped(p_sc) == _ref_doc(r_sc)


def _ref_entry_name(entry: dict) -> str:
    return rfz.entry_name(entry["provenance"]["base"],
                          entry["oracle"]["kinds"],
                          ref_scenario_doc(entry["scenario"]))


def _as_ref_entry(entry: dict) -> dict:
    return dict(entry, name=_ref_entry_name(entry),
                scenario=ref_scenario_doc(entry["scenario"]))


def test_shrink_equals_the_reference():
    from tpu_on_k8s.sim.traffic import TenantMix as RTenantMix
    from tpu_on_k8s_torch.sim.traffic import TenantMix

    chaos = dict(at_s=5.0, kind="signal_outage", duration_s=3.0)
    p_base = _port._tiny(
        chaos=(pscenario.ChaosWindow(**chaos),),
        tenants=TenantMix(names=("a", "b"), weights=(3.0, 1.0)))
    r_base = rtests._tiny(
        chaos=(rscenario.ChaosWindow(**chaos),),
        tenants=RTenantMix(names=("a", "b"), weights=(3.0, 1.0)))
    p_verdict, _ = pfz.run_and_judge(p_base)
    r_verdict, _ = rfz.run_and_judge(r_base)
    assert dataclasses.asdict(p_verdict) == dataclasses.asdict(r_verdict)
    p = pfz.shrink(p_base, p_verdict,
                   lambda sc: pfz.run_and_judge(sc)[0], budget=6)
    r = rfz.shrink(r_base, r_verdict,
                   lambda sc: rfz.run_and_judge(sc)[0], budget=6)
    assert (p.steps, p.evals) == (r.steps, r.evals)
    assert _mapped(p.scenario) == _ref_doc(r.scenario)
    assert dataclasses.asdict(p.verdict) == dataclasses.asdict(r.verdict)


def test_campaign_equals_the_reference():
    kwargs = dict(seed=7, budget=4, gen_size=2, shrink_budget=2)
    p_metrics, r_metrics = FuzzMetrics(), RFuzzMetrics()
    p = pfz.fuzz([_port._tiny()], metrics=p_metrics, **kwargs)
    r = rfz.fuzz([rtests._tiny()], metrics=r_metrics, **kwargs)
    assert p.entries
    want = r.to_doc()
    got = p.to_doc()
    got["entries"] = [_ref_entry_name(e) for e in p.entries]
    assert got == want
    # every entry whole: verdict, provenance and the artifacts' hashes
    assert [_as_ref_entry(e) for e in p.entries] == list(r.entries)
    assert dict(p_metrics.counters) == dict(r_metrics.counters)
    assert (p_metrics.counters["evals"] + p_metrics.counters["shrink_evals"]
            == p.evals)
