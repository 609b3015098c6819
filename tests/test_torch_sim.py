"""The port's digital twin (``tpu_on_k8s_torch/sim/``: ``clock``, ``devices``,
``scenario``, ``twin``, with ``metrics.SimMetrics``) against the reference
on the CPU.

The reference's ``tests/test_sim.py`` runs against the port through
``test_torch_api.reference_cases``: the event loop, the diurnal trace, the
virtual fleet, the scenario's chaos compilation, and one smoke rehearsal
twice whose artifacts replay byte for byte and pass the report tools
(``test_torch_api.TOOLS`` maps ``tools/slo_report.py``, ``trace_report``
and ``why_report`` to the port's ``obs/`` copies).

Here too: the port's four artifacts (``trace.json.gz``, ``ledger.json.gz``,
``slo.json``, ``summary.json``), decompressed and parsed, equal the
reference's under ``to_ref_wire`` for ``smoke`` and a shortened
``multi_model_density`` (``broker_contention`` is in
``tests/test_torch_twin_soak.py``), with the twins' ``SimMetrics`` and its
exposition equal; the GPU flavour's scenario (``train_topology`` 2x8, the
reference's 2x4 mapped by host count) and replica slice (1x4, four chips
a replica as the reference's 2x2); and the differences that stay in the
cluster and never reach an artifact, named: the elastic training job's
survivors restart in place where the reference recreates them (the
elastic controller's decision, ``tests/test_torch_elastic_diff.py``), and
a serving replica's pod requests a whole host's GPUs (the InferenceService
reconciler's).
"""
from __future__ import annotations

import dataclasses
import gzip
import json
import os

import pytest

from test_torch_api import (
    REF_ACCELERATOR,
    TOOLS,
    port_topology,
    ref_topology,
    reference_cases,
    to_ref_wire,
)
from test_torch_autoscale import METRICS
from tpu_on_k8s.metrics import metrics as rmetrics
from tpu_on_k8s.sim import scenario as rscenario
from tpu_on_k8s.sim import twin as rtwin
from tpu_on_k8s_torch import metrics as pmetrics
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Pod
from tpu_on_k8s_torch.gang import topology
from tpu_on_k8s_torch.sim import scenario as pscenario
from tpu_on_k8s_torch.sim import twin as ptwin

globals().update(reference_cases("test_sim", subs=(METRICS, *TOOLS)))

ARTIFACTS = (ptwin.TRACE_FILE, ptwin.LEDGER_FILE, ptwin.SLO_FILE,
             ptwin.SUMMARY_FILE)


def test_the_reference_cases_are_collected_here():
    assert {"TestEventLoop", "TestDiurnalTrace", "TestSimFleet",
            "TestScenario", "TestTwinSmoke", "TestTwinSampling",
            "smoke_runs"} <= set(globals())


# ---- the GPU flavour of a scenario ------------------------------------------

def port_scenario_doc(doc: dict) -> dict:
    """A reference scenario document as the port runs it: its training
    topology mapped by host count (``port_topology``)."""
    return dict(doc, train_topology=port_topology(
        REF_ACCELERATOR, doc.get("train_topology", "2x4")))


def ref_scenario_doc(doc: dict) -> dict:
    """The inverse of ``port_scenario_doc`` over the reference's default."""
    return dict(doc, train_topology=ref_topology(doc["train_topology"]))


def port_corpus_entries(entries):
    """``(path, entry)`` pairs of the reference's fuzz corpus, each entry's
    scenario carried to the port (``port_scenario_doc``)."""
    return [(path, dict(e, scenario=port_scenario_doc(e["scenario"])))
            for path, e in entries]


@pytest.mark.parametrize("name", sorted(rscenario.PRESETS))
def test_presets_are_the_reference_presets_mapped(name):
    """Every preset, field for field, with the training slice mapped."""
    ref = rscenario.scenario_to_doc(rscenario.preset(name))
    port = pscenario.scenario_to_doc(pscenario.preset(name))
    assert port == port_scenario_doc(ref)
    assert ref_scenario_doc(port) == ref
    assert pscenario.scenario_from_doc(port) == pscenario.preset(name)
    # two 8-GPU hosts, as the reference's slice is two TPU hosts
    assert topology.hosts_per_slice("nvidia-h100-80gb",
                                    port["train_topology"]) == 2


def test_formats_and_artifact_names_equal_the_reference():
    assert ptwin.SLO_FORMAT == rtwin.SLO_FORMAT
    assert pscenario.SCENARIO_FORMAT == rscenario.SCENARIO_FORMAT
    assert ARTIFACTS == (rtwin.TRACE_FILE, rtwin.LEDGER_FILE,
                         rtwin.SLO_FILE, rtwin.SUMMARY_FILE)
    # the replica slice: four GPUs of one host where the reference has a
    # 2x2 TPU slice, so the density summary counts the same chips
    assert ptwin.REPLICA_TOPOLOGY == port_topology(REF_ACCELERATOR,
                                                   rtwin.REPLICA_TOPOLOGY)
    assert (topology.chips_in_topology(ptwin.REPLICA_TOPOLOGY)
            == 4 == topology.chips_per_host("nvidia-h100-80gb") // 2)


# ---- the artifacts against the reference's ----------------------------------

def _load(outdir: str, name: str):
    path = os.path.join(outdir, name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def assert_artifacts_equal(port_dir: str, ref_dir: str) -> None:
    """The port's four artifacts, parsed, equal the reference's under
    ``to_ref_wire``."""
    for name in ARTIFACTS:
        want = _load(ref_dir, name)
        got = to_ref_wire(_load(port_dir, name))
        assert got == want, name


def _twins(sc_name: str, tmp, **over):
    """One run of each package's twin on the same preset (``over`` applied
    to both), written under ``tmp``; returns (port, ref, port_dir,
    ref_dir)."""
    r_sc = dataclasses.replace(rscenario.preset(sc_name), **over)
    p_sc = dataclasses.replace(pscenario.preset(sc_name), **over)
    ref = rtwin.DigitalTwin(r_sc)
    ref.run()
    ref.write(str(tmp / "ref"))
    port = ptwin.DigitalTwin(p_sc)
    port.run()
    port.write(str(tmp / "port"))
    return port, ref, str(tmp / "port"), str(tmp / "ref")


@pytest.fixture(scope="module")
def smoke_pair(tmp_path_factory):
    return _twins("smoke", tmp_path_factory.mktemp("smoke_pair"))


def test_smoke_artifacts_equal_the_reference(smoke_pair, smoke_runs):
    port, _, port_dir, ref_dir = smoke_pair
    assert_artifacts_equal(port_dir, ref_dir)
    # the wall-clocked run of the reference's fixture writes the same bytes
    _, dir_a, _ = smoke_runs
    for name in ARTIFACTS:
        with open(os.path.join(dir_a, name), "rb") as a, \
                open(os.path.join(port_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    assert port.summary["served"] == port.summary["requests"] > 1000


def _sim_metrics(twin) -> dict:
    m = twin.sim_metrics
    return {"counters": dict(m.counters), "gauges": dict(m.gauges)}


def _stable(body: str) -> list:
    """A scrape body without prometheus_client's ``_created`` stamps
    (the wall time each family was made)."""
    return [ln for ln in body.splitlines() if "_created" not in ln]


def test_smoke_sim_metrics_equal_the_reference(smoke_pair):
    port, ref, _, _ = smoke_pair
    assert _sim_metrics(port) == _sim_metrics(ref)
    assert (port.sim_metrics.counters["events_processed"]
            == port.loop.events_processed)
    assert (_stable(pmetrics.exposition(port.sim_metrics))
            == _stable(rmetrics.exposition(ref.sim_metrics)))
    assert "tpu_on_k8s_sim_requests_simulated_total" in pmetrics.render_text(
        port.sim_metrics)


def test_smoke_cluster_differs_only_by_the_mapped_decisions(smoke_pair):
    """What never reaches an artifact: the pods. Names, phases and the
    job-generation label are the reference's; the training survivors of
    the 2 -> 4 -> 8 -> 4 story restart in place (same uid across the
    rescales, an ``elastic-restarts`` stamp) where the reference recreates
    them, and a replica's pod asks for a whole host."""
    from tpu_on_k8s.api.core import Pod as RPod

    port, ref, _, _ = smoke_pair
    pods = {p.metadata.name: p for p in port.cluster.list(Pod, "default")}
    rpods = {p.metadata.name: p for p in ref.cluster.list(RPod, "default")}
    assert sorted(pods) == sorted(rpods)
    for name, pod in sorted(pods.items()):
        rpod = rpods[name]
        assert pod.status.phase == rpod.status.phase
        assert (to_ref_wire(dict(pod.metadata.labels))
                == dict(rpod.metadata.labels))
        c = pod.spec.containers[0]
        if name.startswith(f"{ptwin.TRAIN_JOB}-worker-"):
            assert c.name == "torch"
            assert int(pod.metadata.annotations[
                constants.ANNOTATION_ELASTIC_RESTARTS]) >= 1
            assert pod.status.container_statuses[0].restart_count >= 1
            assert rpod.status.container_statuses[0].restart_count == 0
            assert int(rpod.metadata.uid.split("-")[1]) > int(
                pod.metadata.uid.split("-")[1])
        else:
            assert c.resources.requests[constants.RESOURCE_GPU] == 8
    assert port.summary["train_final_workers"] == 4


@pytest.fixture(scope="module")
def density_pair(tmp_path_factory):
    # the rehearsal cut to its first 300 virtual seconds: the burst (240 s
    # on) and the swap churn, not the preemption at 420 s (the drain runs
    # it past the horizon all the same)
    return _twins("multi_model_density",
                  tmp_path_factory.mktemp("density_pair"), duration_s=300.0)


def test_short_density_artifacts_equal_the_reference(density_pair):
    port, ref, port_dir, ref_dir = density_pair
    assert_artifacts_equal(port_dir, ref_dir)
    assert _sim_metrics(port) == _sim_metrics(ref)
    m = port.summary["models"]
    assert m["swaps"] > 0 and m["evictions"] > 0
    assert m["chips"] == m["peak_replicas"] * 4
    assert m["control_arm_chips"] == 50 * 4
