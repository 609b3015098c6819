"""The reference's fuzz corpus on the port, against the reference, on the
CPU.

Each entry of ``tests/fuzz_corpus/`` (minimized failures the reference's
fuzzer pinned) is carried to the port with its training slice mapped by
host count (``test_torch_sim.port_corpus_entries``) and judged once in
each package under each package's ``fuzz_run.oracle_config``: the same
verdict, kinds and details, the pinned kinds, and the same artifact bytes
(the four files' SHA-256). The port's ``report_gate`` gives the
reference's exit codes on both packages' artifact sets. ``--workers 2``
judges a generation in two processes and changes nothing of the campaign.
"""
from __future__ import annotations

import dataclasses
import os

import pytest

from test_torch_sim import port_corpus_entries
from tools import fuzz_run as rfuzz_run
from tpu_on_k8s.sim import fuzz as rfz
from tpu_on_k8s.sim import scenario as rscenario
from tpu_on_k8s_torch import fuzz_run
from tpu_on_k8s_torch.metrics import FuzzMetrics
from tpu_on_k8s_torch.sim import fuzz as pfz
from tpu_on_k8s_torch.sim import scenario as pscenario

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "fuzz_corpus")
REF_ENTRIES = rfz.load_entries(CORPUS_DIR)
PORT_ENTRIES = port_corpus_entries(REF_ENTRIES)


@pytest.mark.parametrize("i", range(len(REF_ENTRIES)),
                         ids=[e["name"] for _, e in REF_ENTRIES])
def test_entry_judges_as_the_reference(i, tmp_path):
    _, r_entry = REF_ENTRIES[i]
    _, p_entry = PORT_ENTRIES[i]
    assert p_entry["scenario"]["train_topology"] == "2x8"
    p_out, r_out = str(tmp_path / "p"), str(tmp_path / "r")
    p_verdict, p_summary = pfz.run_and_judge(
        pscenario.scenario_from_doc(p_entry["scenario"]),
        fuzz_run.oracle_config(), outdir=p_out)
    r_verdict, r_summary = rfz.run_and_judge(
        rscenario.scenario_from_doc(r_entry["scenario"]),
        rfuzz_run.oracle_config(), outdir=r_out)
    assert dataclasses.asdict(p_verdict) == dataclasses.asdict(r_verdict)
    assert list(p_verdict.kinds) == r_entry["oracle"]["kinds"]
    assert p_summary == r_summary
    sha = pfz.corpus.artifact_hashes(p_out)
    assert set(sha) == set(pfz.ARTIFACTS)
    assert sha == rfz.corpus.artifact_hashes(r_out)
    pages = p_summary["pages"]
    for out in (p_out, r_out):
        assert fuzz_run.report_gate(out, pages) == rfuzz_run.report_gate(
            out, pages)


def test_workers_change_nothing_of_the_campaign():
    base = pscenario.preset("slo_regression")

    def campaign(workers):
        metrics = FuzzMetrics()
        result = fuzz_run._campaign(
            [base], seed=5, budget=2, workers=workers,
            mcfg=pfz.MutationConfig(max_virtual_s=240.0), metrics=metrics)
        return result, dict(metrics.counters)

    serial, in_pool = campaign(0), campaign(2)
    assert serial[0].to_doc() == in_pool[0].to_doc()
    assert list(serial[0].entries) == list(in_pool[0].entries)
    assert serial[1] == in_pool[1]
