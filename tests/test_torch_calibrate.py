"""The port's cost-model calibration (``tpu_on_k8s_torch/sim/calibrate.py``)
against the reference on the CPU.

The reference's ``tests/test_calibrate.py`` runs against the port through
``test_torch_api.reference_cases``: extraction over the bench schema's
shapes (dead stages, flat BENCH docs, garbage values), the closed-form fit
on planted constants, the document round trip, ``CostBounds`` and the CLI.

Here too: both packages' ``fit_files`` give the same calibration document,
bit for bit, over the repo's ``BENCH_r0*.json`` and ``CHIPWINDOW_r05.json``
(used as inputs of the fit only: they are TPU runs, and the port's twin is
never priced by them) and over seeded planted documents in the shape the
card's twin phase writes; and the CLI prints the same document and exits
the same, ``--strict`` included.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
from pathlib import Path

import numpy as np
import pytest

from test_torch_api import reference_cases
from tpu_on_k8s.sim import calibrate as rcal
from tpu_on_k8s.sim import devices as rdevices
from tpu_on_k8s_torch.sim import calibrate as pcal
from tpu_on_k8s_torch.sim import devices as pdevices

REPO = Path(__file__).resolve().parent.parent

globals().update(reference_cases("test_calibrate"))


def test_the_reference_cases_are_collected_here():
    assert {"TestExtraction", "TestFit", "TestCalibrationDocs",
            "TestCostBounds", "TestCli"} <= set(globals())


def test_the_cost_model_defaults_are_the_reference_defaults():
    """The hand-picked constants (no measurement) the CPU oracles need."""
    assert (dataclasses.asdict(pdevices.DeviceCostModel())
            == dataclasses.asdict(rdevices.DeviceCostModel()))
    assert (pdevices.STEP_BASE, pdevices.PREFILL_COST) == (
        rdevices.STEP_BASE, rdevices.PREFILL_COST)
    assert pcal.CALIBRATION_FORMAT == rcal.CALIBRATION_FORMAT


def _repo_docs():
    return sorted(str(p) for p in REPO.glob("BENCH_r0*.json")) + [
        str(REPO / "CHIPWINDOW_r05.json")]


@pytest.mark.parametrize("paths", [
    [p] for p in _repo_docs()] + [_repo_docs()],
    ids=[Path(p).name for p in _repo_docs()] + ["all"])
def test_fit_files_equals_the_reference_over_the_repo_docs(paths):
    want = rcal.fit_files(paths).to_doc()
    got = pcal.fit_files(paths).to_doc()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


def _planted(seed: int) -> dict:
    """A measurement document of the twin phase's shape: one live stage of
    decode steps, replica starts and prefill pairs, a dead stage, a metric
    row and the card's metadata."""
    rng = np.random.default_rng(seed)
    step = float(rng.uniform(0.005, 0.08))
    lens = sorted(int(x) for x in rng.integers(16, 1001, size=6))
    return {
        "card": "planted", "power_limit": "700.00 W",
        "engine": {
            "decode_steps": [float(step * rng.uniform(0.8, 1.3))
                             for _ in range(int(rng.integers(1, 40)))],
            "compiles": [float(rng.uniform(0.5, 40.0))
                         for _ in range(int(rng.integers(1, 4)))],
            "prefills": [[n, float(n * step * rng.uniform(0.001, 0.05))]
                         for n in lens],
        },
        "dead": {"error": "timeout", "decode_steps": [9.0]},
        "headline": {"metric": "prefill_ms_per_token",
                     "value": float(rng.uniform(0.01, 1.0)), "unit": "ms"},
    }


@pytest.mark.parametrize("seed", range(8))
def test_fit_equals_the_reference_on_planted_docs(seed, tmp_path):
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(_planted(seed)))
    base_r = rdevices.DeviceCostModel(step_s=0.07, compile_s=11.0)
    base_p = pdevices.DeviceCostModel(step_s=0.07, compile_s=11.0)
    want = rcal.fit_files([str(path)], base_r)
    got = pcal.fit_files([str(path)], base_p)
    assert got.to_doc() == want.to_doc()
    assert got.fitted == ["step_s", "prefill_cost", "compile_s"]
    assert pcal.calibration_from_doc(got.to_doc()) == got
    assert (dataclasses.asdict(got.cost_model(base_p))
            == dataclasses.asdict(want.cost_model(base_r)))
    bounds_r = rcal.CostBounds.around(want.cost_model(), 0.3)
    bounds_p = pcal.CostBounds.around(got.cost_model(), 0.3)
    assert dataclasses.asdict(bounds_p) == dataclasses.asdict(bounds_r)


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("strict", [False, True])
def test_cli_prints_and_exits_as_the_reference(strict, tmp_path):
    live = tmp_path / "live.json"
    live.write_text(json.dumps(_planted(3)))
    dead = REPO / "CHIPWINDOW_r05.json"
    flags = ["--strict"] if strict else []
    for paths in ([str(live)], [str(dead)], [str(dead), str(live)]):
        assert _cli(pcal.main, paths + flags) == _cli(rcal.main,
                                                      paths + flags)
