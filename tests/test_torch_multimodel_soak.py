"""The port's multi-model density soak (``multimodel_soak``) on the CPU.

``main`` runs as the reference's ``tools/multimodel_soak.py`` does: the
50-model ``multi_model_density`` preset twice, byte-compared, the density
gates (the whole catalog served, swap churn, no per-model budget
exhausted, the peak chips under the one-replica-per-model control arm, the
``swap_p95`` signal in the ledger) and the port's three reports on run A.
A shortened run of the same preset is held against the reference twin's
artifacts in ``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from test_torch_twin_soak import _lines
from tpu_on_k8s_torch import broker_soak, multimodel_soak


def test_multimodel_soak_check(tmp_path, capsys):
    assert multimodel_soak.main(["--check", "--outdir", str(tmp_path)]) == 0
    out = _lines(capsys.readouterr().out)
    assert out[0].startswith("MULTIMODEL_SOAK_OK seed=7531: 4 artifact(s)")
    density = next(ln for ln in out if ln.startswith("density:"))
    assert "slo_exhausted=0" in density
    assert out[-3:] == ["trace_report: OK", "why_report: OK",
                        "slo_report: OK"]


def test_density_gates_name_each_violation():
    """The gates of ``multimodel_soak`` on a summary built to trip them."""
    summary = {"rejected": 2, "models": {
        "catalog": 50, "served_models": 49, "swaps": 0, "evictions": 0,
        "slo_engines": 50, "slo_exhausted": ["m1/ttft"], "chips": 200,
        "control_arm_chips": 200}}
    bad = multimodel_soak._density_gates(summary, 0)
    assert len(bad) == 6
    assert multimodel_soak._density_gates({}, 1) == [
        "summary has no models block — the scenario did not run "
        "multi-model"]
    assert len(broker_soak._market_gates({"rejected": 1})) == 5
