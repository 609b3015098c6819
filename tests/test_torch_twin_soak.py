"""The port's twin drivers ``twin_soak`` and ``broker_soak`` on the CPU,
with the reference's twin beside them (``multimodel_soak`` is in
``tests/test_torch_multimodel_soak.py``).

Each driver's ``main`` runs as its reference's ``tools/*_soak.py`` does
from ``make``: the preset twice into two directories, byte-compared, its
own gates, and with ``--check`` the port's three reports
(``obs/trace_report``, ``obs/why_report --check``, ``obs/slo_report
--check``) on run A. Each prints its ``*_OK`` line and exits 0; a drift or
a failed gate prints ``*_FAILED`` and exits 1. The artifacts of
``broker_contention`` (the capacity market over 12 hosts) equal the
reference twin's under ``to_ref_wire``; those of ``smoke`` and a shortened
``multi_model_density`` are held in ``tests/test_torch_sim.py``.
"""
from __future__ import annotations

import os

from test_torch_sim import assert_artifacts_equal
from tpu_on_k8s.sim import scenario as rscenario
from tpu_on_k8s.sim import twin as rtwin
from tpu_on_k8s_torch import broker_soak, twin_soak


def _lines(text: str) -> list:
    return [ln.strip() for ln in text.splitlines() if ln.strip()]


def test_twin_soak_smoke_check(tmp_path, capsys):
    assert twin_soak.main(["smoke", "--check",
                           "--outdir", str(tmp_path)]) == 0
    out = _lines(capsys.readouterr().out)
    assert out[0].startswith("TWIN_SOAK_OK seed=2468: 4 artifact(s) "
                             "byte-identical across two runs")
    assert out[1].startswith("scenario=smoke requests=6812 served=6812 "
                             "pages=1 scale_ups=2 preemptions=1")
    assert out[-3:] == ["trace_report: OK", "why_report: OK",
                        "slo_report: OK"]
    assert sorted(os.listdir(tmp_path / "a")) == sorted(twin_soak.ARTIFACTS)


def test_twin_soak_speedup_gate_fails_as_the_reference(tmp_path, capsys):
    rc = twin_soak.main(["--scenario", "smoke", "--seed", "7",
                         "--min-speedup", "1e12", "--json",
                         "--outdir", str(tmp_path)])
    captured = capsys.readouterr()
    assert rc == 1
    assert "TWIN_SOAK_FAILED seed=7: speedup" in captured.err
    assert '"perf": {"speedup"' in captured.out


def test_broker_soak_check_and_artifacts_equal_the_reference(tmp_path,
                                                              capsys):
    assert broker_soak.main(["--check", "--outdir", str(tmp_path)]) == 0
    out = _lines(capsys.readouterr().out)
    assert out[0].startswith("BROKER_SOAK_OK seed=1357: 4 artifact(s)")
    assert out[-3:] == ["trace_report: OK", "why_report: OK",
                        "slo_report: OK"]
    batch = next(ln for ln in out if ln.startswith("batch:"))
    assert "intact=True" in batch and "yields=0" not in batch
    ref_dir = str(tmp_path / "ref")
    rtwin.run_twin(rscenario.broker_contention(), ref_dir)
    assert_artifacts_equal(str(tmp_path / "a"), ref_dir)
