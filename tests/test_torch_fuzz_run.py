"""The port's fuzz driver (``fuzz_run``) against the reference's
``tools/fuzz_run.py`` on the CPU.

``--smoke`` in full (12 evaluations over ``slo_regression`` and ``smoke``,
then a replay) takes about a minute on this CPU, in either package, so the
tier-1 case holds the same function on a smaller base: ``--smoke --bases
slo_regression --budget 1`` finds the planted failure on its first
evaluation, writes the entry, replays it twice and prints
``FUZZ_SMOKE_OK``. Both packages' drivers run on the same flags: the same
printed lines and the same written entry, once the port's entry name (a
digest of a scenario document that names the GPU slice) is taken again
with the slice mapped back (``test_torch_fuzz``).
"""
from __future__ import annotations

import argparse

import pytest

from test_torch_fuzz import _as_ref_entry, _ref_entry_name
from tools import fuzz_run as rfuzz_run
from tpu_on_k8s.sim import fuzz as rfz
from tpu_on_k8s_torch import fuzz_run
from tpu_on_k8s_torch.sim import fuzz as pfz

FLAGS = ["--smoke", "--bases", "slo_regression", "--budget", "1",
         "--seed", "1122"]


def test_smoke_on_one_base_equals_the_reference(tmp_path, capsys):
    assert fuzz_run.main(FLAGS + ["--corpus-dir", str(tmp_path / "p")]) == 0
    port_out = capsys.readouterr().out.splitlines()
    assert rfuzz_run.main(FLAGS + ["--corpus-dir", str(tmp_path / "r")]) == 0
    ref_out = capsys.readouterr().out.splitlines()

    (p_path, p_entry), = pfz.load_entries(str(tmp_path / "p"))
    (_, r_entry), = rfz.load_entries(str(tmp_path / "r"))
    assert _as_ref_entry(p_entry) == r_entry
    assert p_entry["oracle"]["kinds"] == [
        "report_check:why_report", "slo_budget_exhausted"]
    assert p_path.endswith(f"{p_entry['name']}.json")
    # the printed lines name the entry: map its name, then they are equal
    mapped = [ln.replace(p_entry["name"], _ref_entry_name(p_entry))
              for ln in port_out]
    assert mapped == ref_out
    assert port_out[-1].startswith("FUZZ_SMOKE_OK seed=1122 entries=1 "
                                   "evals=1 first=slo_regression-")


def test_corpus_dir_defaults_to_none(monkeypatch):
    """The driver writes entries only where it is told: never into the
    reference's ``tests/fuzz_corpus/``."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def stop_after_parsing(self, argv=None, namespace=None):
        seen.update(vars(real(self, argv, namespace)))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        stop_after_parsing)
    with pytest.raises(SystemExit):
        fuzz_run.main([])
    assert seen["corpus_dir"] is None
    result = pfz.FuzzResult(entries=({"name": "x"},), seed=1, budget=1,
                            evals=1, candidates=1, failures_found=1,
                            dedup_skipped=0)
    assert fuzz_run._write_entries(result, None) == []


def test_bad_flags_exit_as_the_reference(capsys):
    for argv in (["--smoke", "--soak"], ["--bases", "no_such_preset"]):
        with pytest.raises(SystemExit) as got:
            fuzz_run.main(argv)
        with pytest.raises(SystemExit) as want:
            rfuzz_run.main(argv)
        assert got.value.code == want.value.code == 2
    err = capsys.readouterr().err
    assert "mutually exclusive" in err and "no_such_preset" in err
    assert (fuzz_run.SMOKE_BASES, fuzz_run.SMOKE_BUDGET) == (
        rfuzz_run.SMOKE_BASES, rfuzz_run.SMOKE_BUDGET)
