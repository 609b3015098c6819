"""``chip_smoke.py`` phase 18's drivers on the CPU: the twin priced by an
engine's own measurements.

``twin_measure`` takes its three kinds of sample (replica starts, decode
steps at full occupancy, single-request prefills) from a tiny
``ContinuousBatchingEngine`` on the CPU, as the phase takes them from
gpt2_small on the card; ``twin_priced`` fits them with the port's
``sim/calibrate`` CLI and runs ``smoke`` twice on the fitted costs under
the phase's gates. A planted document whose samples are the cost model's
defaults fits them back, and the twin on them writes the same bytes as the
default ``smoke`` preset (which ``tests/test_torch_sim.py`` holds equal to
the reference's).
"""
from __future__ import annotations

import dataclasses
import json

import torch

import chip_smoke
from test_torch_sim import ARTIFACTS
from tpu_on_k8s_torch.models.params import init_params
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.sim import scenario, twin

torch.set_num_threads(1)


def test_measure_and_price_a_cpu_engine(tmp_path):
    cfg = dataclasses.replace(TransformerConfig.tiny(), max_seq_len=128,
                              dtype=torch.float32)
    host = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                       dtype=torch.float32)
    lens = (8, 16, 32, 64, 100)
    m = chip_smoke.twin_measure(
        cfg, host, torch.device("cpu"), slots=4, max_len=128, starts=2,
        decode_prompt=8, decode_new=36, min_steps=32, prefill_lens=lens,
        reps=1)
    assert len(m["compiles"]) == 2 and len(m["decode_steps"]) >= 32
    assert [n for n, _ in m["prefills"]] == list(lens)
    # two starts, the four decode admissions in one batched prefill (one
    # bucket), a warm pass and a timed one
    assert m.pop("fresh_prefills") == 2 + 1 + 2 * len(lens)
    doc = tmp_path / "doc.json"
    doc.write_text(json.dumps({"card": "cpu", "twin_engine": m}))
    res = chip_smoke.twin_priced(doc, tmp_path)
    assert res["cal"].fitted == chip_smoke.TWIN_FITTED
    assert res["summary"]["served"] == res["summary"]["requests"]
    assert [name for name, _ in res["gates"]][0] == "trace_report"
    assert "tpu_on_k8s_sim_speedup" in res["exposition"]


def test_the_defaults_fitted_back_write_the_default_bytes(tmp_path):
    """Samples at the smoke preset's own constants (step 0.05 s, prefill
    0.05 steps a position, start 20 s) fit to exactly those, so the priced
    twin's artifacts are the default smoke run's, byte for byte."""
    base = scenario.smoke().cost
    slope = base.step_s * base.prefill_cost
    doc = tmp_path / "doc.json"
    doc.write_text(json.dumps({"card": "planted", "twin_engine": {
        "decode_steps": [base.step_s] * 33,
        "compiles": [base.compile_s] * 3,
        "prefills": [[n, n * slope] for n in (16, 128, 512, 1000)]}}))
    res = chip_smoke.twin_priced(doc, tmp_path)
    cal = res["cal"]
    assert (cal.step_s, cal.prefill_cost, cal.compile_s) == (
        base.step_s, base.prefill_cost, base.compile_s)
    ref = tmp_path / "default"
    twin.run_twin(scenario.smoke(), str(ref))
    for name in ARTIFACTS:
        assert ((tmp_path / "twin_a" / name).read_bytes()
                == (ref / name).read_bytes()), name
    assert res["summary"]["pages"] >= 1 and res["gates"] == [
        ("trace_report", 0), ("why_report", 0), ("slo_report", 0)]
