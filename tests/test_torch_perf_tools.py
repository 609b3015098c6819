"""The port's measurement drivers ``perf_sweep``, ``step_breakdown`` and
``attn_micro`` on the CPU, against the reference's ``tools/`` where the
reference computes something without a chip.

* ``perf_sweep.n_params`` of the flagship equals the reference's
  ``bench.n_params`` (318,800,896), and the same unknown-key errors.
* One variant at ``tiny`` prints a row that the reference's runbook parser
  (``tools/chip_window._parse_sweep``) reads; a failing variant prints the
  ``FAILED`` row it reads, and the sweep goes on.
* ``step_breakdown`` and ``attn_micro`` print their lines at small sizes.
* The peak table names NVIDIA cards only; any other kind raises.
"""
from __future__ import annotations

import dataclasses
import re

import pytest
import torch

from tpu_on_k8s_torch import attn_micro, perf_sweep, step_breakdown
from tpu_on_k8s_torch.models.transformer import TransformerConfig

torch.set_num_threads(1)

CONTROL = "attn=flash,remat=mlp,unroll=16,int8=1,gateup=1,nu=bf16,batch=12"


def _tiny():
    return dataclasses.replace(TransformerConfig.tiny(), attn_impl="flash",
                               remat=True, remat_policy="mlp",
                               mlp_int8=True, mlp_fused_gateup=True)


def test_n_params_of_the_flagship_equals_the_reference():
    import bench

    assert perf_sweep.n_params(perf_sweep.bench_config()) == \
        bench.n_params(bench.bench_config()) == 318_800_896


@pytest.mark.parametrize("spec", ["foo=1", "attn=flash,bogus=2,batch=4"])
def test_unknown_keys_raise_as_the_reference(spec):
    import tools.perf_sweep as ref

    with pytest.raises(ValueError) as want:
        ref.run_variant(spec)
    with pytest.raises(ValueError) as got:
        perf_sweep.run_variant(spec, "cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec, fields", [
    (CONTROL, dict(attn_impl="flash", remat=True, remat_policy="mlp",
                   scan_unroll=16, mlp_int8=True, mlp_fused_gateup=True,
                   int8_impl="xla")),
    (CONTROL + ",i8impl=pallas", dict(int8_impl="pallas", mlp_int8=True)),
    ("remat=off,block=256,bq=128,gqa=1,fused=1,hint8=1,aint8=1",
     dict(remat=False, remat_policy="full", attn_block_q=128,
          attn_block_k=256, attn_native_gqa=True, fused_qkv=True,
          head_int8=True, attn_int8=True, attn_impl="xla")),
], ids=["control", "pallas", "knobs"])
def test_variant_config_maps_the_reference_keys(spec, fields):
    cfg = perf_sweep.variant_config(perf_sweep.parse_spec(spec))
    assert {k: getattr(cfg, k) for k in fields} == fields


def test_a_tiny_variant_prints_a_row_the_runbook_parses(monkeypatch,
                                                        capsys):
    from tools.chip_window import _parse_sweep

    monkeypatch.setattr(perf_sweep, "bench_config", _tiny)
    rows = perf_sweep.main([CONTROL.replace("batch=12", "batch=2")
                            + ",steps=2", "attn=flash,nope=1",
                            "--device", "cpu"])
    parsed = _parse_sweep(capsys.readouterr().out)
    assert [set(r) for r in parsed] == [{"spec", "step_ms", "mfu"},
                                        {"spec", "failed"}]
    assert parsed[0]["step_ms"] > 0 and parsed[0]["mfu"] != parsed[0]["mfu"]
    assert parsed[1]["failed"] == "ValueError: unknown keys ['nope']"
    assert rows[0]["loss"] == rows[0]["loss"] and "failed" in rows[1]


def test_step_breakdown_prints_its_lines(monkeypatch, capsys):
    monkeypatch.setattr(step_breakdown, "bench_config", _tiny)
    parts = step_breakdown.breakdown({"int8": "1", "nu": "bf16",
                                      "batch": "2"}, "cpu", steps=2)
    out = capsys.readouterr().out
    for name in ("fwd (loss only)", "fwd+bwd (value_and_grad)",
                 "optimizer update", "full train_step"):
        assert re.search(rf"^{re.escape(name)} +[0-9.]+ ms$", out, re.M)
    assert re.search(r"^fwd ideal nan ms, bwd ideal nan ms$", out, re.M)
    assert re.search(r"^breakdown: fwd [0-9.]+ \| bwd -?[0-9.]+ \| opt "
                     r"[0-9.]+ \| step [0-9.]+ \(sum parts [0-9.]+\)$",
                     out, re.M)
    assert parts["sum_parts"] == pytest.approx(parts["fwd_bwd"]
                                               + parts["opt"])


def test_attn_micro_prints_its_rows(capsys):
    times = attn_micro.main(["1", "64", "2", "16", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("flash: the kernels choose their own tiles")
    assert [ln.split("  ")[0].strip() for ln in out[1:]] == \
        ["xla fwd", "xla fwd+bwd", "flash fwd", "flash fwd+bwd"]
    assert all(re.search(r" [0-9.]+ ms  \( *[0-9.]+ TF/s\)$", ln)
               for ln in out[1:])
    assert set(times) == {"xla fwd", "xla fwd+bwd", "flash fwd",
                          "flash fwd+bwd"}


def test_attn_micro_flash_rows_agree_with_the_plain_rows():
    q, k, v = (t.float() for t in attn_micro.make_inputs(1, 64, 2, 16,
                                                         "cpu"))
    rows = attn_micro.rows()
    torch.testing.assert_close(rows["flash fwd"](q, k, v),
                               rows["xla fwd"](q, k, v),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(rows["flash fwd+bwd"](q, k, v),
                         rows["xla fwd+bwd"](q, k, v)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_the_peak_table_names_nvidia_cards_only():
    assert perf_sweep.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert perf_sweep.peak_flops("NVIDIA H100 PCIe") == 756e12
    for kind in ("TPU v5 lite", "NVIDIA A100-SXM4-80GB", "cpu"):
        with pytest.raises(KeyError, match="no dense bf16 peak"):
            perf_sweep.peak_flops(kind)
    assert perf_sweep.device_peak(torch.device("cpu")) != \
        perf_sweep.device_peak(torch.device("cpu"))     # nan


def test_the_tools_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    for call in (lambda: perf_sweep.run_variant(CONTROL),
                 lambda: step_breakdown.main([]),
                 lambda: attn_micro.main(["1", "64", "2", "16"])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
