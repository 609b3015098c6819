"""Perf sweep for the ~350M flagship: times train-step variants on the card
so tuning decisions are measured, not guessed (the counterpart of the
reference's ``tools/perf_sweep.py``).

Usage::

    python -m tpu_on_k8s_torch.perf_sweep [--device D] [variant ...]

Each variant is name=value pairs joined by commas, e.g.::

    python -m tpu_on_k8s_torch.perf_sweep attn=flash,batch=16 attn=xla,batch=24

Prints one line per variant: name, step ms, tok/s, MFU (6 x ``n_params`` x
tokens/s over the card's dense bf16 peak, ``PEAK_FLOPS``). Variants that run
out of memory or fail print ``FAILED: ...`` and the sweep continues.

The model is ``serve_load.bench_config()`` with the variant's changes, on
one card without a mesh (the reference's fsdp mesh over one device lays
nothing out): random fp32 master weights from torch seed 0, one fixed batch
of tokens from torch seed 1, ``train/trainer.Trainer`` with
``default_optimizer(warmup_steps=10, decay_steps=1000)``. ``block``,
``bq``, ``bk`` and ``unroll`` set ``attn_block_q`` / ``attn_block_k`` /
``scan_unroll``, TPU knobs the port accepts without effect;
``i8impl=pallas`` runs the int8 products on the hand-written int8 GEMM
(``ops/csrc/int8_matmul.cu``), ``xla`` on ``torch._int_mm``. The default
device is ``cuda``, which raises without a card; on ``--device cpu`` the
MFU reads ``nan`` (no peak for a CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from tpu_on_k8s_torch.device import resolve_device

#: Dense bf16 peak FLOP/s of NVIDIA cards by a substring of
#: ``torch.cuda.get_device_name`` (lower case), first match wins (NVIDIA
#: data sheets; "H100 80GB HBM3" is the SXM card).
PEAK_FLOPS = (("h100 pcie", 756e12), ("h100", 989e12))


def peak_flops(kind: str) -> float:
    """The dense bf16 peak of the card named ``kind``; ``KeyError`` for a
    card the table does not name."""
    lower = kind.lower()
    for key, peak in PEAK_FLOPS:
        if key in lower:
            return peak
    raise KeyError(f"no dense bf16 peak for {kind!r}: the table names "
                   f"{[k for k, _ in PEAK_FLOPS]}")


def device_peak(dev: torch.device) -> float:
    """The peak of ``dev``'s card; ``nan`` on the CPU."""
    if dev.type != "cuda":
        return float("nan")
    return peak_flops(torch.cuda.get_device_name(dev))


def n_params(cfg) -> int:
    """The reference's parameter count (``bench.n_params``): attention,
    the three MLP matrices and two norms a layer, the embedding and head,
    and the final norm."""
    per_layer = (cfg.d_model * cfg.head_dim * (cfg.n_heads * 2
                                               + cfg.n_kv_heads * 2)
                 + 3 * cfg.d_model * cfg.d_ff + 2 * cfg.d_model)
    return (cfg.n_layers * per_layer + 2 * cfg.vocab_size * cfg.d_model
            + cfg.d_model)


def bench_config():
    """The flagship: ``serve_load.bench_config()``."""
    from tpu_on_k8s_torch.serve_load import bench_config as flagship
    return flagship()


def parse_spec(spec: str) -> dict:
    """A variant's settings, the reference's keys and defaults; ValueError
    for a key it does not know."""
    opts = dict(kv.split("=", 1) for kv in spec.split(",") if kv)
    block = int(opts.pop("block", 0))        # 0 = auto
    out = dict(
        batch=int(opts.pop("batch", 12)),
        attn=opts.pop("attn", "xla"),
        remat=opts.pop("remat", "dots"),     # full|dots|dots_kernels|mlp|off
        bq=int(opts.pop("bq", 0)) or block,
        bk=int(opts.pop("bk", 0)) or block,
        steps=int(opts.pop("steps", 20)),
        mu=opts.pop("mu", "bf16"),           # bf16 | fp32
        nu=opts.pop("nu", "fp32"),           # bf16 | fp32 (adam 2nd moment)
        chunks=int(opts.pop("chunks", 0)),
        unroll=int(opts.pop("unroll", 1)),
        gqa=opts.pop("gqa", "0") == "1",
        fused=opts.pop("fused", "0") == "1",     # fused qkv projection
        int8=opts.pop("int8", "0") == "1",       # int8-forward MLP matmuls
        gateup=opts.pop("gateup", "0") == "1",   # fused gate+up MLP matmul
        hint8=opts.pop("hint8", "0") == "1",     # int8-forward lm_head
        aint8=opts.pop("aint8", "0") == "1",     # int8-forward attn projs
        i8impl=opts.pop("i8impl", "xla"))        # xla | pallas int8 matmul
    if opts:
        raise ValueError(f"unknown keys {list(opts)}")
    return out


def variant_config(o: dict):
    """``bench_config()`` with a parsed variant's changes."""
    return dataclasses.replace(
        bench_config(), attn_impl=o["attn"], attn_block_q=o["bq"],
        attn_block_k=o["bk"], scan_unroll=o["unroll"],
        attn_native_gqa=o["gqa"], fused_qkv=o["fused"], mlp_int8=o["int8"],
        mlp_fused_gateup=o["gateup"], head_int8=o["hint8"],
        attn_int8=o["aint8"], int8_impl=o["i8impl"],
        remat=o["remat"] != "off",
        remat_policy=o["remat"] if o["remat"] != "off" else "full")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_variant(spec: str, device: str | torch.device = "cuda",
                steps: Optional[int] = None) -> dict:
    """Time one variant and print its row; returns ``{spec, step_ms,
    tok_s, mfu, compile_s, loss}``. ``steps`` overrides the variant's
    ``steps`` (default 20)."""
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.train import Trainer, default_optimizer

    o = parse_spec(spec)
    dev = resolve_device(device)
    steps = o["steps"] if steps is None else steps
    cfg = variant_config(o)
    batch = o["batch"]
    gen = torch.Generator(device=dev).manual_seed(0)
    model = load_model(cfg, init_params(cfg, gen, dev,
                                        dtype=cfg.param_dtype), dev)
    trainer = Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=10, decay_steps=1000,
        mu_dtype=torch.bfloat16 if o["mu"] == "bf16" else None,
        nu_dtype=torch.bfloat16 if o["nu"] == "bf16" else None),
        loss_chunks=o["chunks"])
    seqlen = cfg.max_seq_len
    tokens = torch.randint(0, cfg.vocab_size, (batch, seqlen + 1),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev, dtype=torch.int32)
    t_compile = time.perf_counter()
    for _ in range(3):
        metrics = trainer.train_step(tokens)
    float(metrics["loss"])
    compile_s = time.perf_counter() - t_compile

    t0 = time.perf_counter()
    for _ in range(steps):
        metrics = trainer.train_step(tokens)
    loss = float(metrics["loss"])
    _sync(dev)
    dt = time.perf_counter() - t0

    tok_s = steps * batch * seqlen / dt
    mfu = tok_s * 6 * n_params(cfg) / device_peak(dev)
    print(f"{spec:45s} step={dt / steps * 1e3:7.1f}ms tok/s={tok_s:9.1f} "
          f"MFU={mfu:.4f} (compile+warmup {compile_s:.0f}s)", flush=True)
    return dict(spec=spec, step_ms=dt / steps * 1e3, tok_s=tok_s, mfu=mfu,
                compile_s=compile_s, loss=loss)


def sweep(specs, device: str | torch.device = "cuda") -> list:
    """Every variant in turn; a failure prints its ``FAILED`` row and the
    sweep goes on. Returns the rows (a failure as ``{spec, failed}``)."""
    rows = []
    for spec in specs:
        try:
            rows.append(run_variant(spec, device))
        except Exception as e:  # keep sweeping past OOMs
            print(f"{spec:45s} FAILED: {type(e).__name__}: {e}", flush=True)
            rows.append(dict(spec=spec, failed=f"{type(e).__name__}: {e}"))
        finally:
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description="train-step variants of the "
                                            "flagship")
    p.add_argument("variants", nargs="*", default=["attn=xla,batch=12"])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    resolve_device(args.device)
    return sweep(args.variants or ["attn=xla,batch=12"], args.device)


if __name__ == "__main__":
    main()
