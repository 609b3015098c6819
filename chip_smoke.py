"""Drive the PyTorch port (``tpu_on_k8s_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each reporting on lines of its own:

1. environment and build: the card's name and power limit, TF32 off, every
   kernel source under ``tpu_on_k8s_torch/ops/csrc/`` built with nvcc (one
   process per source, all at once), with each kernel's registers and
   spills, and the count of ``HGMMA`` (wgmma) instructions that
   ``cuobjdump --dump-sass`` finds in each flash kernel: the bf16 forward
   and dq kernels must have some;
2. each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes: the flash forward and the two
   backward kernels (dq, dk/dv) within stated tolerances, the forward and
   dq also at the Hopper kernels' tile edges (L 127-129, 255, 2047; D 64
   and 128; valid_len 129; segments crossing a 128-row tile) and launched
   twice on the same inputs, which must agree bit for bit; the int8 GEMM
   (also against ``torch._int_mm``), the quantize and the dequantize
   kernels bit for bit;
3. serving: ``generate`` at ``llama2_7b`` width (32 layers, bf16, random
   weights from a seed) answers a greedy batch-4 request and a sampled
   batch-1 request; the flash forward's launch count shows that each prefill
   went through it; the prefill logits with the kernel agree with the same
   model run on the plain attention;
3b. W8A16 serving: ``quantize_serving_tree(stochastic=True)`` turns the
   same weights into int8 (one quantize launch per matrix), ``generate``
   serves the greedy request from that tree, and its prefill logits are
   held against an fp32 model of its own dequantized weights; then
   ``quantize_pytree`` / ``dequantize_pytree`` round-trip the ``llama2_1b``
   fp32 masters;
4. training: a gradient gate (the first step's gradients of the kernel
   model against plain-attention models in bf16 and fp32), then ``Trainer``
   at ``llama2_1b`` (16 layers, full width, fp32 masters, bf16 compute,
   flash attention, MLP remat) takes 8 steps on one fixed batch 4 x 2048;
   the launch counts show that every layer's forward and backward went
   through the kernels, and the loss is finite and falls;
4b. int8 training: the same model with every int8 flag (``mlp_int8``,
   ``mlp_fused_gateup``, ``head_int8``, ``attn_int8``, ``int8_impl=
   "pallas"``): its first step's loss and gradients equal those of the same
   model with the int8 GEMM's plain version patched in, then 8 steps;
5. times on the card, each beside the card's name and power limit.

Then one JSON line for the kernels, the card's line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; so does a machine without CUDA. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

import torch

# H100 SXM dense peaks (NVIDIA data sheet), the denominators of bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# Stated tolerances of the forward kernel against its plain version: bf16
# outputs carry ~3 significant digits and the kernel rounds P to bf16 per K
# tile against a running max (the plain version against the final max); lse
# is fp32 from the same fp32 scores. fp32 differs only in summation order.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}
# Backward kernels, as max|kernel - plain| / max|plain| per gradient: bf16
# gradients keep 8 bits of mantissa (4e-3 of the largest value), and ds and
# p round to bf16 from fp32 values summed in another order; fp32 differs
# only in summation order.
BWD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# Prefill logits, 32 bf16 layers with random weights: rounding differences
# grow through depth, so both bf16 models are held against the same weights
# run in fp32. The plain-attention bf16 model's distance from it is the bf16
# noise floor; the kernel's model may exceed that floor by at most 25%.
LOGITS_NOISE_MULT = 1.25
# The same rule for the first training step's gradients, per parameter
# tensor: ||g - g_fp32|| / ||g_fp32|| of the kernel model may exceed the
# plain-attention bf16 model's by at most 25%. Readings on llama2_1b (see
# PERF.md): both ~4.1e-2 median, 4.8e-2 max; kernel/plain per tensor
# 1.000 median, 1.025 max.
GRAD_NOISE_MULT = 1.25

# W8A16 serving, 32 layers of random weights: rounding noise grows through
# depth, so the W8 model is held against an fp32 model of its own
# dequantized weights, as the bf16 model against the fp32 model of its
# weights; its distance may exceed the bf16 one by at most 50%. Readings:
# ratio 1.160 at llama2_7b on an H100; 1.21 on the CPU at width 2048, 32
# layers. A wrong scale or layout moves logits by O(1), far beyond it.
W8_NOISE_MULT = 1.5
# The reference's bound on a stochastic int8 tree (tests/test_speculative.py):
# max|q*s - w| <= max|w| / 60 per matrix.
W8_WEIGHT_BOUND = 1 / 60
W8_SEED = 7

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8
# The int8 GEMM at the llama2_1b training shapes, M = batch x seq rows:
# (N, K, out) for wq/wo, wk/wv, the fused gate+up, w_down and the fp32-out
# head, then ragged shapes.
INT8_CASES = [(TRAIN_BATCH * TRAIN_SEQ, 2048, 2048, torch.bfloat16),
              (TRAIN_BATCH * TRAIN_SEQ, 1024, 2048, torch.bfloat16),
              (TRAIN_BATCH * TRAIN_SEQ, 11264, 2048, torch.bfloat16),
              (TRAIN_BATCH * TRAIN_SEQ, 2048, 5632, torch.bfloat16),
              (TRAIN_BATCH * TRAIN_SEQ, 32000, 2048, torch.float32),
              (333, 1000, 200, torch.bfloat16),
              (333, 1000, 5632, torch.float32)]
# quantize: the llama2_7b matrices as the W8 tree quantizes them (rows =
# output channels; the head transposed), and ragged shapes
QUANT_CASES = [(4096, 4096, torch.bfloat16), (1024, 4096, torch.bfloat16),
               (11008, 4096, torch.bfloat16), (4096, 11008, torch.bfloat16),
               (32000, 4096, torch.bfloat16), (333, 1001, torch.bfloat16),
               (333, 1001, torch.float32)]
# dequantize: the llama2_1b fp32 masters' rows, and ragged shapes
DEQUANT_CASES = [(5632, 2048, torch.float32), (32000, 2048, torch.float32),
                 (2048, 32000, torch.float32), (333, 1001, torch.bfloat16),
                 (333, 1001, torch.float32)]
# The bf16 flash forward and dq kernels at their tile edges (128-row query
# tiles; K/V tiles of 128 keys in the forward, 64 in dq): (h, hkv, l, d,
# causal, valid_len, segments), batch 1; "tile" segments are cut at rows
# 120 and 136, across the 128-row boundary.
EDGE_CASES = ([(4, 2, l, d, True, 0, None) for d in (64, 128)
               for l in (127, 128, 129, 255, 2047)]
              + [(4, 1, 255, d, True, 129, None) for d in (64, 128)]
              + [(4, 2, 255, d, True, 0, "tile") for d in (64, 128)]
              + [(4, 4, 300, d, False, 0, "tile") for d in (64, 128)])
# the kernels whose SASS must hold wgmma (HGMMA) instructions:
# (library, kernel function name)
WGMMA_KERNELS = (("flash_fwd", "flash_fwd_sm90_kernel"),
                 ("flash_bwd", "dq_sm90_kernel"))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def hgmma_counts(lib) -> dict:
    """``HGMMA`` instructions per kernel function in the SASS of a built
    library, read with ``cuobjdump --dump-sass`` from the toolkit of the
    nvcc that built it."""
    from tpu_on_k8s_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def time_ms(fn, iters: int = 20, reps: int = 7) -> float:
    """Median device time of one ``fn()`` call: ``iters`` calls captured in
    a CUDA graph (no host launch cost inside), replayed ``reps`` times
    between CUDA events, after warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def event_ms(fn, iters: int = 10, reps: int = 5) -> float:
    """Median device time of one ``fn()`` call between CUDA events, without
    a graph (for autograd calls), after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def wall_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn()`` ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound_ms(flops: float, nbytes: float,
             peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """The least time for the work on this card: the larger of its
    operations at their tensor-core peak (bf16 unless given) and its bytes
    at the memory rate."""
    flop_s, byte_s = flops / peak, nbytes / PEAK_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s > byte_s
                                       else "bytes")


def int8_bound_ms(m, n, k, out_dtype) -> tuple[float, str]:
    """The int8 GEMM: 2·M·N·K int8 operations; xq, wq and the fp32 scales
    read once, the output written once."""
    out_bytes = torch.finfo(out_dtype).bits // 8
    return bound_ms(2 * m * n * k, m * k + n * k + 4 * (m + n)
                    + out_bytes * m * n, PEAK_INT8_OPS)


def quant_bound_ms(r, c, in_dtype) -> tuple[float, str]:
    """Quantize: x read once, int8 values and fp32 scales written once."""
    return bound_ms(0, (torch.finfo(in_dtype).bits // 8) * r * c + r * c
                    + 4 * r)


def dequant_bound_ms(r, c, out_dtype) -> tuple[float, str]:
    """Dequantize: values and scales read once, the output written once."""
    return bound_ms(0, r * c + 4 * r + (torch.finfo(out_dtype).bits // 8)
                    * r * c)


def causal_pairs(l: int, causal: bool) -> int:
    return l * (l + 1) // 2 if causal else l * l


def flash_bound_ms(b, h, hkv, l, d, causal) -> tuple[float, str]:
    """The bf16 flash forward: QK^T and PV over the kept pairs; q, k, v read
    once, o and the fp32 lse written once."""
    return bound_ms(4 * b * h * d * causal_pairs(l, causal),
                    2 * (2 * b * h * l * d + 2 * b * hkv * l * d)
                    + 4 * b * h * l)


def dq_bound_ms(b, h, hkv, l, d, causal) -> tuple[float, str]:
    """The bf16 dq kernel: QK^T, dO V^T and dS K over the kept pairs; q, dO,
    k, v, lse and delta read once, dq written once."""
    return bound_ms(6 * b * h * d * causal_pairs(l, causal),
                    2 * (3 * b * h * l * d + 2 * b * hkv * l * d)
                    + 2 * 4 * b * h * l)


def dkv_bound_ms(b, h, hkv, l, d, causal) -> tuple[float, str]:
    """The bf16 dk/dv kernel: QK^T, dO V^T, P^T dO and dS^T Q over the kept
    pairs; q, dO, k, v, lse and delta read once, dk and dv written once."""
    return bound_ms(8 * b * h * d * causal_pairs(l, causal),
                    2 * (2 * b * h * l * d + 4 * b * hkv * l * d)
                    + 2 * 4 * b * h * l)


def counts(fa) -> tuple[int, int, int]:
    return fa.launches, fa.dq_launches, fa.dkv_launches


#: each kernel's launch counter: (module key, attribute)
COUNTERS = {"flash_fwd": ("fa", "launches"),
            "flash_bwd_dq": ("fa", "dq_launches"),
            "flash_bwd_dkv": ("fa", "dkv_launches"),
            "int8_matmul": ("i8", "launches"),
            "quantize_int8": ("qz", "quant_launches"),
            "dequantize_int8": ("qz", "dequant_launches")}


def reset_counts(mods) -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    for key, attr in COUNTERS.values():
        setattr(mods[key], attr, 0)


def read_counts(mods) -> dict:
    """Every kernel's launch count, just after a path ran."""
    return {name: getattr(mods[key], attr)
            for name, (key, attr) in COUNTERS.items()}


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def check_int8_kernels(i8, qz, randn, misses: list) -> dict:
    """Phase 2 for the int8 GEMM, quantize and dequantize kernels: each
    against its plain version bit for bit (the GEMM also against the
    ``torch._int_mm`` route). Returns max |kernel - plain| per kernel."""
    errs = {"int8_matmul": 0.0, "quantize_int8": 0.0, "dequantize_int8": 0.0}
    for m, n, k, out in INT8_CASES:
        xq, sx = i8._quant_rows(randn(m, k))
        wq, sw = i8._quant_rows(randn(n, k) * 0.02)
        got = i8.int8_matmul_kernel(xq, sx, wq, sw, out)
        plain = i8.int8_matmul_plain(xq, sx, wq, sw, out)
        lib = i8._int_mm(xq, sx, wq, sw, out)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        same, same_lib = torch.equal(got, plain), torch.equal(got, lib)
        ok = same and same_lib and bool(torch.isfinite(got).all())
        errs["int8_matmul"] = max(errs["int8_matmul"], err)
        label = f"int8_matmul M={m} N={n} K={k} out {dtype_name(out)}"
        print(f"[kernel] {label}: max|kernel-plain| {err:.3e}; bit-identical "
              f"to plain {same}, to the torch._int_mm route {same_lib} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
        del xq, wq, got, plain, lib
    for r, c, dtype in QUANT_CASES:
        x = randn(r, c, dtype=dtype) * 0.02
        values, scales = qz.quantize_int8(x, seed=W8_SEED)
        pvalues, pscales = qz.quantize_int8_plain(x, seed=W8_SEED)
        torch.cuda.synchronize()
        err = (values.int() - pvalues.int()).abs().max().item()
        ok = torch.equal(values, pvalues) and torch.equal(scales, pscales)
        errs["quantize_int8"] = max(errs["quantize_int8"], float(err))
        label = f"quantize_int8 R={r} C={c} {dtype_name(dtype)}"
        print(f"[kernel] {label}: values and scales bit-identical to plain "
              f"{ok} (max |value diff| {err}) {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    for r, c, dtype in DEQUANT_CASES:
        values, scales = qz.quantize_int8(randn(r, c, dtype=torch.float32),
                                          seed=1)
        got = qz.dequantize_int8(values, scales, dtype)
        plain = qz.dequantize_int8_plain(values, scales, dtype)
        torch.cuda.synchronize()
        err = (got.float() - plain.float()).abs().max().item()
        ok = torch.equal(got, plain)
        errs["dequantize_int8"] = max(errs["dequantize_int8"], err)
        label = f"dequantize_int8 R={r} C={c} -> {dtype_name(dtype)}"
        print(f"[kernel] {label}: max|kernel-plain| {err:.3e}, bit-identical "
              f"{ok} {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    return errs


def dequantized(wparams: dict) -> dict:
    """The bf16-layout state dict of a W8 tree's dequantized weights, q·s
    in fp32 (other tensors as they are)."""
    out = {}
    for name, t in wparams.items():
        if name == "lm_head_q":
            out["lm_head"] = t.float() * wparams["lm_head_scale"]
        elif name.endswith(".weight_q"):
            out[name[:-2]] = t.float() * wparams[name[:-2] + "_scale"][:, None]
        elif not (name.endswith(".weight_scale") or name == "lm_head_scale"):
            out[name] = t
    return out


def serve_w8(cfg, params, prompt4, prefill_logits, mods, convert, decode):
    """Phase 3b: the W8A16 tree of ``params`` through the quantize kernel,
    served; the checks; prefill and decode times. Returns the readings."""
    n_mats = 7 * cfg.n_layers + 1
    reset_counts(mods)
    t0 = time.perf_counter()
    wcfg, wparams = convert.quantize_serving_tree(cfg, params,
                                                  stochastic=True,
                                                  seed=W8_SEED)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    after_convert = read_counts(mods)
    w8_gb = sum(t.numel() * t.element_size() for n, t in wparams.items()
                if n.endswith("_q") or n.endswith("_scale")) / 1e9
    print(f"[serve-w8] quantize_serving_tree(stochastic=True, seed="
          f"{W8_SEED}): {after_convert['quantize_int8']} quantize launches for "
          f"{n_mats} matrices in {convert_s:.2f} s; int8 weights and scales "
          f"{w8_gb:.2f} GB")
    others = [v for k, v in after_convert.items() if k != "quantize_int8"]
    if any(others) or after_convert["quantize_int8"] != n_mats:
        fail(f"conversion launches {after_convert}; expected {n_mats} "
             f"quantize launches and nothing else")
    worst = 0.0
    for name, q in wparams.items():
        if not name.endswith("_q"):
            continue
        if name == "lm_head_q":
            w, back = params["lm_head"], q.float() * wparams["lm_head_scale"]
        else:
            w = params[name[:-2]]
            back = q.float() * wparams[name[:-2] + "_scale"][:, None]
        worst = max(worst, (back - w.float()).abs().max().item()
                    / (w.float().abs().max().item() * W8_WEIGHT_BOUND))
        del back
    print(f"[serve-w8] every matrix: max|q*s - w| / (max|w| / 60) at most "
          f"{worst:.4f} (limit 1)")
    if worst > 1:
        fail("a stochastic int8 matrix strays beyond the reference's bound")

    greedy = decode.generate(wcfg, wparams, prompt4, 64)
    torch.cuda.synchronize()
    path = read_counts(mods)
    print(f"[serve-w8] request 1 from the int8 tree: batch 4 x prompt 512 -> "
          f"64 tokens, greedy; launches {path}")
    if path["flash_fwd"] != cfg.n_layers or path["quantize_int8"] != n_mats:
        fail(f"W8 serving launches {path}: expected {cfg.n_layers} flash_fwd "
             f"for the prefill")
    if tuple(greedy.shape) != (4, 64) or greedy.dtype != torch.int32 or \
            int(greedy.min()) < 0 or int(greedy.max()) >= cfg.vocab_size:
        fail(f"W8 tokens {tuple(greedy.shape)} {greedy.dtype} out of range")
    if not torch.equal(decode.generate(wcfg, wparams, prompt4, 64), greedy):
        fail("a repeated W8 greedy run gave other tokens")
    print(f"[serve-w8] greedy row 0: {greedy[0, :16].tolist()} ...; tokens "
          f"in [0, vocab); repeated run identical")

    lw8 = prefill_logits(wcfg, wparams)
    lbf16 = prefill_logits(cfg, params)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    deq = dequantized(wparams)
    ldeq = prefill_logits(f32, deq)
    del deq
    full = {n: p.float() for n, p in params.items()}
    l32 = prefill_logits(f32, full)
    del full
    torch.cuda.synchronize()
    noise_w8 = (lw8 - ldeq).abs().max().item()
    noise_bf16 = (lbf16 - l32).abs().max().item()
    rel = ((lw8 - lbf16).abs().max() / lbf16.abs().max()).item()
    agree = (lw8.argmax(-1) == lbf16.argmax(-1)).float().mean().item()
    print(f"[serve-w8] prefill logits [4, 512, {cfg.vocab_size}]: max|W8 - "
          f"fp32 model of its dequantized weights| {noise_w8:.3e} (tol "
          f"{W8_NOISE_MULT:g} x bf16 noise {noise_bf16:.3e} = max|bf16 - fp32 "
          f"model|; ratio {noise_w8 / noise_bf16:.3f})")
    print(f"[serve-w8] reading, not a gate: max|W8 - bf16| / max|bf16| = "
          f"{rel:.4f} (the reference's 0.05 gate of its 2-layer width-64 "
          f"test; 32 layers of random weights amplify the int8 rounding); "
          f"argmax agreement W8/bf16 {agree:.4f}")
    if not bool(torch.isfinite(lw8).all()):
        fail("W8 prefill logits not finite")
    if noise_w8 > W8_NOISE_MULT * noise_bf16:
        fail("the W8 model strays further from the fp32 model of its weights "
             "than bf16 rounding explains")
    del lw8, lbf16, ldeq, l32
    prefill_ms = wall_ms(lambda: decode.generate(wcfg, wparams, prompt4, 1))
    gen64_ms = wall_ms(lambda: decode.generate(wcfg, wparams, prompt4, 64))
    return {"counts": path, "prefill_ms": prefill_ms, "gen64_ms": gen64_ms,
            "decode_ms": (gen64_ms - prefill_ms) / 63, "rel": rel,
            "ratio": noise_w8 / noise_bf16, "convert_s": convert_s,
            "gb": w8_gb}


def pytree_roundtrip(tparams: dict, mods) -> dict:
    """Phase 3b's second path: ``quantize_pytree`` / ``dequantize_pytree``
    over fp32 master weights, with the reference's checks."""
    qz = mods["qz"]
    reset_counts(mods)
    packed = qz.quantize_pytree(tparams, seed=W8_SEED)
    back = qz.dequantize_pytree(packed)
    torch.cuda.synchronize()
    path = read_counts(mods)
    n_q8 = sum(kind == "q8" for kind, _ in packed.values())
    raw = small = 0
    excess = -1.0
    for name, (kind, payload) in packed.items():
        if kind != "q8":
            continue
        values, scales, shape, _ = payload
        x = tparams[name].reshape(-1, shape[-1])
        err = (back[name].reshape(x.shape) - x).abs()
        excess = max(excess, (err - scales - 1e-6).max().item())
        raw += x.numel() * x.element_size()
        small += values.numel() + scales.numel() * 4
    print(f"[pytree] quantize_pytree -> dequantize_pytree on the llama2_1b fp32 "
          f"masters: {n_q8} matrices, launches {path}; max(|back - x| - "
          f"scale) per row {excess:.3e} (must be <= 1e-6); packed/raw "
          f"{small / raw:.4f} (limit 1/3.8 = {1 / 3.8:.4f})")
    if path["quantize_int8"] != n_q8 or path["dequantize_int8"] != n_q8:
        fail(f"pytree launches {path}; expected {n_q8} of each")
    if excess > 0 or not small / raw < 1 / 3.8:
        fail("pytree round trip out of bounds")
    del packed, back
    return {"counts": path}


def fuse_gateup(params: dict, n_layers: int) -> dict:
    """The same weights in the ``mlp_fused_gateup`` layout (gate first)."""
    out = dict(params)
    for i in range(n_layers):
        p = f"blocks.{i}.mlp."
        out[p + "w_gateup.weight"] = torch.cat(
            [out.pop(p + "w_gate.weight"), out.pop(p + "w_up.weight")])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    from tpu_on_k8s_torch.models import convert, decode, transformer
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.ops import _build
    from tpu_on_k8s_torch.ops import flash_attention as fa
    from tpu_on_k8s_torch.ops import int8_matmul as i8
    from tpu_on_k8s_torch.ops import quantization as qz
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train import trainer as trainer_mod

    mods = {"fa": fa, "i8": i8, "qz": qz}
    by_path = {}    # path -> every kernel's launches in that path's run
    t_start = time.perf_counter()
    # ---- 1. environment and build --------------------------------------
    gpu = gpu_line()
    print(f"[env] nvidia-smi: {gpu}")
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[env] torch.backends.cuda.matmul.allow_tf32 = False: fp32 "
          "matmuls run at full fp32 precision")
    t0 = time.perf_counter()
    paths = _build.build_all()
    print(f"[build] {', '.join(paths)} with nvcc {' '.join(_build.NVCC_FLAGS)}"
          f", in parallel, in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if ("registers" in line or "spill" in line or "Compiling" in line
                    or "wgmma" in line or "setmaxnreg" in line):
                print(f"[build] {name}: {line.strip()}")
    for name, kernel in WGMMA_KERNELS:
        found = {fn: n for fn, n in hgmma_counts(paths[name]).items()
                 if kernel in fn}
        for fn, n in found.items():
            print(f"[build] {name}: {n} HGMMA instructions in {fn}")
        if not found or not all(found.values()):
            fail(f"{kernel} holds no wgmma (HGMMA) instructions: {found}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def qkv(b, h, hkv, l, d, dtype):
        return (randn(b, h, l, d, dtype=dtype), randn(b, hkv, l, d, dtype=dtype),
                randn(b, hkv, l, d, dtype=dtype))

    def segments_for(b, l):
        # three packed documents per row, boundaries drawn per row
        cuts = torch.sort(torch.randint(1, l, (b, 2), generator=gen,
                                        device=dev), dim=-1).values
        pos = torch.arange(l, device=dev)
        return ((pos[None] >= cuts[:, :1]).int()
                + (pos[None] >= cuts[:, 1:]).int()).to(torch.int32)

    def segments_across_tile(b, l):
        # three documents per row cut at rows 120 and 136 (across row 128)
        pos = torch.arange(l, device=dev)
        return ((pos >= 120).int() + (pos >= 136).int()).to(
            torch.int32)[None].repeat(b, 1)

    # ---- 2. kernels against their plain versions -----------------------
    cases = [  # (b, h, hkv, l, d, dtype, causal, valid_len, segmented)
        (2, 32, 8, 512, 128, torch.bfloat16, True, 0, False),
        (2, 32, 8, 333, 128, torch.bfloat16, True, 0, False),
        (2, 32, 8, 512, 128, torch.bfloat16, False, 0, False),
        (2, 32, 8, 333, 128, torch.bfloat16, True, 0, True),
        (2, 32, 8, 512, 128, torch.bfloat16, True, 400, False),
        (2, 16, 8, 333, 64, torch.bfloat16, True, 0, False),
        (2, 16, 16, 200, 64, torch.bfloat16, False, 0, True),
        (2, 32, 8, 333, 128, torch.float32, True, 0, False),
        (2, 32, 8, 333, 128, torch.float32, False, 0, True),
        (2, 16, 4, 200, 64, torch.float32, True, 150, False),
    ]
    misses = []
    bf16_err = 0.0
    for b, h, hkv, l, d, dtype, causal, valid, segmented in cases:
        q, k, v = qkv(b, h, hkv, l, d, dtype)
        seg = segments_for(b, l) if segmented else None
        o, lse = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
        po, plse = fa.flash_attention_plain(q, k, v, causal, valid, seg)
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        tol_o, tol_lse = TOL[dtype]
        ok = (err_o <= tol_o and err_lse <= tol_lse
              and bool(torch.isfinite(o).all()))
        if dtype == torch.bfloat16:
            bf16_err = max(bf16_err, err_o)
        label = (f"B={b} H={h} Hkv={hkv} L={l} D={d} "
                 f"{dtype_name(dtype)} causal={causal} "
                 f"valid_len={valid} segments={segmented}")
        print(f"[kernel] flash_fwd {label}: max|o-plain| {err_o:.3e} "
              f"(tol {tol_o:g}) max|lse-plain| {err_lse:.3e} "
              f"(tol {tol_lse:g}) {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    # the serving path's own calls: contiguous [B, L, H, D] projections (as
    # ``Attention`` makes them) through ``flash_attention``, so the kernel
    # reads strided [B, H, L, D] views; at both requests' prefill shapes
    tol_o, tol_lse = TOL[torch.bfloat16]
    for b, l in ((4, 512), (1, 333)):
        h, hkv, d = 32, 8, 128
        q, k, v = (torch.randn(b, l, n, d, generator=gen, device=dev)
                   .to(torch.bfloat16) for n in (h, hkv, hkv))
        with torch.no_grad():
            got = fa.flash_attention(q, k, v, causal=True)
        views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        _, lse = fa.flash_with_lse_fwd(*views, True)
        po, plse = fa.flash_attention_plain(*views, True)
        torch.cuda.synchronize()
        err_o = (got.float() - po.transpose(1, 2).float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        ok = (err_o <= tol_o and err_lse <= tol_lse
              and bool(torch.isfinite(got).all()))
        bf16_err = max(bf16_err, err_o)
        label = f"flash_attention [B,L,H,D] B={b} L={l} H={h} Hkv={hkv} D={d}"
        print(f"[kernel] {label} bf16 causal: max|o-plain| {err_o:.3e} "
              f"(tol {tol_o:g}) max|lse-plain| {err_lse:.3e} "
              f"(tol {tol_lse:g}) {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)

    # backward: dq, dk, dv from the kernels against the plain twins, from
    # the forward kernel's o and lse; the llama2_7b (32/8) and llama2_1b
    # (16/8, and 16/16 after the training path's repeat) head shapes
    bwd_cases = [  # (b, h, hkv, l, d, dtype, causal, valid, segmented, g_lse)
        (2, 32, 8, 512, 128, torch.bfloat16, True, 0, False, False),
        (2, 32, 8, 333, 128, torch.bfloat16, True, 0, False, False),
        (2, 32, 8, 512, 128, torch.bfloat16, False, 0, False, False),
        (2, 32, 8, 512, 128, torch.bfloat16, True, 400, False, False),
        (2, 16, 8, 512, 128, torch.bfloat16, True, 0, False, False),
        (2, 16, 8, 333, 128, torch.bfloat16, False, 0, True, False),
        (2, 16, 16, 333, 128, torch.bfloat16, True, 0, True, False),
        (2, 16, 4, 333, 64, torch.bfloat16, True, 0, False, False),
        (2, 16, 8, 512, 128, torch.bfloat16, True, 0, False, True),
        (TRAIN_BATCH, 16, 16, TRAIN_SEQ, 128, torch.bfloat16, True, 0, False,
         False),
        (2, 32, 8, 333, 128, torch.float32, True, 0, False, False),
        (2, 16, 8, 333, 128, torch.float32, False, 0, True, False),
        (2, 16, 4, 200, 64, torch.float32, True, 150, False, True),
    ]
    bwd_err = {"dq": 0.0, "dkv": 0.0}
    for b, h, hkv, l, d, dtype, causal, valid, segmented, cot in bwd_cases:
        q, k, v = qkv(b, h, hkv, l, d, dtype)
        do = randn(b, h, l, d, dtype=dtype)
        g_lse = randn(b, h, 1, l, dtype=torch.float32) if cot else None
        seg = segments_for(b, l) if segmented else None
        o, lse = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
        got = fa.flash_bwd(q, k, v, o, lse, do, causal, valid, seg, g_lse)
        delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
        if cot:
            delta = delta - g_lse
        want = (fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, valid,
                                      seg),
                *fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                        valid, seg))
        torch.cuda.synchronize()
        label = (f"B={b} H={h} Hkv={hkv} L={l} D={d} "
                 f"{dtype_name(dtype)} causal={causal} "
                 f"valid_len={valid} segments={segmented} lse_cotangent={cot}")
        parts, ok = [], True
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - w.float()).abs().max().item()
            rel = err / w.float().abs().max().item()
            ok = ok and rel <= BWD_REL_TOL[dtype] and bool(
                torch.isfinite(a).all())
            if dtype == torch.bfloat16:
                key = "dq" if name == "dq" else "dkv"
                bwd_err[key] = max(bwd_err[key], err)
            parts.append(f"{name} max|err| {err:.3e} rel {rel:.2e}")
        print(f"[kernel] flash_bwd {label}: {', '.join(parts)} (tol rel "
              f"{BWD_REL_TOL[dtype]:g}) {'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(f"flash_bwd {label}")
        del q, k, v, do, o, lse, got, want, delta
    # the bf16 forward and dq kernels at their tile edges, each launched
    # twice on the same inputs: the two results must be bit-identical
    for h, hkv, l, d, causal, valid, seg_kind in EDGE_CASES:
        q, k, v = qkv(1, h, hkv, l, d, torch.bfloat16)
        do = randn(1, h, l, d)
        seg = segments_across_tile(1, l) if seg_kind else None
        o, lse = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
        o2, lse2 = fa.flash_with_lse_fwd(q, k, v, causal, valid, seg)
        po, plse = fa.flash_attention_plain(q, k, v, causal, valid, seg)
        delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, valid, seg)
        dq2 = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, valid, seg)
        pdq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, valid,
                                    seg)
        torch.cuda.synchronize()
        err_o = (o.float() - po.float()).abs().max().item()
        err_lse = (lse - plse).abs().max().item()
        err_dq = (dq.float() - pdq.float()).abs().max().item()
        rel_dq = err_dq / pdq.float().abs().max().item()
        same = (torch.equal(o, o2) and torch.equal(lse, lse2)
                and torch.equal(dq, dq2))
        tol_o, tol_lse = TOL[torch.bfloat16]
        ok = (err_o <= tol_o and err_lse <= tol_lse
              and rel_dq <= BWD_REL_TOL[torch.bfloat16] and same
              and bool(torch.isfinite(o).all())
              and bool(torch.isfinite(dq).all()))
        bf16_err = max(bf16_err, err_o)
        bwd_err["dq"] = max(bwd_err["dq"], err_dq)
        label = (f"edge B=1 H={h} Hkv={hkv} L={l} D={d} bf16 causal={causal} "
                 f"valid_len={valid} segments={seg_kind}")
        print(f"[kernel] flash_fwd + flash_bwd_dq {label}: max|o-plain| "
              f"{err_o:.3e} max|lse-plain| {err_lse:.3e} dq rel {rel_dq:.2e} "
              f"(tols {tol_o:g}, {tol_lse:g}, {BWD_REL_TOL[torch.bfloat16]:g}"
              f"); two launches bit-identical {same} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            misses.append(label)
    # determinism at the training shape, where every block runs many tiles
    q, k, v = qkv(TRAIN_BATCH, 16, 16, TRAIN_SEQ, 128, torch.bfloat16)
    do = randn(TRAIN_BATCH, 16, TRAIN_SEQ, 128)
    o, lse = fa.flash_with_lse_fwd(q, k, v, True)
    o2, lse2 = fa.flash_with_lse_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    same = (torch.equal(o, o2) and torch.equal(lse, lse2) and torch.equal(
        fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
        fa.flash_bwd_dq(q, k, v, do, lse, delta, True)))
    print(f"[kernel] flash_fwd + flash_bwd_dq B={TRAIN_BATCH} H=16 "
          f"L={TRAIN_SEQ} D=128 bf16 causal: two launches bit-identical "
          f"{same} {'ok' if same else 'MISS'}")
    if not same:
        misses.append("determinism at the training shape")
    del q, k, v, do, o, o2, lse, lse2, delta
    int8_errs = check_int8_kernels(i8, qz, randn, misses)
    if misses:
        fail(f"kernels disagree with their plain versions: {misses}")

    # ---- 3. serving: generate at llama2_7b width -----------------------
    cfg = transformer.TransformerConfig.llama2_7b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"[serve] llama2_7b: {cfg.n_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params in "
          f"{dtype_name(cfg.dtype)} "
          f"({sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.2f} GB), "
          f"init {time.perf_counter() - t0:.1f} s")
    pgen = torch.Generator(device=dev).manual_seed(1)
    prompt4 = torch.randint(0, cfg.vocab_size, (4, 512), generator=pgen,
                            device=dev, dtype=torch.int32)
    prompt1 = torch.randint(0, cfg.vocab_size, (1, 333), generator=pgen,
                            device=dev, dtype=torch.int32)

    reset_counts(mods)
    greedy = decode.generate(cfg, params, prompt4, 64)
    torch.cuda.synchronize()
    after_greedy = fa.launches
    sampled = decode.generate(cfg, params, prompt1, 32, temperature=0.8,
                              top_p=0.9,
                              generator=torch.Generator(device=dev)
                              .manual_seed(2))
    torch.cuda.synchronize()
    serve_counts = counts(fa)
    by_path["serve"] = read_counts(mods)
    print(f"[serve] request 1: batch 4 x prompt 512 -> 64 tokens, greedy; "
          f"flash_fwd launches {after_greedy}")
    print(f"[serve] request 2: batch 1 x prompt 333 -> 32 tokens, "
          f"temperature 0.8 top_p 0.9; flash_fwd launches "
          f"{serve_counts[0] - after_greedy}")
    print(f"[serve] greedy row 0: {greedy[0, :16].tolist()} ...")
    print(f"[serve] sampled row 0: {sampled[0, :16].tolist()} ...")
    if (after_greedy != cfg.n_layers
            or serve_counts != (2 * cfg.n_layers, 0, 0)):
        fail(f"serving launches (flash_fwd, dq, dkv) {serve_counts}, first "
             f"prefill {after_greedy}; expected {cfg.n_layers} flash_fwd per "
             f"prefill and no backward")
    for name, toks, shape in (("greedy", greedy, (4, 64)),
                              ("sampled", sampled, (1, 32))):
        if tuple(toks.shape) != shape or toks.dtype != torch.int32:
            fail(f"{name} tokens {tuple(toks.shape)} {toks.dtype}")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
            fail(f"{name} tokens outside [0, {cfg.vocab_size})")
    again = decode.generate(cfg, params, prompt4, 64)
    if not torch.equal(again, greedy):
        fail("a repeated greedy run gave other tokens")
    print("[serve] tokens in [0, vocab); repeated greedy run identical")

    def plain_flash(q, k, v, causal=True, segments=None):
        o, _ = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                        v.transpose(1, 2), causal, 0, segments)
        return o.transpose(1, 2)

    def prefill_logits(model_cfg, model_params):
        bcfg = dataclasses.replace(model_cfg, max_seq_len=decode._bucket_len(
            512 + 64, model_cfg.max_seq_len))
        model = decode.decode_model(bcfg, model_params, dev)
        with torch.inference_mode():
            return model(prompt4, None, decode.init_cache(model, 4))

    before = fa.launches
    logits_kernel = prefill_logits(cfg, params)
    if fa.launches - before != cfg.n_layers:
        fail("the kernel prefill did not launch flash_fwd once per layer")
    with mock.patch.object(transformer, "flash_attention", plain_flash):
        logits_plain = prefill_logits(cfg, params)
        # the same weights in fp32, activations in fp32: the reference
        # that shows how far bf16 rounding alone moves the logits
        logits_f32 = prefill_logits(
            dataclasses.replace(cfg, dtype=torch.float32),
            {name: p.float() for name, p in params.items()})
    torch.cuda.synchronize()
    diff = (logits_kernel - logits_plain).abs().max().item()
    noise = (logits_plain - logits_f32).abs().max().item()
    kernel_noise = (logits_kernel - logits_f32).abs().max().item()
    agree = (logits_kernel.argmax(-1) == logits_plain.argmax(-1)).float()
    print(f"[serve] prefill logits [4, 512, {cfg.vocab_size}] fp32: "
          f"max|kernel bf16 - fp32 model| {kernel_noise:.3e} (tol "
          f"{LOGITS_NOISE_MULT:g} x bf16 noise {noise:.3e} = max|plain bf16 "
          f"- fp32 model|); max|kernel - plain| {diff:.3e}; max |logit| "
          f"{logits_plain.abs().max().item():.3e}; argmax agreement "
          f"kernel/plain {agree.mean().item():.4f}")
    if not bool(torch.isfinite(logits_kernel).all()):
        fail("prefill logits not finite")
    if kernel_noise > LOGITS_NOISE_MULT * noise:
        fail("prefill logits with the kernel stray further from the fp32 "
             "model than bf16 rounding explains")
    del logits_kernel, logits_plain, logits_f32
    prefill_ms = wall_ms(lambda: decode.generate(cfg, params, prompt4, 1))
    gen64_ms = wall_ms(lambda: decode.generate(cfg, params, prompt4, 64))
    decode_ms = (gen64_ms - prefill_ms) / 63

    # ---- 3b. W8A16 serving from the same weights -----------------------
    w8 = serve_w8(cfg, params, prompt4, prefill_logits, mods, convert, decode)
    by_path["serve_w8"] = w8["counts"]
    del params
    torch.cuda.empty_cache()

    # ---- 4. training: llama2_1b, full width and depth ------------------
    tcfg = dataclasses.replace(transformer.TransformerConfig.llama2_1b(),
                               remat=True, remat_policy="mlp",
                               attn_impl="flash")
    tgen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    tparams = init_params(tcfg, tgen, dev, dtype=tcfg.param_dtype)
    tokens = torch.randint(0, tcfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=tgen, device=dev, dtype=torch.int32)
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in tparams.values())
    print(f"[train] llama2_1b: {tcfg.n_layers} layers d_model {tcfg.d_model} "
          f"heads {tcfg.n_heads}/{tcfg.n_kv_heads} d_ff {tcfg.d_ff} vocab "
          f"{tcfg.vocab_size}, {n_train:,} params, fp32 masters, bf16 "
          f"compute, attn flash (kv repeated to {tcfg.n_heads} heads), "
          f"remat mlp; batch {TRAIN_BATCH} x seq {TRAIN_SEQ}; init "
          f"{time.perf_counter() - t0:.1f} s")
    by_path["pytree"] = pytree_roundtrip(tparams, mods)["counts"]
    torch.cuda.empty_cache()

    # the gradient gate: the first step's gradients on these weights, with
    # remat "full" to bound memory, from the kernel model and from
    # plain-attention models in bf16 and in fp32
    def plain_bhld(q, k, v, causal=True, valid_len=0, segments=None):
        return fa.flash_attention_plain(q, k, v, causal, valid_len,
                                        segments)[0]

    def first_grads(model_cfg, plain):
        model = load_model(model_cfg, tparams, dev)
        loss_fn = trainer_mod._make_loss_fn(model, 0, None)
        patch = (mock.patch.object(transformer, "flash_attention_bhld",
                                   plain_bhld) if plain else nullcontext())
        with patch:
            loss, _ = loss_fn(tokens)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        return loss.item(), dict(zip(names, grads))

    gcfg = dataclasses.replace(tcfg, remat_policy="full")
    reset_counts(mods)
    loss_k, grads_k = first_grads(gcfg, plain=False)
    torch.cuda.synchronize()
    full_counts = counts(fa)
    loss_p, grads_p = first_grads(gcfg, plain=True)
    loss_32, grads_32 = first_grads(
        dataclasses.replace(gcfg, dtype=torch.float32), plain=True)
    torch.cuda.synchronize()
    print(f"[train] remat full, one forward+backward: launches flash_fwd "
          f"{full_counts[0]}, dq {full_counts[1]}, dkv {full_counts[2]} "
          f"(the forward runs again in each block's recompute)")
    if full_counts != (2 * tcfg.n_layers, tcfg.n_layers, tcfg.n_layers):
        fail(f"remat full launches {full_counts}; expected "
             f"({2 * tcfg.n_layers}, {tcfg.n_layers}, {tcfg.n_layers})")

    def rel_dist(g, ref):
        return {n: ((g[n].float() - ref[n]).norm() / ref[n].norm()).item()
                for n in ref}

    dist_k, dist_p = rel_dist(grads_k, grads_32), rel_dist(grads_p, grads_32)
    worst_k, worst_p = max(dist_k.values()), max(dist_p.values())
    ratios = sorted(dist_k[n] / dist_p[n] for n in dist_k)
    worst_name = max(dist_k, key=dist_k.get)
    print(f"[train] gradient gate, step 1, {len(dist_k)} tensors, "
          f"||g - g_fp32|| / ||g_fp32||: kernel bf16 max {worst_k:.4e} "
          f"(at {worst_name}), median {statistics.median(dist_k.values()):.4e}"
          f"; plain bf16 max {worst_p:.4e}, median "
          f"{statistics.median(dist_p.values()):.4e}; per-tensor ratio "
          f"kernel/plain median {statistics.median(ratios):.3f}, max "
          f"{ratios[-1]:.3f} (limit {GRAD_NOISE_MULT:g})")
    print(f"[train] gradient gate, step-1 loss: kernel bf16 {loss_k:.6f}, "
          f"plain bf16 {loss_p:.6f}, fp32 {loss_32:.6f}")
    for name in ("embed", "blocks.0.attn.wq.weight", "blocks.0.attn.wk.weight",
                 "blocks.15.attn.wv.weight", "blocks.15.mlp.w_down.weight",
                 "lm_head"):
        print(f"[train]   {name}: kernel {dist_k[name]:.4e} plain "
              f"{dist_p[name]:.4e}")
    if not all(torch.isfinite(g).all() for g in grads_k.values()):
        fail("kernel-model gradients not finite")
    if ratios[-1] > GRAD_NOISE_MULT:
        fail("the kernel model's gradients stray further from the fp32 "
             "model's than bf16 rounding explains")
    del grads_k, grads_p, grads_32
    torch.cuda.empty_cache()

    model = load_model(tcfg, tparams, dev)
    trainer = Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=10,
        decay_steps=max(TRAIN_STEPS, 11)))
    torch.cuda.reset_peak_memory_stats()
    losses, norms, step_ms = [], [], []
    reset_counts(mods)
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = trainer.train_step(tokens)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_counts = counts(fa)
    by_path["train"] = read_counts(mods)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] {TRAIN_STEPS} steps on one fixed batch: loss "
          f"{[round(x, 5) for x in losses]}")
    print(f"[train] grad_norm {[round(x, 4) for x in norms]}")
    print(f"[train] launches over {TRAIN_STEPS} steps: flash_fwd "
          f"{train_counts[0]}, dq {train_counts[1]}, dkv {train_counts[2]} "
          f"({tcfg.n_layers} layers, remat mlp)")
    want = tuple(TRAIN_STEPS * tcfg.n_layers for _ in range(3))
    if train_counts != want:
        fail(f"training launches {train_counts}; expected {want}: one "
             f"flash_fwd, dq and dkv per layer per step")
    if not all(map(math.isfinite, losses)):
        fail(f"training loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    train_ms = statistics.median(step_ms[1:])
    print(f"[train] step wall ms {[round(x, 1) for x in step_ms]}; median "
          f"of steps 2-{TRAIN_STEPS} {train_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train_ms * 1e3:,.0f} tokens/s; peak "
          f"memory {peak_gb:.2f} GB")
    del trainer, model, tparams
    torch.cuda.empty_cache()

    # ---- 4b. int8 training: the same model with every int8 flag --------
    i8cfg = dataclasses.replace(tcfg, mlp_int8=True, mlp_fused_gateup=True,
                                head_int8=True, attn_int8=True,
                                int8_impl="pallas")
    # the same initial weights as phase 4 (same seed), gate+up fused
    p8 = fuse_gateup(init_params(tcfg, torch.Generator(device=dev)
                                 .manual_seed(0), dev,
                                 dtype=tcfg.param_dtype), tcfg.n_layers)
    # per step: q, k, v, o and the MLP's gate+up and down in every layer,
    # the MLP again in its backward recompute (remat "mlp"), and the head
    int8_per_step = (4 + 2 + 2) * tcfg.n_layers + 1

    def int8_grads(model_cfg, plain):
        model = load_model(model_cfg, p8, dev)
        loss_fn = trainer_mod._make_loss_fn(model, 0, None)
        patch = (mock.patch.object(i8, "int8_matmul_kernel",
                                   i8.int8_matmul_plain)
                 if plain else nullcontext())
        with patch:
            loss, _ = loss_fn(tokens)
            grads = torch.autograd.grad(loss, list(model.parameters()))
        names = [n for n, _ in model.named_parameters()]
        return loss.item(), dict(zip(names, grads))

    reset_counts(mods)
    loss_k8, grads_k8 = int8_grads(i8cfg, plain=False)
    torch.cuda.synchronize()
    gate8_counts = read_counts(mods)
    loss_p8, grads_p8 = int8_grads(i8cfg, plain=True)
    torch.cuda.synchronize()
    print(f"[train-int8] llama2_1b with mlp_int8, mlp_fused_gateup, "
          f"head_int8, attn_int8, int8_impl pallas, remat mlp, flash; one "
          f"forward+backward: launches {gate8_counts} (int8_matmul expected "
          f"{int8_per_step})")
    if (gate8_counts["int8_matmul"] != int8_per_step
            or gate8_counts["flash_fwd"] != tcfg.n_layers):
        fail(f"int8 step launches {gate8_counts}; expected {int8_per_step} "
             f"int8_matmul")
    same = [n for n in grads_k8 if torch.equal(grads_k8[n], grads_p8[n])]
    rel8 = max(((grads_k8[n].float() - grads_p8[n].float()).norm()
                / grads_p8[n].float().norm()).item() for n in grads_k8)
    print(f"[train-int8] gate, step 1: loss kernel {loss_k8:.6f}, plain "
          f"int8 GEMM {loss_p8:.6f} (equal {loss_k8 == loss_p8}); gradients "
          f"bit-identical in {len(same)} of {len(grads_k8)} tensors, max "
          f"||g - g_plain|| / ||g_plain|| {rel8:.3e}")
    if loss_k8 != loss_p8 or len(same) != len(grads_k8):
        fail("the int8 kernel model's first step differs from the same model "
             "with the int8 GEMM's plain version")
    del grads_p8
    loss_b8, grads_b8 = int8_grads(dataclasses.replace(
        i8cfg, mlp_int8=False, head_int8=False, attn_int8=False), plain=False)
    dist8 = {n: ((grads_k8[n].float() - grads_b8[n].float()).norm()
                 / grads_b8[n].float().norm()).item() for n in grads_k8}
    print(f"[train-int8] for information, step 1 against the bf16 model of "
          f"the same weights: loss int8 {loss_k8:.6f}, bf16 {loss_b8:.6f}; "
          f"||g_int8 - g_bf16|| / ||g_bf16|| median "
          f"{statistics.median(dist8.values()):.4e}, max "
          f"{max(dist8.values()):.4e} (at {max(dist8, key=dist8.get)})")
    for name in ("embed", "blocks.0.attn.wq.weight",
                 "blocks.0.mlp.w_gateup.weight",
                 "blocks.15.mlp.w_down.weight", "lm_head"):
        print(f"[train-int8]   {name}: {dist8[name]:.4e}")
    del grads_k8, grads_b8
    torch.cuda.empty_cache()

    model = load_model(i8cfg, p8, dev)
    trainer = Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=10,
        decay_steps=max(TRAIN_STEPS, 11)))
    torch.cuda.reset_peak_memory_stats()
    losses8, step8_ms = [], []
    reset_counts(mods)
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses8.append(float(trainer.train_step(tokens)["loss"]))
        torch.cuda.synchronize()
        step8_ms.append((time.perf_counter() - t0) * 1e3)
    by_path["train_int8"] = read_counts(mods)
    peak8_gb = torch.cuda.max_memory_allocated() / 1e9
    train8_ms = statistics.median(step8_ms[1:])
    print(f"[train-int8] {TRAIN_STEPS} steps on the same batch: loss "
          f"{[round(x, 5) for x in losses8]}; launches "
          f"{by_path['train_int8']}")
    want8 = {"int8_matmul": TRAIN_STEPS * int8_per_step,
             "flash_fwd": TRAIN_STEPS * tcfg.n_layers,
             "flash_bwd_dq": TRAIN_STEPS * tcfg.n_layers,
             "flash_bwd_dkv": TRAIN_STEPS * tcfg.n_layers}
    if any(by_path["train_int8"][k] != v for k, v in want8.items()):
        fail(f"int8 training launches {by_path['train_int8']}; expected "
             f"{want8}")
    if not all(map(math.isfinite, losses8)) or not losses8[-1] < losses8[0]:
        fail(f"int8 training loss not finite or not falling: {losses8}")
    print(f"[train-int8] step wall ms {[round(x, 1) for x in step8_ms]}; "
          f"median of steps 2-{TRAIN_STEPS} {train8_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train8_ms * 1e3:,.0f} tokens/s, peak "
          f"memory {peak8_gb:.2f} GB (bf16 step {train_ms:.1f} ms, peak "
          f"{peak_gb:.2f} GB)")
    del trainer, model, p8
    torch.cuda.empty_cache()

    # ---- 5. times -----------------------------------------------------
    scfg = transformer.TransformerConfig.llama2_7b()
    b, h, hkv, l, d = 4, scfg.n_heads, scfg.n_kv_heads, 512, scfg.head_dim
    q, k, v = qkv(b, h, hkv, l, d, torch.bfloat16)
    serve_fwd_ms = time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, True))
    serve_plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, True))
    serve_sdpa_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    serve_bound, serve_by = flash_bound_ms(b, h, hkv, l, d, True)
    print(f"[time] {gpu}: flash_fwd B={b} H={h} Hkv={hkv} L={l} D={d} bf16 "
          f"causal (serving prefill): kernel {serve_fwd_ms:.4f} ms, plain "
          f"{serve_plain_ms:.4f} ms, sdpa {serve_sdpa_ms:.4f} ms, bound "
          f"{serve_bound:.4f} ms ({serve_by}); "
          f"{serve_bound / serve_fwd_ms:.1%} of bound")
    print(f"[time] {gpu}: generate llama2_7b bf16 batch 4 x prompt 512: "
          f"prefill (+1 token) {prefill_ms:.2f} ms, 64 tokens "
          f"{gen64_ms:.2f} ms, per-token decode {decode_ms:.3f} ms")

    # the training path's attention: kv repeated to 16 heads, L 2048
    b, h, hkv, l, d = TRAIN_BATCH, 16, 16, TRAIN_SEQ, 128
    q, k, v = qkv(b, h, hkv, l, d, torch.bfloat16)
    do = randn(b, h, l, d)
    o, lse = fa.flash_with_lse_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    shape = f"B={b} H={h} Hkv={hkv} L={l} D={d} bf16 causal"
    timed = {
        "flash_fwd": (
            time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, True)),
            time_ms(lambda: fa.flash_attention_plain(q, k, v, True)),
            flash_bound_ms(b, h, hkv, l, d, True)),
        "flash_bwd_dq": (
            time_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True)),
            time_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                                  True)),
            dq_bound_ms(b, h, hkv, l, d, True)),
        "flash_bwd_dkv": (
            time_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)),
            time_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                   True)),
            dkv_bound_ms(b, h, hkv, l, d, True)),
    }
    sdpa_fwd_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qg, kg, vg,
                                                           is_causal=True)
    sdpa_bwd_ms = event_ms(lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True))
    library = {"flash_fwd": sdpa_fwd_ms, "flash_bwd_dq": sdpa_bwd_ms,
               "flash_bwd_dkv": sdpa_bwd_ms}
    for name, (ms, plain, (bound, by)) in timed.items():
        print(f"[time] {gpu}: {name} {shape} (training): kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / ms:.1%} of bound; sdpa "
              f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv together)'}"
              f" {library[name]:.4f} ms")
    print(f"[time] {gpu}: train step llama2_1b batch {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} (remat mlp, flash): bf16 {train_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train_ms * 1e3:,.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB; int8 (every flag, pallas) "
          f"{train8_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train8_ms * 1e3:,.0f} tokens/s, peak "
          f"memory {peak8_gb:.2f} GB")
    print(f"[time] {gpu}: generate llama2_7b W8A16 batch 4 x prompt 512: "
          f"prefill (+1 token) {w8['prefill_ms']:.2f} ms, 64 tokens "
          f"{w8['gen64_ms']:.2f} ms, per-token decode {w8['decode_ms']:.3f} "
          f"ms (bf16: {prefill_ms:.2f}, {gen64_ms:.2f}, {decode_ms:.3f})")
    del q, k, v, do, o, lse, delta, qg, kg, vg, out
    torch.cuda.empty_cache()

    # the int8 GEMM at the training shapes: kernel, plain, and
    # torch._int_mm with the epilogue in PyTorch (the library yardstick:
    # two calls, the int32 product and then the fp32 rescale and cast)
    int8_times = {}
    for m, n, kk, out_dtype in INT8_CASES[:5]:
        xq, sx = i8._quant_rows(randn(m, kk))
        wq, sw = i8._quant_rows(randn(n, kk) * 0.02)
        ms = time_ms(lambda: i8.int8_matmul_kernel(xq, sx, wq, sw, out_dtype))
        plain = event_ms(lambda: i8.int8_matmul_plain(xq, sx, wq, sw,
                                                       out_dtype))
        lib = event_ms(lambda: i8._int_mm(xq, sx, wq, sw, out_dtype))
        bound, by = int8_bound_ms(m, n, kk, out_dtype)
        int8_times[(m, n, kk)] = (ms, plain, bound, by, lib)
        print(f"[time] {gpu}: int8_matmul M={m} N={n} K={kk} out "
              f"{dtype_name(out_dtype)}: kernel {ms:.4f} ms "
              f"({2 * m * n * kk / ms / 1e9:,.0f} TOP/s), plain {plain:.4f} "
              f"ms, torch._int_mm + epilogue {lib:.4f} ms, bound {bound:.4f} "
              f"ms ({by}), {bound / ms:.1%} of bound")
        del xq, wq
    # quantize at a llama2_7b MLP matrix (the W8 tree's largest group);
    # no single PyTorch call rounds stochastically, so no library time
    qr, qc, qdt = 11008, 4096, torch.bfloat16
    x = randn(qr, qc, dtype=qdt) * 0.02
    quant_t = (time_ms(lambda: qz.quantize_int8(x, seed=W8_SEED)),
               event_ms(lambda: qz.quantize_int8_plain(x, seed=W8_SEED)),
               *quant_bound_ms(qr, qc, qdt), None)
    # dequantize at a llama2_1b MLP master (fp32 out); the library
    # yardstick is one torch.mul(values, scales) with type promotion
    dr, dc, ddt = 5632, 2048, torch.float32
    values, scales = qz.quantize_int8(randn(dr, dc, dtype=ddt), seed=1)
    dequant_t = (time_ms(lambda: qz.dequantize_int8(values, scales, ddt)),
                 event_ms(lambda: qz.dequantize_int8_plain(values, scales,
                                                           ddt)),
                 *dequant_bound_ms(dr, dc, ddt),
                 time_ms(lambda: torch.mul(values, scales)))
    for name, (ms, plain, bound, by, lib), label in (
            ("quantize_int8", quant_t, f"R={qr} C={qc} {dtype_name(qdt)}"),
            ("dequantize_int8", dequant_t,
             f"R={dr} C={dc} -> {dtype_name(ddt)}")):
        print(f"[time] {gpu}: {name} {label}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
              f"{bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
    print(f"[time] script {time.perf_counter() - t_start:.0f} s")

    gemm = (TRAIN_BATCH * TRAIN_SEQ, 11264, 2048)
    ms8, plain8, bound8, by8, lib8 = int8_times[gemm]
    timed.update({
        "int8_matmul": (ms8, plain8, (bound8, by8)),
        "quantize_int8": (quant_t[0], quant_t[1], quant_t[2:4]),
        "dequantize_int8": (dequant_t[0], dequant_t[1], dequant_t[2:4])})
    library.update({"int8_matmul": lib8, "quantize_int8": None,
                    "dequantize_int8": dequant_t[4]})
    shapes = {name: shape for name in ("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv")}
    shapes.update({
        "int8_matmul": "M={} N={} K={} bf16 out (the fused gate+up)".format(
            *gemm),
        "quantize_int8": f"R={qr} C={qc} bf16",
        "dequantize_int8": f"R={dr} C={dc} -> float32"})
    sources = {"flash_fwd": ("flash_fwd.cu", "flash_attention.py:131"),
               "flash_bwd_dq": ("flash_bwd.cu", "flash_attention.py:229"),
               "flash_bwd_dkv": ("flash_bwd.cu", "flash_attention.py:265"),
               "int8_matmul": ("int8_matmul.cu", "int8_matmul.py:130"),
               "quantize_int8": ("quantization.cu", "quantization.py:28"),
               "dequantize_int8": ("quantization.cu", "quantization.py:46")}
    errs = {"flash_fwd": bf16_err, "flash_bwd_dq": bwd_err["dq"],
            "flash_bwd_dkv": bwd_err["dkv"], **int8_errs}
    kernels = []
    for name, (ms, plain, (bound, by)) in timed.items():
        src, ref = sources[name]
        paths = {path: c[name] for path, c in by_path.items() if c[name]}
        if not paths:
            fail(f"{name} launched on no path")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpu_on_k8s_torch/ops/csrc/{src}",
            "replaces": f"tpu_on_k8s/ops/{ref}",
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": library[name],
            "shape": shapes[name]})
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
