"""Drive the PyTorch port (``tpu_on_k8s_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each reporting on lines of its own:

1. environment and build: the card's name and power limit, TF32 off, every
   kernel source under ``tpu_on_k8s_torch/ops/csrc/`` built with nvcc (one
   process per source, all at once), with each kernel's registers and
   spills;
2. each kernel against its plain PyTorch version on the card, at the
   serving and training paths' shapes, within stated tolerances: the flash
   forward, and the two backward kernels (dq, dk/dv);
3. serving: ``generate`` at ``llama2_7b`` width (32 layers, bf16, random
   weights from a seed) answers a greedy batch-4 request and a sampled
   batch-1 request; the flash forward's launch count shows that each prefill
   went through it; the prefill logits with the kernel agree with the same
   model run on the plain attention;
4. training: a gradient gate (the first step's gradients of the kernel
   model against plain-attention models in bf16 and fp32), then ``Trainer``
   at ``llama2_1b`` (16 layers, full width, fp32 masters, bf16 compute,
   flash attention, MLP remat) takes 8 steps on one fixed batch 4 x 2048;
   the launch counts show that every layer's forward and backward went
   through the kernels, and the loss is finite and falls;
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
from unittest import mock

import torch

# H100 SXM dense peaks (NVIDIA data sheet), the denominators of bound_ms.
PEAK_BF16_FLOPS = 989e12
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

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 2048, 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


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


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time for the work on this card: the larger of its FLOPs at
    the bf16 tensor-core peak and its bytes at the memory rate."""
    flop_s, byte_s = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s > byte_s
                                       else "bytes")


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


def reset_counts(fa) -> None:
    fa.launches = fa.dq_launches = fa.dkv_launches = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    from tpu_on_k8s_torch.models import decode, transformer
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.ops import _build
    from tpu_on_k8s_torch.ops import flash_attention as fa
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train import trainer as trainer_mod

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
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")

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
                 f"{str(dtype).split('.')[-1]} causal={causal} "
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
                 f"{str(dtype).split('.')[-1]} causal={causal} "
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
    if misses:
        fail(f"flash kernels disagree with their plain versions: {misses}")

    # ---- 3. serving: generate at llama2_7b width -----------------------
    cfg = transformer.TransformerConfig.llama2_7b()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.values())
    print(f"[serve] llama2_7b: {cfg.n_layers} layers d_model {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params in "
          f"{str(cfg.dtype).split('.')[-1]} "
          f"({sum(p.numel() * p.element_size() for p in params.values()) / 1e9:.2f} GB), "
          f"init {time.perf_counter() - t0:.1f} s")
    pgen = torch.Generator(device=dev).manual_seed(1)
    prompt4 = torch.randint(0, cfg.vocab_size, (4, 512), generator=pgen,
                            device=dev, dtype=torch.int32)
    prompt1 = torch.randint(0, cfg.vocab_size, (1, 333), generator=pgen,
                            device=dev, dtype=torch.int32)

    reset_counts(fa)
    greedy = decode.generate(cfg, params, prompt4, 64)
    torch.cuda.synchronize()
    after_greedy = fa.launches
    sampled = decode.generate(cfg, params, prompt1, 32, temperature=0.8,
                              top_p=0.9,
                              generator=torch.Generator(device=dev)
                              .manual_seed(2))
    torch.cuda.synchronize()
    serve_counts = counts(fa)
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
    reset_counts(fa)
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
    reset_counts(fa)
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        metrics = trainer.train_step(tokens)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    train_counts = counts(fa)
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
          f"{TRAIN_SEQ} (remat mlp, flash): {train_ms:.1f} ms, "
          f"{TRAIN_BATCH * TRAIN_SEQ / train_ms * 1e3:,.0f} tokens/s, peak "
          f"memory {peak_gb:.2f} GB; script "
          f"{time.perf_counter() - t_start:.0f} s")

    sources = {"flash_fwd": ("flash_fwd.cu", 131),
               "flash_bwd_dq": ("flash_bwd.cu", 229),
               "flash_bwd_dkv": ("flash_bwd.cu", 265)}
    by_path = {"flash_fwd": (serve_counts[0], train_counts[0]),
               "flash_bwd_dq": (serve_counts[1], train_counts[1]),
               "flash_bwd_dkv": (serve_counts[2], train_counts[2])}
    errs = {"flash_fwd": bf16_err, "flash_bwd_dq": bwd_err["dq"],
            "flash_bwd_dkv": bwd_err["dkv"]}
    kernels = []
    for name, (ms, plain, (bound, by)) in timed.items():
        src, line = sources[name]
        serve_n, train_n = by_path[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"tpu_on_k8s_torch/ops/csrc/{src}",
            "replaces": f"tpu_on_k8s/ops/flash_attention.py:{line}",
            "launches": serve_n + train_n,
            "launches_by_path": {"serve": serve_n, "train": train_n},
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": library[name],
            "shape": shape})
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
