"""Drive the PyTorch port (``tpu_on_k8s_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of the repository, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. Phases, each reporting on lines of its own:

1. environment and build: the card's name and power limit, TF32 off, the
   kernel ``tpu_on_k8s_torch/ops/csrc/flash_fwd.cu`` built with nvcc;
2. each kernel against its plain PyTorch version on the card, at the serving
   path's shapes, within stated tolerances;
3. serving: ``generate`` at ``llama2_7b`` width (32 layers, bf16, random
   weights from a seed) answers a greedy batch-4 request and a sampled
   batch-1 request; the flash kernel's launch count shows that each prefill
   went through it; the prefill logits with the kernel agree with the same
   model run on the plain attention;
4. times on the card, each beside the card's name and power limit.

Then one JSON line per kernel set, the card's line, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
that line; so does a machine without CUDA. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

# H100 SXM dense peaks (NVIDIA data sheet), the denominators of bound_ms.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Stated tolerances of the kernel against its plain version: bf16 outputs
# carry ~3 significant digits and the kernel rounds P to bf16 per K tile
# against a running max (the plain version against the final max); lse is
# fp32 from the same fp32 scores. fp32 differs only in summation order.
TOL = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-4, 1e-4)}
# Prefill logits, 32 bf16 layers with random weights: rounding differences
# grow through depth, so both bf16 models are held against the same weights
# run in fp32. The plain-attention bf16 model's distance from it is the bf16
# noise floor; the kernel's model may exceed that floor by at most 25%.
LOGITS_NOISE_MULT = 1.25


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


def flash_bound_ms(b, h, hkv, l, d, causal) -> tuple[float, str]:
    """Least time for the bf16 flash forward on this card: the larger of
    its FLOPs (QK^T and PV over the kept key columns) at the tensor-core
    peak and its bytes (q, k, v read once; o and fp32 lse written once) at
    the memory rate."""
    pairs = l * (l + 1) // 2 if causal else l * l
    flop_s = 4 * b * h * d * pairs / PEAK_BF16_FLOPS
    byte_s = (2 * (2 * b * h * l * d + 2 * b * hkv * l * d)
              + 4 * b * h * l) / PEAK_BYTES
    return max(flop_s, byte_s) * 1e3, ("operations" if flop_s > byte_s
                                       else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    from tpu_on_k8s_torch.models import decode, transformer
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.ops import _build
    from tpu_on_k8s_torch.ops import flash_attention as fa

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
    path = _build.build("flash_fwd")
    print(f"[build] flash_fwd with nvcc {' '.join(_build.NVCC_FLAGS)} "
          f"in {time.perf_counter() - t0:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[build] flash_fwd: {line.strip()}")

    # ---- 2. kernel against its plain version ---------------------------
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(b, h, hkv, l, d, dtype):
        return (torch.randn(b, h, l, d, generator=gen, device=dev).to(dtype),
                torch.randn(b, hkv, l, d, generator=gen, device=dev).to(dtype),
                torch.randn(b, hkv, l, d, generator=gen, device=dev).to(dtype))

    def segments_for(b, l):
        # three packed documents per row, boundaries drawn per row
        cuts = torch.sort(torch.randint(1, l, (b, 2), generator=gen,
                                        device=dev), dim=-1).values
        pos = torch.arange(l, device=dev)
        return ((pos[None] >= cuts[:, :1]).int()
                + (pos[None] >= cuts[:, 1:]).int()).to(torch.int32)

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
    if misses:
        fail(f"flash kernel disagrees with its plain version: {misses}")

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

    fa.launches = 0
    greedy = decode.generate(cfg, params, prompt4, 64)
    torch.cuda.synchronize()
    after_greedy = fa.launches
    sampled = decode.generate(cfg, params, prompt1, 32, temperature=0.8,
                              top_p=0.9,
                              generator=torch.Generator(device=dev)
                              .manual_seed(2))
    torch.cuda.synchronize()
    main_launches = fa.launches
    print(f"[serve] request 1: batch 4 x prompt 512 -> 64 tokens, greedy; "
          f"flash_fwd launches {after_greedy}")
    print(f"[serve] request 2: batch 1 x prompt 333 -> 32 tokens, "
          f"temperature 0.8 top_p 0.9; flash_fwd launches "
          f"{main_launches - after_greedy}")
    print(f"[serve] greedy row 0: {greedy[0, :16].tolist()} ...")
    print(f"[serve] sampled row 0: {sampled[0, :16].tolist()} ...")
    if after_greedy != cfg.n_layers or main_launches - after_greedy != cfg.n_layers:
        fail(f"flash_fwd launches per prefill {after_greedy}, "
             f"{main_launches - after_greedy}; expected {cfg.n_layers} each")
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

    # ---- 4. times -----------------------------------------------------
    b, h, hkv, l, d = 4, cfg.n_heads, cfg.n_kv_heads, 512, cfg.head_dim
    q, k, v = qkv(b, h, hkv, l, d, torch.bfloat16)
    kernel_ms = time_ms(lambda: fa.flash_with_lse_fwd(q, k, v, True))
    plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v, True))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    bound_ms, bound_by = flash_bound_ms(b, h, hkv, l, d, True)
    prefill_ms = wall_ms(lambda: decode.generate(cfg, params, prompt4, 1))
    gen64_ms = wall_ms(lambda: decode.generate(cfg, params, prompt4, 64))
    decode_ms = (gen64_ms - prefill_ms) / 63
    print(f"[time] {gpu}: flash_fwd B={b} H={h} Hkv={hkv} L={l} D={d} bf16 "
          f"causal: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
          f"{bound_ms / kernel_ms:.1%} of bound")
    print(f"[time] {gpu}: generate llama2_7b bf16 batch 4 x prompt 512: "
          f"prefill (+1 token) {prefill_ms:.2f} ms, 64 tokens "
          f"{gen64_ms:.2f} ms, per-token decode {decode_ms:.3f} ms; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"script {time.perf_counter() - t_start:.0f} s")

    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tpu_on_k8s_torch/ops/csrc/flash_fwd.cu",
        "replaces": "tpu_on_k8s/ops/flash_attention.py:131",
        "launches": main_launches, "max_abs_err": bf16_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms}]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
