"""Microbenchmark: attention implementations in isolation at the headline
shape (the counterpart of the reference's ``tools/attn_micro.py``).

    python -m tpu_on_k8s_torch.attn_micro [B] [L] [H] [D] [--device D]

Defaults 12 1024 16 64. bf16 ``[B, L, H, D]`` q, k, v from torch seeds 0, 1
and 2; causal. Rows: the plain attention (``ops/flash_attention
.xla_attention_bhld``, the reference's ``xla_attention``) and
``flash_attention`` (the hand-written kernels), each as a forward and as a
forward plus backward (the gradients of ``sum(o.float() ** 2)``). Each row
is a warm call, then 30 calls ending in one synchronize: ms a call and
TF/s at the causal count ``2 * 2 * B*H*L*L*D / 2``. The reference sweeps
the Pallas kernel's ``block`` over 128/256/512; the port's kernels own
their tiles and take no block argument, so one flash row stands for that
sweep. The default device is ``cuda``, which raises without a card.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.ops.flash_attention import (
    flash_attention,
    xla_attention_bhld,
)


def xla_attention(q, k, v, causal: bool = True):
    """The plain attention on ``[B, L, H, D]`` (heads-leading inside)."""
    o = xla_attention_bhld(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), causal)
    return o.transpose(1, 2)


def make_inputs(b: int, l: int, h: int, d: int,
                device: str | torch.device = "cuda"):
    dev = resolve_device(device)
    return tuple(torch.randn(b, l, h, d, device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(seed)).to(torch.bfloat16)
                 for seed in (0, 1, 2))


def grad_wrap(attn: Callable) -> Callable:
    """(q, k, v) -> the gradients of ``sum(attn(q, k, v).float() ** 2)``."""
    def grads(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        loss = (attn(q, k, v, causal=True).float() ** 2).sum()
        return torch.autograd.grad(loss, (q, k, v))
    return grads


def rows() -> Dict[str, Callable]:
    """Each row's name and its call on (q, k, v)."""
    return {
        "xla fwd": lambda a, b_, c: xla_attention(a, b_, c, causal=True),
        "xla fwd+bwd": grad_wrap(xla_attention),
        "flash fwd": lambda a, b_, c: flash_attention(a, b_, c, causal=True),
        "flash fwd+bwd": grad_wrap(flash_attention),
    }


def timeit(name, fn, *args, steps=30):
    q = args[0]
    b, l, h, d = q.shape

    def sync():
        if q.device.type == "cuda":
            torch.cuda.synchronize(q.device)

    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*args)
    sync()
    dt = (time.perf_counter() - t0) / steps
    # causal attention flops: QK^T + PV = 2 * 2 * B*H*L*L*D / 2 (causal half)
    flops = 2 * 2 * b * h * l * l * d / 2
    print(f"{name:30s} {dt * 1e3:8.2f} ms  ({flops / dt / 1e12:6.2f} TF/s)",
          flush=True)
    return dt


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description="attention implementations "
                                            "alone")
    for name, default in (("B", 12), ("L", 1024), ("H", 16), ("D", 64)):
        p.add_argument(name, type=int, nargs="?", default=default)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    q, k, v = make_inputs(args.B, args.L, args.H, args.D, args.device)
    print("flash: the kernels choose their own tiles (no block argument), "
          "so one row stands for the reference's block sweep 128/256/512",
          flush=True)
    return {name: timeit(name, fn, q, k, v) for name, fn in rows().items()}


if __name__ == "__main__":
    main()
