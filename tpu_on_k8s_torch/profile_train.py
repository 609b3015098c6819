"""Where a training step's time goes on the card.

    python -m tpu_on_k8s_torch.profile_train --config llama2_1b --batch 4 \\
        --seq-len 2048

Random fp32 master weights from ``--seed``, one fixed batch of synthetic
tokens, the training CLI's model and optimizer (flash attention, remat
``--remat-policy``). The int8 recipe's config fields are flags of the same
names (``--mlp-int8``, ``--mlp-fused-gateup``, ``--head-int8``,
``--attn-int8``, ``--int8-impl``). After two warm-up steps it prints:

- the wall time of each part of a step (forward and loss, backward,
  optimizer), each ending in a synchronize, median of three steps;
- a ``torch.profiler`` trace of one whole step: wall time, device time
  summed over kernels, the device's busy share, the device time by kernel
  group (the port's flash kernels, cuBLAS GEMMs, elementwise, reductions,
  ...) and the kernels with the most device time.

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.generate import CONFIGS
from tpu_on_k8s_torch.models.params import init_params, load_model
from tpu_on_k8s_torch.profile_generate import report
from tpu_on_k8s_torch.train import default_optimizer
from tpu_on_k8s_torch.train import trainer as trainer_mod

#: (substring of a kernel's name, its group), first match wins
_GROUPS = (
    ("flash_fwd", "flash_fwd (port kernel)"),
    ("dq_bf16", "flash_bwd_dq (port kernel)"),
    ("dq_f32", "flash_bwd_dq (port kernel)"),
    ("dkv_", "flash_bwd_dkv (port kernel)"),
    ("int8_matmul_kernel", "int8_matmul (port kernel)"),
    ("gemm", "GEMM (cuBLAS)"), ("nvjet", "GEMM (cuBLAS)"),
    ("xmma", "GEMM (cuBLAS)"), ("cutlass", "GEMM (cuBLAS)"),
    ("reduce", "reductions"), ("softmax", "reductions"),
    ("embedding", "embedding / index"), ("index", "embedding / index"),
    ("gather", "embedding / index"), ("scatter", "embedding / index"),
    ("copy", "copies"), ("cat", "copies"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
)


#: The int8 recipe's boolean config fields, each a flag of the same name.
_INT8_FLAGS = ("mlp_int8", "mlp_fused_gateup", "head_int8", "attn_int8")


def group(name: str) -> str:
    lower = name.lower()
    for key, label in _GROUPS:
        if key in lower:
            return label
    return "other"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="profile a training step")
    p.add_argument("--config", default="llama2_1b", choices=sorted(CONFIGS))
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--remat-policy", default="mlp", choices=["full", "mlp"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=15)
    for flag in _INT8_FLAGS:
        p.add_argument(f"--{flag.replace('_', '-')}", action="store_true")
    p.add_argument("--int8-impl", default="pallas", choices=["xla", "pallas"])
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(CONFIGS[args.config](), remat=True,
                              remat_policy=args.remat_policy,
                              attn_impl="flash", int8_impl=args.int8_impl,
                              **{f: getattr(args, f) for f in _INT8_FLAGS})
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = load_model(cfg, init_params(cfg, gen, dev,
                                        dtype=cfg.param_dtype), dev)
    opt = default_optimizer(model.parameters(), warmup_steps=10,
                            decay_steps=11)
    step = trainer_mod.make_train_step(model, opt)
    loss_fn = trainer_mod._make_loss_fn(model, 0, None)
    params = list(model.parameters())
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.seq_len + 1),
                           generator=gen, device=dev, dtype=torch.int32)
    int8 = [f for f in _INT8_FLAGS if getattr(args, f)]
    print(f"[setup] {args.config} batch {args.batch} seq {args.seq_len} "
          f"remat {args.remat_policy} int8 {int8 or 'off'} "
          f"({args.int8_impl}) on {torch.cuda.get_device_name(0)}")
    for _ in range(2):
        step(tokens)
    torch.cuda.synchronize()

    parts = {"forward+loss": [], "backward": [], "optimizer": []}
    for _ in range(3):
        t0 = time.perf_counter()
        loss, _ = loss_fn(tokens)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for p_, g in zip(params, grads):
            p_.grad = g
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for p_ in params:
            p_.grad = None
        del grads
        for name, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[name].append(dt * 1e3)
    total = sum(statistics.median(v) for v in parts.values())
    for name, v in parts.items():
        ms = statistics.median(v)
        print(f"[parts] {name:13s} {ms:9.2f} ms {ms / total:6.1%}")
    report("train step", lambda: step(tokens), args.top, group)


if __name__ == "__main__":
    main()
