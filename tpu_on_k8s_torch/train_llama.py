"""Llama-2 training on one card (the port's training entry point).

Counterpart of ``examples/train_llama.py``: random fp32 master weights from
``--seed``, bf16 compute, the reference's optimizer
(``default_optimizer(warmup_steps=10, decay_steps=max(steps, 11))``), remat
and flash attention (whose backward runs the port's two CUDA kernels), on
synthetic tokens (one fixed batch, as the example) or a packed record file
(``--data``). Each step prints the example's ``[elastic-metrics]`` line::

    python -m tpu_on_k8s_torch.train_llama --config llama2_1b --batch 4 \\
        --seq-len 2048 --steps 8
    python -m tpu_on_k8s_torch.train_llama --config tiny --device cpu

``--int8`` is the example's int8 recipe: int8-forward MLP matmuls with the
fused gate+up weight (``mlp_int8``, ``mlp_fused_gateup``), an exact bf16
backward (``ops/int8_matmul.py``). There is no mesh: one process, one card.
Flags of the example that belong to later slices (``--eval-data``,
``--checkpoint-dir``, ring and ulysses attention) raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.generate import CONFIGS
from tpu_on_k8s_torch.models.params import init_params, load_model
from tpu_on_k8s_torch.train import Trainer, default_optimizer

#: example flag → the later slice that brings it
_LATER = {
    "eval_data": "eval data and the training loop (train/loop.py)",
    "checkpoint_dir": "checkpoints (train/checkpoint.py)",
}


class StepTimer:
    """Prints the observation line the elastic autoscaler scrapes from
    worker-0 logs (the reference's ``examples/common.py::StepTimer``)."""

    def __init__(self, tokens_per_step: int):
        self.tokens_per_step = tokens_per_step
        self.t0 = time.perf_counter()

    def report(self, step: int, loss: float) -> None:
        dt = time.perf_counter() - self.t0
        self.t0 = time.perf_counter()
        print(f"[elastic-metrics] epoch=0 batch={step} latency={dt:.4f} "
              f"loss={loss:.4f} "
              f"tok_s={self.tokens_per_step / max(dt, 1e-9):.1f}",
              flush=True)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="Llama-2 training on one card")
    p.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    p.add_argument("--seq-len", type=int, default=0, help="0 = model max")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", default="true")
    p.add_argument("--remat-policy", default="mlp", choices=["full", "mlp"])
    p.add_argument("--attn", default="flash",
                   choices=["xla", "flash", "ring", "ulysses"])
    p.add_argument("--grad-accum", type=int, default=1,
                   help="microbatches per optimizer update")
    p.add_argument("--bf16-moments", action="store_true",
                   help="store both Adam moments in bfloat16")
    p.add_argument("--data", default="",
                   help="train from a packed record file (fixed [seq+1] "
                        "int32 records) instead of synthetic tokens")
    p.add_argument("--segment-eos", type=int, default=-1,
                   help=">= 0: records are stream-packed windows with this "
                        "EOS separator")
    p.add_argument("--int8", action="store_true",
                   help="int8-forward MLP matmuls + fused gate+up (exact "
                        "bf16 backward; ops/int8_matmul.py)")
    p.add_argument("--eval-data", default="")
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    for flag, later in _LATER.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to "
                f"tpu_on_k8s_torch yet ({later} is a later slice)")
    if args.attn in ("ring", "ulysses"):
        raise NotImplementedError(
            f"--attn {args.attn} is not ported to tpu_on_k8s_torch yet "
            f"(sequence parallelism over a mesh is a later slice)")

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(CONFIGS[args.config](),
                              remat=args.remat.lower() == "true",
                              remat_policy=args.remat_policy,
                              attn_impl=args.attn,
                              mlp_int8=args.int8,
                              mlp_fused_gateup=args.int8)
    seq = args.seq_len or cfg.max_seq_len
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = load_model(cfg, init_params(cfg, gen, dev,
                                        dtype=cfg.param_dtype), dev)
    moments = torch.bfloat16 if args.bf16_moments else None
    opt = default_optimizer(model.parameters(), warmup_steps=10,
                            decay_steps=max(args.steps, 11),
                            mu_dtype=moments, nu_dtype=moments)
    trainer = Trainer(model, opt, grad_accum=args.grad_accum,
                      segment_eos=(args.segment_eos
                                   if args.segment_eos >= 0 else None))

    loader = None
    if args.data:
        from tpu_on_k8s_torch.data import DataLoader, FixedRecordDataset
        loader = DataLoader(FixedRecordDataset(args.data, (seq + 1,),
                                               np.int32),
                            batch_size=args.batch, seed=args.seed)
        next_batch = lambda: torch.from_numpy(next(loader)).to(dev)
        batch = next_batch()
    else:
        batch = torch.randint(0, cfg.vocab_size, (args.batch, seq + 1),
                              generator=gen, device=dev, dtype=torch.int32)
    timer = StepTimer(args.batch * seq)
    loss = float("nan")
    try:
        for i in range(args.steps):
            metrics = trainer.train_step(batch)
            loss = float(metrics["loss"])
            timer.report(i, loss)
            if loader is not None and i + 1 < args.steps:
                batch = next_batch()
    finally:
        if loader is not None:
            loader.close()
    return loss


if __name__ == "__main__":
    main()
