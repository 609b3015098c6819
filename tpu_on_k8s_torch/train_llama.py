"""Llama-2 training on a mesh of cards (the port's training entry point).

Counterpart of ``examples/train_llama.py``: random fp32 master weights from
``--seed``, bf16 compute, the reference's optimizer
(``default_optimizer(warmup_steps=10, decay_steps=max(steps, 11))``), remat
(``--remat-policy`` full, mlp, dots or dots_kernels) and flash attention
(whose backward runs the port's two CUDA kernels), on synthetic tokens (one
fixed batch, as the example) or a packed record file (``--data``), driven
by ``Trainer.fit`` (``train/loop.py``'s ``TrainLoop``) with the batches
copied ahead by ``data/prefetch.py``'s ``device_prefetch``. Each step
prints the example's ``[elastic-metrics]`` line (a host-sync window of
one step: the line the autoscaler scrapes comes once a step, as the
example's)::

    python -m tpu_on_k8s_torch.train_llama --config llama2_1b --batch 4 \\
        --seq-len 2048 --steps 8
    python -m tpu_on_k8s_torch.train_llama --config tiny --device cpu \\
        --checkpoint-dir /tmp/ckpt --eval-data eval.bin --eval-every 10

``--eval-data`` loads up to 8 held-out batches once, up front, and
evaluates them every ``--eval-every`` steps and once at the end (unless
that evaluation just ran); ``--checkpoint-dir`` saves the ``TrainState`` at
the end (``train/checkpoint.py``), which ``generate`` and ``serve``
restore with their own ``--checkpoint-dir``. ``--int8`` is the example's
int8 recipe: int8-forward MLP matmuls with the fused gate+up weight
(``mlp_int8``, ``mlp_fused_gateup``), an exact bf16 backward
(``ops/int8_matmul.py``).

As the example's ``bring_up``, it joins the job's world
(``train/distributed.py``'s ``initialize``: torchrun's variables or the
operator's; off-cluster a world of one rank in the process) and trains on
``create_mesh(MeshConfig(data=1, fsdp=--fsdp, model=--model-axis,
seq=--seq-axis))`` under ``flagship_partition_rules`` (FSDP2 and tensor
parallelism, ``parallel/sharded.py``); rank 0 prints the mesh. ``--batch``
is the global batch: each rank takes the rows of its (data, fsdp)
coordinate. Four CPU ranks::

    torchrun --nproc-per-node 4 -m tpu_on_k8s_torch.train_llama \\
        --config tiny --device cpu --fsdp 2 --model-axis 2 --steps 3

``--seq-axis N`` splits every sequence over N ranks (the mesh's ``seq``
axis): each runs one chunk of L/N rows, and ``--attn`` says how attention
crosses the chunks: ``ring`` (K/V chunks passed round the ranks,
``parallel/ring.py``), ``ulysses`` (all-to-alls from sequence to heads,
``parallel/ulysses.py``), or ``flash`` / ``xla`` (q, k and v gathered
whole over the axis). With one rank on the axis, ring and ulysses are
the plain attention, as the reference's::

    torchrun --nproc-per-node 4 -m tpu_on_k8s_torch.train_llama \\
        --config tiny --device cpu --attn ring --fsdp 2 --seq-axis 2
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch.data.prefetch import device_prefetch
from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.generate import CONFIGS
from tpu_on_k8s_torch.models.params import init_params, load_model
from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh, mesh_shape
from tpu_on_k8s_torch.train import Trainer, default_optimizer
from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
from tpu_on_k8s_torch.train.distributed import initialize, local_world


class StepTimer:
    """Prints the observation line the elastic autoscaler scrapes from
    worker-0 logs (the reference's ``examples/common.py::StepTimer``), once
    a host-sync window, with the window's time a step."""

    def __init__(self, tokens_per_step: int, enabled: bool = True):
        self.tokens_per_step = tokens_per_step
        self.enabled = enabled

    def report(self, step: int, loss: float, seconds: float,
               accuracy: float | None = None) -> None:
        if not self.enabled:
            return
        acc = f" accuracy={accuracy:.4f}" if accuracy is not None else ""
        print(f"[elastic-metrics] epoch=0 batch={step} latency={seconds:.4f}"
              f"{acc} loss={loss:.4f} "
              f"tok_s={self.tokens_per_step / max(seconds, 1e-9):.1f}",
              flush=True)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="Llama-2 training on a mesh")
    p.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    p.add_argument("--seq-len", type=int, default=0, help="0 = model max")
    p.add_argument("--batch", type=int, default=8,
                   help="the global batch, split over data x fsdp")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", default="true")
    p.add_argument("--remat-policy", default="mlp",
                   choices=["full", "dots", "dots_kernels", "mlp"])
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
    p.add_argument("--eval-data", default="",
                   help="held-out packed records file; evaluated with the "
                        "shared-objective forward-only eval step")
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate every N steps (0 = only at the end; "
                        "needs --eval-data)")
    p.add_argument("--checkpoint-dir", default="",
                   help="save the training state here at the end")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--fsdp", type=int, default=-1,
                   help="fsdp axis size (-1 = all ranks)")
    p.add_argument("--model-axis", type=int, default=1,
                   help="tensor-parallel axis size")
    p.add_argument("--seq-axis", type=int, default=1,
                   help="sequence-parallel axis size: each sequence split "
                        "over this many ranks")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    ctx = initialize(device=dev)
    made_world = local_world(dev)
    try:
        return _train(args, dev, ctx)
    finally:
        if made_world:
            dist.destroy_process_group()


def _train(args, dev: torch.device, ctx) -> float:
    mesh = create_mesh(MeshConfig(data=1, fsdp=args.fsdp,
                                  model=args.model_axis, seq=args.seq_axis),
                       device=dev)
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        print(f"[{rank}/{world}] mesh={mesh_shape(mesh)} devices={world}",
              flush=True)
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
                                   if args.segment_eos >= 0 else None),
                      rules=flagship_partition_rules(), mesh=mesh)

    loader = None
    if args.data:
        from tpu_on_k8s_torch.data import DataLoader, FixedRecordDataset
        shard_id, n_shards = trainer.data_shard()
        if args.batch % n_shards:
            raise ValueError(f"--batch {args.batch} does not split over "
                             f"{n_shards} data-parallel ranks")
        # each rank reads its own disjoint shard of the records
        loader = DataLoader(FixedRecordDataset(args.data, (seq + 1,),
                                               np.int32),
                            batch_size=args.batch // n_shards,
                            shard_id=shard_id, num_shards=n_shards,
                            seed=args.seed)
        source = loader
    else:
        source = itertools.repeat(trainer.shard_batch(torch.randint(
            0, cfg.vocab_size, (args.batch, seq + 1), generator=gen,
            device=dev, dtype=torch.int32)))

    # the held-out sample loads ONCE, up front: a bad eval file fails here,
    # before any training compute, and evaluations reuse the same batches
    eval_batches = []
    if args.eval_data:
        from tpu_on_k8s_torch.data import DataLoader, FixedRecordDataset
        eld = DataLoader(FixedRecordDataset(args.eval_data, (seq + 1,),
                                            np.int32),
                         batch_size=args.batch, seed=0, shuffle=False)
        eval_batches = [trainer.shard_batch(torch.from_numpy(
                            next(eld).copy()).to(dev))
                        for _ in range(min(eld.batches_per_epoch, 8))]
        eld.close()

    state = trainer.state()

    def evaluate() -> None:
        total = sum(float(trainer.eval_step(state, eb)["loss"])
                    for eb in eval_batches)
        mean = total / len(eval_batches)
        if rank == 0:
            print(f"[eval] step={state.step} loss={mean:.4f} "
                  f"perplexity={math.exp(mean):.1f}", flush=True)

    timer = StepTimer(args.batch * seq, enabled=rank == 0)
    batches = device_prefetch(source, dev)
    loss, done, evaluated_at = float("nan"), 0, -1
    chunk = args.eval_every if eval_batches and args.eval_every else (
        args.steps)
    try:
        while done < args.steps:
            n = min(chunk, args.steps - done)
            result = trainer.fit(
                state, batches, n, log_every=1,
                on_metrics=lambda step, m, dt, base=done: timer.report(
                    base + step - 1, m["loss"], dt))
            done += result.steps
            loss = result.last_metrics.get("loss", loss)
            if result.steps < n:
                break           # the data ran out
            if eval_batches and args.eval_every and (
                    done % args.eval_every == 0):
                evaluate()
                evaluated_at = done
        if eval_batches and evaluated_at != done:
            evaluate()          # the final evaluation, unless one just ran
    finally:
        if loader is not None:
            loader.close()
    if args.checkpoint_dir:
        manager = CheckpointManager(args.checkpoint_dir)
        manager.save(state, step=state.step)
        manager.close()
        if rank == 0:
            print(f"saved step {state.step} to {args.checkpoint_dir}",
                  flush=True)
    return loss


if __name__ == "__main__":
    main()
