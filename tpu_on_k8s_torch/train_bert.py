"""BERT-base MLM pretraining: the counterpart of ``examples/train_bert.py``
(BASELINE config 3).

Synthetic tokens (``cli_common.synthetic_tokens``, numpy ``--seed``) with
15% of the positions masked (seed ``--seed + 1``), random fp32 master
weights drawn as the reference initialises them (seed ``--seed + 2``),
bf16 compute, ``--attn`` xla (the config's default) or flash (the port's
CUDA kernels, non-causal), ``optax.adamw`` on the warm-up cosine schedule
(peak 1e-4, 10 warm-up steps, weight decay 0.01 on every parameter:
``train/optimizer.py``'s ``adamw``), laid out by ``bert_partition_rules``
on the job's mesh (``cli_common.bring_up``: FSDP2 over data x fsdp,
tensor parallelism over ``--model-axis``, the sequence split over
``--seq-axis`` where it divides ``--seq-len``), one fixed batch, driven by
``TrainLoop`` one step a window with the ``[elastic-metrics]`` line
(``tok_s``: tokens/s)::

    python -m tpu_on_k8s_torch.train_bert --steps 20 --batch-per-host 32
    python -m tpu_on_k8s_torch.train_bert --tiny --device cpu --steps 3
    torchrun --nproc-per-node 4 -m tpu_on_k8s_torch.train_bert --tiny \
        --device cpu --fsdp 2 --model-axis 2 --steps 3

The step is ``train/mlm.py``'s ``make_mlm_step``.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch.cli_common import (
    bring_up,
    standard_parser,
    synthetic_tokens,
)
from tpu_on_k8s_torch.models.bert import (
    Bert,
    BertConfig,
    bert_partition_rules,
    init_params,
)
from tpu_on_k8s_torch.models.params import load_module
from tpu_on_k8s_torch.parallel.sharded import shard_model
from tpu_on_k8s_torch.train.loop import TrainLoop
from tpu_on_k8s_torch.train.mlm import make_mlm_step, mlm_rows
from tpu_on_k8s_torch.train.optimizer import (
    adamw,
    warmup_cosine_decay_schedule,
)
from tpu_on_k8s_torch.train_llama import StepTimer


def main(argv=None) -> float:
    p = standard_parser("BERT-base MLM")
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--attn", default="xla", choices=["xla", "flash"])
    args = p.parse_args(argv)
    with bring_up(args) as (dev, mesh):
        return _train(args, dev, mesh)


def _train(args, dev: torch.device, mesh) -> float:
    cfg = dataclasses.replace(BertConfig.tiny() if args.tiny
                              else BertConfig.base(), attn_impl=args.attn)
    with torch.device("meta"):
        model = Bert(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    model = load_module(model, init_params(cfg, gen), dev)
    shard_model(model, mesh, bert_partition_rules())
    optimizer = adamw(model.parameters(), warmup_cosine_decay_schedule(
        0.0, 1e-4, 10, max(args.steps, 11)), weight_decay=0.01)
    optimizer.mesh = mesh

    global_batch = args.batch_per_host * dist.get_world_size()
    tokens = synthetic_tokens(args.seed, global_batch, args.seq_len,
                              cfg.vocab_size)
    mask = torch.from_numpy((np.random.default_rng(args.seed + 1).uniform(
        size=tuple(tokens.shape)) < 0.15).astype(np.float32))
    batch = tuple(t.to(dev) for t in mlm_rows(mesh, tokens, mask))
    step = make_mlm_step(model, optimizer, mesh)
    timer = StepTimer(global_batch * args.seq_len,
                      enabled=dist.get_rank() == 0)
    result = TrainLoop(lambda state, b: (state, step(*b)), None,
                       itertools.repeat(batch), log_every=1,
                       on_metrics=lambda i, m, dt: timer.report(
                           i - 1, m["loss"], dt)).run(args.steps)
    return result.last_metrics.get("loss", float("nan"))


if __name__ == "__main__":
    main()
