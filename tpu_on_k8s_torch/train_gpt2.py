"""GPT-2 training on one card with generation-versioned checkpoints (the
port's elastic-training entry point).

Counterpart of ``examples/train_gpt2.py``: ``gpt2_small`` (12 layers,
d_model 768, vocab 50257, learned positions, LayerNorm, tanh-GELU, tied
embeddings) or ``--tiny``, random fp32 master weights from ``--seed``, bf16
compute, flash attention (whose backward runs the port's two CUDA kernels)
and the config's remat, the reference's optimizer
(``default_optimizer(warmup_steps=10, decay_steps=max(steps, 11))``), on
one fixed synthetic batch ``--batch`` x ``--seq-len`` (capped at the
position table), driven by ``Trainer.fit``. Each step prints the
example's ``[elastic-metrics]`` line.

With ``--checkpoint-dir`` the ``TrainState`` is saved as a step of
``--generation`` every ``--save-every`` steps and at the end
(``train/checkpoint.py``'s ``CheckpointManager``, which keeps
generations), and a run first resumes from the newest generation's newest
step there, printing ``resumed generation=G step=S``: the controller bumps
the generation at each rescale, and a rescaled job continues where the
last one saved::

    python -m tpu_on_k8s_torch.train_gpt2 --steps 100 --checkpoint-dir ck
    python -m tpu_on_k8s_torch.train_gpt2 --tiny --device cpu --steps 2 \\
        --seq-len 64 --batch 4 --checkpoint-dir /tmp/ck
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools

import torch

from tpu_on_k8s_torch.data.prefetch import device_prefetch
from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.models.params import init_params, load_model
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.train import Trainer, default_optimizer
from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
from tpu_on_k8s_torch.train_llama import StepTimer

#: the reference example's ``--tiny`` model
TINY = TransformerConfig(vocab_size=512, d_model=64, n_layers=2, n_heads=4,
                         n_kv_heads=4, d_ff=128, max_seq_len=128, remat=False,
                         pos_emb="learned", norm="ln", activation="gelu",
                         tie_embeddings=True)


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description="GPT-2 elastic training on one "
                                            "card")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=512)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--generation", type=int, default=0,
                   help="job generation (the controller bumps it per "
                        "rescale)")
    p.add_argument("--save-every", type=int, default=100)
    p.add_argument("--checkpoint-dir", default="",
                   help="save the training state here, and resume from "
                        "the newest generation's newest step here")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = dataclasses.replace(
        TINY if args.tiny else TransformerConfig.gpt2_small(),
        attn_impl="flash")
    seq = min(args.seq_len, cfg.max_seq_len)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = load_model(cfg, init_params(cfg, gen, dev,
                                        dtype=cfg.param_dtype), dev)
    opt = default_optimizer(model.parameters(), warmup_steps=10,
                            decay_steps=max(args.steps, 11))
    trainer = Trainer(model, opt)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, seq + 1),
                           generator=gen, device=dev, dtype=torch.int32)

    manager = (CheckpointManager(args.checkpoint_dir)
               if args.checkpoint_dir else None)
    state = trainer.state()
    if manager is not None and manager.latest() is not None:
        state, generation, step = manager.restore(state)
        print(f"resumed generation={generation} step={step}", flush=True)

    timer = StepTimer(args.batch * seq)
    result = trainer.fit(
        state, device_prefetch(itertools.repeat(tokens), dev), args.steps,
        log_every=1, checkpoint_manager=manager,
        checkpoint_every=args.save_every, generation=args.generation,
        on_metrics=lambda step, m, dt: timer.report(step - 1, m["loss"], dt))
    loss = result.last_metrics.get("loss", float("nan"))
    if manager is not None:
        manager.save(state, step=state.step, generation=args.generation)
        manager.close()
        print(f"saved generation={args.generation} step={state.step} to "
              f"{args.checkpoint_dir}", flush=True)
    return loss


if __name__ == "__main__":
    main()
