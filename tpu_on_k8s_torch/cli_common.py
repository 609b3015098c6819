"""What the vision and BERT CLIs share: a copy of the reference's
``examples/common.py`` (``standard_parser``, ``bring_up``,
``synthetic_tokens``; its ``StepTimer`` is ``train_llama.StepTimer``) for
the port.

``bring_up`` joins the job's world as ``train_llama`` does
(``train/distributed.py``'s ``initialize``: torchrun's variables or the
operator's; off-cluster a world of one rank in the process, destroyed on
exit) and yields the standard mesh over every rank:
``create_mesh(MeshConfig(data=1, fsdp=--fsdp, model=--model-axis,
seq=--seq-axis))``.
"""
from __future__ import annotations

import argparse
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh, mesh_shape
from tpu_on_k8s_torch.train.distributed import initialize, local_world


def standard_parser(desc: str) -> argparse.ArgumentParser:
    """The examples' flags and defaults, and ``--device``."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch-per-host", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fsdp", type=int, default=-1,
                   help="fsdp axis size (-1 = all ranks)")
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--seq-axis", type=int, default=1)
    p.add_argument("--checkpoint-dir", default="",
                   help="accepted, as the examples accept it; nothing is "
                        "saved")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


@contextlib.contextmanager
def bring_up(args: argparse.Namespace):
    """(device, mesh) of the job's world, as the examples' ``bring_up``;
    rank 0 prints the mesh. A ``--seq-axis`` over 1 splits BERT's
    sequence (``models/bert.py``) and is one more replica axis for the
    vision models, whose images have none."""
    dev = resolve_device(args.device)
    initialize(device=dev)
    made_world = local_world(dev)
    try:
        mesh = create_mesh(MeshConfig(data=1, fsdp=args.fsdp,
                                      model=args.model_axis,
                                      seq=args.seq_axis), device=dev)
        if dist.get_rank() == 0:
            print(f"[0/{dist.get_world_size()}] mesh={mesh_shape(mesh)} "
                  f"devices={dist.get_world_size()}", flush=True)
        yield dev, mesh
    finally:
        if made_world:
            dist.destroy_process_group()


def synthetic_tokens(seed: int, batch: int, seqlen: int,
                     vocab: int) -> torch.Tensor:
    """``[batch, seqlen]`` int32 tokens uniform over the vocabulary, from a
    numpy seed."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (batch, seqlen)).astype(np.int32))
