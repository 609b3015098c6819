"""The masked-LM training step for ``models/bert.py``: the step of the
reference's ``examples/train_bert.py`` (``mlm_loss`` under
``value_and_grad``, then the optimizer), on one rank or on a mesh.

On a mesh (the model laid out by ``parallel/sharded.shard_model``: FSDP2
over data × fsdp, gradients summed) the objective stays the mean over the
global batch's masked positions: each rank's ``mlm_nll_sum`` over the
count all-reduced over the data-parallel axes.
"""
from __future__ import annotations

from typing import Dict

import torch

from tpu_on_k8s_torch.models.bert import Bert, mlm_nll_sum
from tpu_on_k8s_torch.train.trainer import _dp_sum


def make_mlm_step(model: Bert, optimizer, mesh=None):
    """``step(tokens [b, L], mask [b, L], type_ids=None,
    attention_mask=None)`` → ``{"loss", "step"}``: one optimizer step on
    the masked-LM loss of this rank's rows (targets = the tokens, at the
    positions ``mask`` counts), the loss of the global batch on a mesh, a
    0-d device tensor (no host sync)."""
    def dp_sum(t: torch.Tensor) -> torch.Tensor:
        return t if mesh is None else _dp_sum(t, mesh)

    def step(tokens, mask, type_ids=None,
             attention_mask=None) -> Dict[str, object]:
        count = optimizer.count
        logits = model(tokens, type_ids, attention_mask)
        denom = torch.clamp(dp_sum(mask.sum()), min=1.0)
        part = mlm_nll_sum(logits, tokens, mask)
        (part / denom).backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": dp_sum(part.detach()) / denom, "step": count}

    return step
