"""The masked-LM training step for ``models/bert.py``: the step of the
reference's ``examples/train_bert.py`` (``mlm_loss`` under
``value_and_grad``, then the optimizer), on one rank or on a mesh.

On a mesh (the model laid out by ``parallel/sharded.shard_model``: FSDP2
over data × fsdp, gradients summed; tensor parallelism over ``model``)
the objective stays the mean over the global batch's masked positions:
each rank's ``mlm_nll_sum`` over the count all-reduced over the axes whose
ranks hold other positions. The step takes this rank's rows, whole over
``seq`` (``mlm_rows``); on a ``seq`` axis of n > 1 that divides L it keeps
the rank's chunk of each (chunk i of L/n, i the rank's place on ``seq``),
as the reference's ``batch_sharding`` splits dim 1, counts over ``seq``
too and sums the gradients over it (``sharded.sum_grads_over_seq``).
Where n does not divide L the reference keeps dim 1 whole: every ``seq``
rank then runs the same rows, and neither the count nor the gradients are
summed over ``seq``.
"""
from __future__ import annotations

from typing import Dict

import torch

from tpu_on_k8s_torch.models.bert import Bert, mlm_nll_sum
from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_SEQ,
    MeshAxis,
    NamedSharding,
    batch_sharding,
    local_rows,
    mesh_shape,
)
from tpu_on_k8s_torch.parallel.sharded import sum_grads_over_seq
from tpu_on_k8s_torch.train.trainer import _dp_sum


def mlm_rows(mesh, *arrays: torch.Tensor):
    """This rank's rows of each ``[B, L]`` array every rank holds in full:
    the batch over (data, fsdp) (``batch_sharding``'s rows), whole over
    ``seq``, as the step takes them. Off a mesh, the arrays themselves."""
    if mesh is None:
        out = arrays
    else:
        rows = NamedSharding(mesh, batch_sharding(
            mesh, tuple(arrays[0].shape)).spec[:1])
        out = tuple(local_rows(a, rows) for a in arrays)
    return out if len(out) > 1 else out[0]


def make_mlm_step(model: Bert, optimizer, mesh=None):
    """``step(tokens [b, L], mask [b, L], type_ids=None,
    attention_mask=None)`` → ``{"loss", "step"}``: one optimizer step on
    the masked-LM loss of this rank's rows (``mlm_rows``: targets = the
    tokens, at the positions ``mask`` counts), the loss of the global
    batch on a mesh, a 0-d device tensor (no host sync)."""
    seq = (MeshAxis(mesh, AXIS_SEQ)
           if mesh is not None and mesh_shape(mesh)[AXIS_SEQ] > 1 else None)

    def step(tokens, mask, type_ids=None,
             attention_mask=None) -> Dict[str, object]:
        count = optimizer.count
        split = seq is not None and tokens.shape[1] % seq.size == 0
        if split:
            tokens, mask, type_ids, attention_mask = (
                None if t is None else seq.own(t, 1)
                for t in (tokens, mask, type_ids, attention_mask))
        axes = (AXIS_DATA, AXIS_FSDP) + ((AXIS_SEQ,) if split else ())

        def total(t: torch.Tensor) -> torch.Tensor:
            return t if mesh is None else _dp_sum(t, mesh, axes)

        logits = model(tokens, type_ids, attention_mask, seq_chunk=split)
        denom = torch.clamp(total(mask.sum()), min=1.0)
        part = mlm_nll_sum(logits, tokens, mask)
        (part / denom).backward()
        if split:
            sum_grads_over_seq(model, mesh)
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return {"loss": total(part.detach()) / denom, "step": count}

    return step
