"""A ``Transformer`` laid out on a mesh: tensor parallelism over ``model``
and FSDP2 over (``data``, ``fsdp``), in PyTorch's own idiom. What the
reference leaves to XLA's SPMD partitioner given its rules, written out.

``shard_model(model, mesh, rules)`` validates every parameter against the
rules first (``ShardingValidationError`` before anything moves), then:

* with ``model`` > 1, ``parallelize_module`` on the ``model`` sub-mesh:
  ``ColwiseParallel`` for ``wq``/``wk``/``wv`` and ``w_gate``/``w_up``,
  ``RowwiseParallel`` for ``wo`` and ``w_down``, and the vocab-sharded
  ``embed`` (rows) and ``lm_head`` (columns) as ``DTensor`` parameters
  (``models/transformer.py``'s ``_embed`` and ``_logits`` gather their
  products). A rank then runs H/model query heads and Hkv/model kv heads;
  the flash and int8 kernels see plain local tensors;
* FSDP2's ``fully_shard`` on every ``Block``, then on the root, over the
  (data, fsdp) sub-mesh (HSDP when data > 1), each parameter sharded on
  the dim its rule gives ``fsdp`` (``shard_placement_fn``: the reference's
  layout, not FSDP2's default dim 0; a parameter whose rule names no
  ``fsdp`` dim takes dim 0). Gradients are summed across ranks, never
  averaged: the trainer's loss is already a mean over the global targets.

What it refuses: ``seq`` > 1 (sequence parallelism is ROADMAP Queue 1 item
4) and ``expert`` > 1 (MoE is not ported); under ``model`` > 1 the fused
``wqkv`` / ``w_gateup`` layouts (a plain row split would hand rank 0 all
of q), the int8 recipes (a row-parallel product would quantize its input
with a per-rank absmax, the reference's covers the whole K) and a head
count ``model`` does not divide (``ShardingValidationError``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from torch import nn
from torch.distributed.fsdp import (
    FSDPModule,
    fully_shard,
    register_fsdp_forward_method,
)
from torch.distributed.tensor import Shard, distribute_tensor
from torch.distributed.tensor.parallel import (
    ColwiseParallel,
    RowwiseParallel,
    parallelize_module,
)

from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    mesh_shape,
)
from tpu_on_k8s_torch.parallel.partition import (
    PartitionRule,
    ShardingValidationError,
    _axes,
    named_sharding,
    rule_for_path,
)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The mesh and rules a model was laid out with (``model.layout``)."""

    mesh: object
    rules: tuple


def layout_of(model: nn.Module) -> Optional[Layout]:
    return getattr(model, "layout", None)


def check_mesh(cfg, mesh) -> None:
    """Raise for a mesh this port does not run ``cfg`` on (see the module
    docstring); ``ShardingValidationError`` names an indivisible head
    count."""
    sizes = mesh_shape(mesh)
    if sizes.get(AXIS_SEQ, 1) > 1:
        raise NotImplementedError(
            "a seq mesh axis > 1 is not ported to tpu_on_k8s_torch yet "
            "(sequence parallelism is ROADMAP Queue 1 item 4)")
    if sizes.get(AXIS_EXPERT, 1) > 1:
        raise NotImplementedError(
            "an expert mesh axis > 1 is not ported to tpu_on_k8s_torch yet "
            "(MoE is ROADMAP Queue 1 item 5)")
    tp = sizes.get(AXIS_MODEL, 1)
    if tp == 1:
        return
    if cfg.fused_qkv or cfg.mlp_fused_gateup:
        raise NotImplementedError(
            "the fused wqkv / w_gateup layouts with a model axis > 1 are not "
            "ported to tpu_on_k8s_torch yet (their rows need a per-rank "
            "q|k|v and gate|up reslice; ROADMAP Queue 1 item 3c)")
    if cfg.mlp_int8 or cfg.attn_int8 or cfg.head_int8:
        raise NotImplementedError(
            "the int8 recipes with a model axis > 1 are not ported to "
            "tpu_on_k8s_torch yet (a row-parallel product needs the "
            "activation's absmax all-reduced over the axis; ROADMAP Queue 1 "
            "item 3c)")
    for name, heads in (("n_heads", cfg.n_heads),
                        ("n_kv_heads", cfg.n_kv_heads)):
        if heads % tp:
            raise ShardingValidationError(
                f"{name}={heads} is not divisible by mesh axis model={tp}: "
                f"each rank runs whole heads (the port's local-head "
                f"attention); pick a model axis that divides {heads}")


def _fsdp_dim(name: str, rules: Sequence[PartitionRule]) -> Optional[int]:
    _, spec = rule_for_path(name, rules)
    for d, entry in enumerate(spec):
        if AXIS_FSDP in _axes(entry):
            return d
    return None


def shard_model(model: nn.Module, mesh, rules: Sequence[PartitionRule]
                ) -> nn.Module:
    """Lay ``model`` out on ``mesh`` under ``rules`` in place (see the
    module docstring) and return it, with ``model.layout`` set. Its
    parameters become ``DTensor``s: build the optimizer after this."""
    rules = tuple(rules)
    if layout_of(model) is not None:
        raise ValueError("the model is laid out on a mesh already")
    cfg = model.cfg
    check_mesh(cfg, mesh)
    # every parameter validated before anything is placed
    named_sharding(dict(model.named_parameters()), mesh, rules)
    sizes = mesh_shape(mesh)
    if sizes[AXIS_MODEL] > 1:
        tp_mesh = mesh[AXIS_MODEL]
        col, row = ColwiseParallel(), RowwiseParallel()
        for block in model.blocks:
            plan = {"attn.wq": col, "attn.wk": col, "attn.wv": col,
                    "attn.wo": row, "mlp.w_up": col, "mlp.w_down": row}
            if hasattr(block.mlp, "w_gate"):
                plan["mlp.w_gate"] = col
            parallelize_module(block, tp_mesh, plan)
        for name, dim in (("embed", 0), ("lm_head", 1)):
            p = getattr(model, name, None)
            if p is not None:
                setattr(model, name, nn.Parameter(distribute_tensor(
                    p.data, tp_mesh, [Shard(dim)], src_data_rank=None),
                    requires_grad=p.requires_grad))
    dp_axes = ((AXIS_DATA, AXIS_FSDP) if sizes[AXIS_DATA] > 1
               else (AXIS_FSDP,))
    dp_mesh = mesh[dp_axes] if len(dp_axes) > 1 else mesh[dp_axes[0]]
    names: Dict[int, str] = {id(p): n for n, p in model.named_parameters()}

    def placement(p: nn.Parameter):
        dim = _fsdp_dim(names[id(p)], rules)
        return None if dim is None else Shard(dim)

    for block in model.blocks:
        fully_shard(block, mesh=dp_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=dp_mesh, shard_placement_fn=placement)
    # the chunked loss calls ``features``, not ``forward``: gather there too
    register_fsdp_forward_method(model, "features")
    for module in model.modules():
        if isinstance(module, FSDPModule):
            # a sum: the loss is a mean over the global targets already
            module.set_gradient_divide_factor(1.0)
            module.set_force_sum_reduction_for_comms(True)
    model.layout = Layout(mesh, rules)
    return model

