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

``shard_serving_model(model, mesh, rules)`` lays a serving model (the
engine's, ``models/serving.py``) out with plain local tensors and explicit
collectives instead of ``DTensor``s: a decode step runs one small product
after another, and ``DTensor``'s per-operator dispatch would sit on the
host path of every one. The rules decide the layout (``serving_cuts``): a
projection whose weight's rule puts ``model`` on its output rows (dim 0)
is column parallel and keeps the rank's rows of every leaf (``weight``, a
bias, ``weight_q`` and its per-output-channel ``weight_scale``); one with
``model`` on its input columns (dim 1) is row parallel, keeps the rank's
columns of ``weight`` / ``weight_q`` (a bias and an int8 scale stay
whole) and sums the partial products over ``model`` (``Dense.tp``); one
with no ``model`` is whole. ``embed``'s vocab rows and the head's vocab
columns (``lm_head``, ``lm_head_q`` with ``lm_head_scale``), where their
rules split them, are the rank's and gathered over ``model``
(``Transformer.embed_tp`` / ``head_tp``). Layouts a serving model cannot
run raise, naming the leaf. A leaf a size-1 axis does not split stays the
tensor it was (a view, no copy); a split leaf is copied out, so the whole
tensor can be freed. With ``fsdp`` > 1 every block is ``fully_shard``-ed
over the ``fsdp`` sub-mesh on the dim its rule gives ``fsdp``, and FSDP2's
forward gathers it for each call; ``embed``, the head and the final norm
stay whole over ``fsdp`` (the step and prefill models share them and the
blocks: ``serving.multislot_twin``). ``data`` replicates the parameters.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
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


def _axis_dim(name: str, rules: Sequence[PartitionRule], axis: str
              ) -> Optional[int]:
    """The dim the rule of ``name`` puts ``axis`` on (None: none)."""
    _, spec = rule_for_path(name, rules)
    for d, entry in enumerate(spec):
        if axis in _axes(entry):
            return d
    return None


def tensor_parallel(model: nn.Module, tp_mesh) -> None:
    """``shard_model``'s tensor parallelism over the one-dim ``tp_mesh``,
    in place: ``parallelize_module`` with column-parallel ``wq``/``wk``/
    ``wv``/``w_gate``/``w_up`` and row-parallel ``wo``/``w_down``, and
    ``embed`` (rows) and ``lm_head`` (columns) as vocab-sharded ``DTensor``
    parameters."""
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
        tensor_parallel(model, mesh[AXIS_MODEL])
    dp_axes = ((AXIS_DATA, AXIS_FSDP) if sizes[AXIS_DATA] > 1
               else (AXIS_FSDP,))
    dp_mesh = mesh[dp_axes] if len(dp_axes) > 1 else mesh[dp_axes[0]]
    names: Dict[int, str] = {id(p): n for n, p in model.named_parameters()}

    def placement(p: nn.Parameter):
        dim = _axis_dim(names[id(p)], rules, AXIS_FSDP)
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



class TensorParallel:
    """A serving model's ``model`` axis: its process group, this rank's
    index on it and its size, and the three collectives a laid-out serving
    model calls (``shard_serving_model``). Each runs also on a group of
    one, where it is an identity."""

    def __init__(self, mesh) -> None:
        tp_mesh = mesh[AXIS_MODEL]
        self.group = tp_mesh.get_group()
        self.rank = tp_mesh.get_local_rank()
        self.size = tp_mesh.size()

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Sum a row-parallel product's partial results over the axis."""
        dist.all_reduce(y, group=self.group)
        return y

    def embed(self, tokens: torch.Tensor, rows: torch.Tensor
              ) -> torch.Tensor:
        """The embedding gather from this rank's vocab rows: a token held
        elsewhere reads zeros, and the sum over the axis is each token's
        one row, exact."""
        n = rows.shape[0]
        local = tokens.long() - self.rank * n
        inside = (local >= 0) & (local < n)
        out = F.embedding(local.clamp(0, n - 1), rows)
        out = torch.where(inside[..., None], out, out.new_zeros(()))
        return self.reduce(out)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole last dim from each rank's block of it (the rank's
        vocab columns of the logits), in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=-1)

    def block(self, p: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``p`` along ``dim``: ``p`` itself when the
        axis does not split it, else a compact copy."""
        if self.size == 1:
            return p
        n = p.shape[dim] // self.size
        return p.detach().narrow(dim, self.rank * n, n).clone()


#: what the model dim of a projection's weight makes it
_ROLES = {None: "whole", 0: "column parallel", 1: "row parallel"}
#: the root leaves a serving model may split on their vocab dim
_VOCAB_DIMS = {"embed": 0, "lm_head": 1, "lm_head_q": 1, "lm_head_scale": 0}


def _projection_cuts(prefix: str, leaves: Sequence[str], rules
                     ) -> Tuple[Optional[int], Dict[str, int]]:
    """A projection's (``Dense`` or ``W8Dense``, its parameter names
    ``leaves``) role from the dim the rule of its weight puts ``model`` on:
    0 (column parallel: every leaf keeps the rank's output rows), 1 (row
    parallel: the weight keeps the rank's input columns, a bias and an int8
    scale stay whole) or None (whole); and the dim each leaf is cut on. A
    leaf with a rule of its own must agree."""
    weight = "weight_q" if "weight_q" in leaves else "weight"
    dim = _axis_dim(f"{prefix}.{weight}", rules, AXIS_MODEL)
    if dim not in _ROLES:
        raise ShardingValidationError(
            f"{prefix}.{weight}: a rule puts {AXIS_MODEL} on dim {dim}; a "
            f"projection splits on its output rows (0) or input columns (1)")
    cuts = {}
    for name in leaves:
        cut = dim if name == weight else (0 if dim == 0 else None)
        rule, _ = rule_for_path(f"{prefix}.{name}", rules)
        own = _axis_dim(f"{prefix}.{name}", rules, AXIS_MODEL)
        if rule is not None and own != cut:
            raise ShardingValidationError(
                f"{prefix}.{name}: its rule puts {AXIS_MODEL} on dim {own}, "
                f"but {prefix}.{weight}'s makes the projection "
                f"{_ROLES[dim]}, which puts it on dim {cut}")
        if cut is not None:
            cuts[f"{prefix}.{name}"] = cut
    return dim, cuts


def serving_cuts(names: Iterable[str], rules: Sequence[PartitionRule],
                 n_model: int) -> Tuple[Dict[str, int], List[str]]:
    """The serving layout the rules give a model's parameters (``names``)
    over a ``model`` axis of ``n_model``: the dim each split parameter is
    cut on, by name, and the row-parallel projections, by module path.
    Each projection's role comes from its weight's rule
    (``_projection_cuts``). A block's attention must be head parallel on
    a split axis (wq/wk/wv column, wo row: the KV pool holds each rank's kv
    heads, as the reference's ``kv_sharding`` does), its MLP whole or
    column then row parallel; ``embed`` and the head (``lm_head``, or
    ``lm_head_q`` with its scale) may split on their vocab dim; nothing
    else splits over ``model``. A layout outside these raises (the
    engine's plan calls this before anything moves)."""
    names = list(names)
    cuts: Dict[str, int] = {}
    rows: List[str] = []
    parts: Dict[str, Dict[str, List[str]]] = {}
    others = []
    for name in names:
        m = re.fullmatch(r"(blocks\.\d+\.(?:attn|mlp))\.(\w+)\.(\w+)", name)
        if m:
            parts.setdefault(m[1], {}).setdefault(m[2], []).append(m[3])
        else:
            others.append(name)
    for part, projections in parts.items():
        roles = {}
        for n, leaves in projections.items():
            roles[n], leaf_cuts = _projection_cuts(f"{part}.{n}", leaves,
                                                   rules)
            cuts.update(leaf_cuts)
            if roles[n] == 1:
                rows.append(f"{part}.{n}")
        last = "wo" if part.endswith("attn") else "w_down"
        pair = {n: int(n == last) for n in roles}
        allowed = [pair]
        if not (part.endswith("attn") and n_model > 1):
            allowed.append(dict.fromkeys(roles))
        if roles not in allowed:
            raise NotImplementedError(
                f"{part}: the rules put {AXIS_MODEL} on its projections' "
                f"dims {roles}; a serving {part.rpartition('.')[2]} takes "
                f"{' or '.join(map(str, allowed))}; other layouts are "
                f"ROADMAP Queue 1 item 3c")
    for name in others:
        dim = _axis_dim(name, rules, AXIS_MODEL)
        if dim is not None and dim != _VOCAB_DIMS.get(name):
            raise NotImplementedError(
                f"{name}: a rule puts {AXIS_MODEL} on dim {dim}; a serving "
                f"model splits only embed and the head, on their vocab dim")
        if dim is not None:
            cuts[name] = dim
    if ("lm_head_q" in cuts) != ("lm_head_scale" in cuts):
        raise ShardingValidationError(
            "lm_head_q and lm_head_scale: the rules split one over "
            f"{AXIS_MODEL} and not the other")
    return cuts, rows


def _keep(module: nn.Module, name: str, t: torch.Tensor) -> None:
    if t is not getattr(module, name):
        setattr(module, name, nn.Parameter(t, requires_grad=False))


def shard_serving_model(model: nn.Module, mesh,
                        rules: Sequence[PartitionRule]) -> TensorParallel:
    """Lay a serving (decode-mode) model out on ``mesh`` in place (see the
    module docstring); returns its ``TensorParallel``. Refuses what
    ``check_mesh`` and ``serving_cuts`` refuse, and validates every
    parameter against ``rules``, before anything moves."""
    rules = tuple(rules)
    if layout_of(model) is not None:
        raise ValueError("the model is laid out on a mesh already")
    check_mesh(model.cfg, mesh)
    named_sharding(dict(model.named_parameters()), mesh, rules)
    names = [n for n, _ in model.named_parameters()]
    tp = TensorParallel(mesh)
    cuts, rows = serving_cuts(names, rules, tp.size)
    for name, dim in cuts.items():
        path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(path)
        _keep(mod, leaf, tp.block(getattr(mod, leaf), dim))
    for path in rows:
        model.get_submodule(path).tp = tp
    if "embed" in cuts:
        model.embed_tp = tp
    head = {"lm_head", "lm_head_q"}
    if head & set(cuts) or "embed" in cuts and not head & set(names):
        model.head_tp = tp              # a tied head is embed's transpose
    if mesh_shape(mesh)[AXIS_FSDP] > 1:
        names = {id(p): n for n, p in model.named_parameters()}

        def placement(p: nn.Parameter):
            dim = _axis_dim(names[id(p)], rules, AXIS_FSDP)
            return Shard(0 if dim is None else dim)

        for block in model.blocks:
            fully_shard(block, mesh=mesh[AXIS_FSDP],
                        shard_placement_fn=placement)
    model.layout = Layout(mesh, rules)
    return tp
