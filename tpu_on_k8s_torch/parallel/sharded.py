"""A ``Transformer`` laid out on a mesh: tensor parallelism over ``model``
and FSDP2 over (``data``, ``fsdp``), in PyTorch's own idiom. What the
reference leaves to XLA's SPMD partitioner given its rules, written out.
``shard_model`` lays ``Bert`` and the vision models out too: FSDP2 over
their ``blocks`` and root. Over a ``model`` axis > 1 it calls the model's
own ``tensor_parallel(tp_mesh)``: the ``Transformer``'s runs
``tensor_parallel`` below, ``Bert``'s the same machinery on the encoder's
projections (``parallelize_projections``, ``vocab_parallel``), and the
vision models' keeps whole weights (their rules name no ``model`` axis).

``shard_model(model, mesh, rules)`` validates every parameter against the
rules first (``ShardingValidationError`` before anything moves), then:

* with ``model`` > 1, ``parallelize_module`` on the ``model`` sub-mesh:
  ``ColwiseParallel`` for ``wq``/``wk``/``wv`` (or ``wqkv``) and
  ``w_gate``/``w_up`` (or ``w_gateup``), ``RowwiseParallel`` for ``wo``
  and ``w_down``, and the vocab-sharded ``embed`` (rows) and ``lm_head``
  (columns) as ``DTensor`` parameters (``models/transformer.py``'s
  ``_embed`` and ``_logits`` gather their products). A rank then runs
  H/model query heads and Hkv/model kv heads (see "A rank's heads"
  below); the flash and int8 kernels see plain local tensors;
* FSDP2's ``fully_shard`` on every ``Block``, then on the root, over the
  (data, fsdp) sub-mesh (HSDP when data > 1), each parameter sharded on
  the dim its rule gives ``fsdp`` (``shard_placement_fn``: the reference's
  layout, not FSDP2's default dim 0; a parameter whose rule names no
  ``fsdp`` dim takes dim 0). Gradients are summed across ranks, never
  averaged: the trainer's loss is already a mean over the global targets.

A rank's heads: the fused ``wqkv`` / ``w_gateup`` keep the reference's row
order (q, k, v; gate, up) as a plain ``Shard(0)``, the layout XLA stores,
so checkpoints, reshards and exports see the reference's rows; the block
gathers the product whole over ``model`` (``TensorParallel.gather``, whose
backward sums each rank's gradient back to the rank that holds the rows)
and takes its own heads, or gate and up halves. A head count ``model``
does not divide is run the same way: the projection's output is gathered
whole, and each rank runs its own query heads against every kv head (or
every head, where the query heads do not divide either; ``wo`` then takes
the rank's input columns of the whole output). The int8 recipes run on
local blocks: a column-parallel product is the unsharded product's
columns; a row-parallel one quantizes with the activation's and the
weight's absmax all-reduced (max) over ``model``, so its int8 values and
scales are the unsharded ones, and sums the fp32 partial products before
one cast (``Int8Dense``).

Over a ``seq`` axis > 1 a model with ``split_sequence`` is handed the
mesh: each rank of a ``seq`` group runs one chunk of every sequence, which
the steps cut (``train/trainer.py``, ``train/mlm.py``). The decoder
``Transformer``'s attention runs as ``attn_impl`` says (ring, Ulysses, or
gathered whole over ``seq``) and its MoE blocks route over the whole
sequence (``models/moe.py``); ``Bert``'s attention is gathered whole. A
model without one (the vision models, whose images have no sequence)
takes ``seq`` as one more replica axis: every rank of it steps the same
rows. Parameters are replicated over ``seq``: FSDP2 sums each gradient
over (data, fsdp), and where the sequence is split
``sum_grads_over_seq`` then sums its local block over ``seq`` before the
clip (a sum: the loss is a mean over the global count). What it refuses:
``seq`` > 1 for serving (the reference's ``serving_mesh`` fixes it at 1),
and ``expert`` > 1 for a dense model or one whose experts it does not
divide.

MoE blocks (``models/moe.py``; ``moe_parallel``): each expert weight is a
``DTensor`` over the (``expert``, ``model``) axes that split it, the
rank's experts and its block of ``F`` (gate and up column parallel,
``w_down`` row parallel), which FSDP2 then shards over (data, fsdp) on the
dim its rule gives ``fsdp``; the router stays whole. The batch is the same
on every ``expert`` and ``model`` rank, so the block dispatches every token
to the rank's own experts and sums over the axes, with no all-to-all (the
layout XLA derives from the reference's rules).

``shard_serving_model(model, mesh, rules)`` lays a serving model (the
engine's, ``models/serving.py``) out with plain local tensors and explicit
collectives instead of ``DTensor``s: a decode step runs one small product
after another, and ``DTensor``'s per-operator dispatch would sit on the
host path of every one. The rules decide the layout (``serving_cuts``): a
projection whose weight's rule puts ``model`` on its output rows (dim 0)
is column parallel and keeps the rank's rows of every leaf (``weight``, a
bias, ``weight_q`` and its per-output-channel ``weight_scale``; a fused
``wqkv`` / ``w_gateup`` keeps the rank's rows of each part, q_r | k_r |
v_r, as one compact copy, so no collective is added); one with ``model``
on its input columns (dim 1) is row parallel, keeps the rank's columns of
``weight`` / ``weight_q`` (a bias and an int8 scale stay whole) and sums
the partial products over ``model`` (``Dense.tp``); one with no ``model``
is whole. Between projections a block fits each activation to what the
next one takes (``TensorParallel.fit``: the rank's columns of a whole
activation, or a rank block gathered whole), so any mix of roles runs, as
XLA reshards any mix: attention the rules leave whole runs whole on every
rank, a whole ``wo`` / ``w_down`` after column-parallel inputs reads their
output gathered. ``embed``'s vocab rows and the head's vocab columns
(``lm_head``, ``lm_head_q`` with ``lm_head_scale``), where their rules
split them, are the rank's and gathered over ``model``
(``Transformer.embed_tp`` / ``head_tp``); a head split on its hidden dim
is row parallel, its partial logits summed (``head_row_tp``). A norm,
``pos_embed`` or ``embed``'s hidden dim split on ``model`` stays whole on
every rank (the reference's result is the whole norm). The KV pool holds
the rank's kv heads where every layer runs them head parallel and
``model`` divides them, else every kv head (the reference's
``kv_sharding``). Rules no projection can run raise, naming the leaf. A
leaf a size-1 axis does not split stays the tensor it was (a view, no
copy); a split leaf is copied out, so the whole tensor can be freed. With
``fsdp`` > 1 every block is ``fully_shard``-ed over the ``fsdp`` sub-mesh
on the dim its rule gives ``fsdp``, and FSDP2's forward gathers it for
each call; ``embed``, the head and the final norm stay whole over
``fsdp`` (the step and prefill models share them and the blocks:
``serving.multislot_twin``). ``data`` replicates the parameters.
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
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)
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
    MeshAxis,
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


def check_mesh(cfg, mesh, serving: bool = False) -> None:
    """Raise for a mesh this port does not run ``cfg`` on: a ``seq`` axis
    over 1 for serving (``serving``), or an ``expert`` axis over 1 unless
    ``cfg`` is an MoE model whose experts it divides (see the module
    docstring)."""
    sizes = mesh_shape(mesh)
    n_experts = getattr(cfg, "n_experts", 0)
    if sizes.get(AXIS_SEQ, 1) > 1 and serving:
        raise NotImplementedError(
            "serving runs no seq mesh axis > 1: the reference's serving_mesh "
            "fixes seq at 1 (a decode step has no sequence axis to split); "
            "split the sequence in training")
    expert = sizes.get(AXIS_EXPERT, 1)
    if expert > 1 and not n_experts:
        raise NotImplementedError(
            f"an expert mesh axis of {expert} splits the experts of an MoE "
            f"model (n_experts > 0); this model has none")
    if expert > 1 and n_experts % expert:
        raise ValueError(f"the expert mesh axis ({expert}) does not divide "
                         f"n_experts ({n_experts})")


def own_heads(cfg, n_model: int, q_block: bool = True,
              kv_block: bool = True) -> Tuple[bool, bool]:
    """(whether a rank runs its own query heads, and its own kv heads) over
    a ``model`` axis of ``n_model``. Its own query heads where the query
    projection's output comes as the rank's block (``q_block``) and
    ``model`` divides ``n_heads``; its own kv heads where, besides, the kv
    projections' outputs do (``kv_block``) and ``model`` divides
    ``n_kv_heads``. Heads a rank does not own are gathered whole."""
    own_q = q_block and cfg.n_heads % n_model == 0
    return own_q, own_q and kv_block and cfg.n_kv_heads % n_model == 0


def fused_parts(cfg, path: str) -> Optional[Tuple[int, ...]]:
    """The row counts of the parts of a fused projection's output (``wqkv``:
    q, k, v; ``w_gateup``: gate, up), by its module path; None for any
    other projection."""
    if path.endswith(".attn.wqkv"):
        hd = cfg.head_dim
        return (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd)
    if path.endswith(".mlp.w_gateup"):
        return (cfg.d_ff, cfg.d_ff)
    return None


def _axis_dim(name: str, rules: Sequence[PartitionRule], axis: str
              ) -> Optional[int]:
    """The dim the rule of ``name`` puts ``axis`` on (None: none)."""
    _, spec = rule_for_path(name, rules)
    for d, entry in enumerate(spec):
        if axis in _axes(entry):
            return d
    return None


def _dense_parts(block: nn.Module) -> Tuple[str, ...]:
    """A block's parts made of ``Dense`` projections: its attention, and
    its MLP unless it is an MoE block (``block.moe``, laid out apart)."""
    return ("attn", "mlp") if hasattr(block, "mlp") else ("attn",)


#: the projections a model axis makes row parallel (their input columns):
#: the attention's output and the MLP's last, in the decoder and the
#: encoder; every other projection is column parallel
_ROW_PARALLEL = ("wo", "w_down", "w_proj")


def parallelize_projections(module: nn.Module, tp_mesh,
                            projections: Dict[str, nn.Module],
                            gathered: bool = False) -> None:
    """``parallelize_module`` of ``module`` over the one-dim ``tp_mesh``,
    in place: each of ``projections`` (by path in ``module``) row parallel
    where its name is in ``_ROW_PARALLEL``, else column parallel, with its
    ``role`` set to match. ``gathered``: a column-parallel product's output
    comes gathered whole, as a replicated ``DTensor`` whose backward keeps
    the rank's block of the gradient (every rank reads the whole alike)."""
    col = ColwiseParallel(output_layouts=Replicate() if gathered else None)
    row = RowwiseParallel()
    plan = {}
    for path, proj in projections.items():
        proj.role = int(path.rpartition(".")[2] in _ROW_PARALLEL)
        plan[path] = row if proj.role else col
    parallelize_module(module, tp_mesh, plan)


def vocab_parallel(model: nn.Module, tp_mesh) -> None:
    """``embed`` (its vocab rows) and ``lm_head`` (its vocab columns), where
    ``model`` has them, as ``DTensor`` parameters split over the one-dim
    ``tp_mesh``, in place: ``models/transformer.py``'s ``_embed`` and
    ``_logits`` gather their products."""
    for name, dim in (("embed", 0), ("lm_head", 1)):
        p = getattr(model, name, None)
        if p is not None:
            setattr(model, name, nn.Parameter(distribute_tensor(
                p.data, tp_mesh, [Shard(dim)], src_data_rank=None),
                requires_grad=p.requires_grad))


def tensor_parallel(model: nn.Module, tp_mesh) -> None:
    """``shard_model``'s tensor parallelism over the one-dim ``tp_mesh``,
    in place: every input projection (``wq``/``wk``/``wv`` or ``wqkv``;
    ``w_gate``/``w_up`` or ``w_gateup``) column parallel and
    ``wo``/``w_down`` row parallel (``parallelize_projections``), and the
    vocab-sharded ``embed`` and ``lm_head`` (``vocab_parallel``). Each
    block's attention and MLP take the axis (``Attention.shard_heads``,
    ``MLP.shard``): they gather a fused product, or the heads ``model``
    does not divide, whole."""
    tp = TensorParallel(tp_mesh)
    own_q, own_kv = own_heads(model.cfg, tp.size)
    for block in model.blocks:
        parallelize_projections(block, tp_mesh, {
            f"{part}.{name}": proj for part in _dense_parts(block)
            for name, proj in getattr(block, part).named_children()})
        block.attn.shard_heads(tp, own_q, own_kv)
        if hasattr(block, "mlp"):
            block.mlp.shard(tp)
    vocab_parallel(model, tp_mesh)


#: an MoE leaf's dims (``models/moe.py``'s stacked layouts): its experts,
#: and the ``F`` that ``model`` may split (Megatron within each expert)
_MOE_DIMS = {"w_gate": (0, 2), "w_up": (0, 2), "w_down": (0, 1),
             "router": (None, None)}


def moe_cuts(names: Iterable[str], rules: Sequence[PartitionRule]
             ) -> Dict[str, Tuple[Optional[int], Optional[int]]]:
    """The dims the rules put ``expert`` and ``model`` on, for each MoE
    leaf (``blocks.{i}.moe.*``): ``expert`` on the experts (dim 0) or
    nowhere; ``model`` on the expert weights' ``F`` (column-parallel
    ``w_gate``/``w_up``, row-parallel ``w_down``) for every one of a
    block's weights or for none; the router whole. Any other layout
    raises ``ShardingValidationError``, naming the leaf."""
    cuts: Dict[str, Tuple[Optional[int], Optional[int]]] = {}
    for name in names:
        m = re.fullmatch(r"(blocks\.\d+\.moe)\.(\w+)", name)
        if not m:
            continue
        allowed = _MOE_DIMS[m[2]]
        got = (_axis_dim(name, rules, AXIS_EXPERT),
               _axis_dim(name, rules, AXIS_MODEL))
        if any(g is not None and g != a for g, a in zip(got, allowed)):
            raise ShardingValidationError(
                f"{name}: its rule puts {AXIS_EXPERT} on dim {got[0]} and "
                f"{AXIS_MODEL} on dim {got[1]}; an MoE leaf takes "
                f"{AXIS_EXPERT} on its experts (dim 0) and {AXIS_MODEL} on "
                f"F only ({allowed})")
        cuts[name] = got
    by_block: Dict[str, set] = {}
    for name, (_, model_dim) in cuts.items():
        if not name.endswith(".router"):
            by_block.setdefault(name.rpartition(".")[0], set()).add(
                model_dim is None)
    for path, whole in by_block.items():
        if len(whole) > 1:
            raise ShardingValidationError(
                f"{path}: the rules split F over {AXIS_MODEL} for some of "
                f"its expert weights and not for others")
    return cuts


def moe_axes(block_moe, mesh, cuts, path: str, tp=None) -> None:
    """Hand an MoE block (``moe.MoEMLP`` at ``path``) the axes its layout
    splits it over (``moe_cuts``): ``ep`` where its experts are split over
    ``expert``, ``tp`` (default the mesh's ``TensorParallel``, whose
    collectives a row-parallel int8 ``w_down`` takes) where ``F`` is
    split."""
    sizes = mesh_shape(mesh)
    expert_dim, model_dim = cuts[f"{path}.w_up"]
    block_moe.ep = (MeshAxis(mesh, AXIS_EXPERT)
                    if expert_dim is not None and sizes[AXIS_EXPERT] > 1
                    else None)
    block_moe.tp = (tp or TensorParallel(mesh)
                    if model_dim is not None and sizes[AXIS_MODEL] > 1
                    else None)


def moe_parallel(model: nn.Module, mesh, rules: Sequence[PartitionRule]
                 ) -> None:
    """``shard_model``'s layout of the MoE blocks, in place: each expert
    weight becomes a ``DTensor`` over the (``expert``, ``model``) axes
    that split it (its rank's experts and its block of ``F``; FSDP2 adds
    the data-parallel axes), each block is handed those axes
    (``moe_axes``) and the data-parallel ones whose ranks hold other rows
    (``MoEMLP.dp``: the load-balance loss is the global batch's)."""
    sizes = mesh_shape(mesh)
    names = [n for n, _ in model.named_parameters()]
    cuts = moe_cuts(names, rules)
    dp = tuple(MeshAxis(mesh, a) for a in (AXIS_DATA, AXIS_FSDP)
               if sizes[a] > 1)
    axes = [a for a in (AXIS_EXPERT, AXIS_MODEL) if sizes[a] > 1]
    sub = (None if not axes else mesh[axes[0]] if len(axes) == 1
           else mesh[tuple(axes)])
    for i, block in enumerate(model.blocks):
        block_moe = getattr(block, "moe", None)
        if block_moe is None:
            continue
        path = f"blocks.{i}.moe"
        for leaf in ("w_gate", "w_up", "w_down") if sub is not None else ():
            p = getattr(block_moe, leaf, None)
            if p is None:
                continue
            dims = cuts[f"{path}.{leaf}"]
            placements = [
                Replicate() if dims[j] is None else Shard(dims[j])
                for j in (0 if a == AXIS_EXPERT else 1 for a in axes)]
            setattr(block_moe, leaf, nn.Parameter(distribute_tensor(
                p.data, sub, placements, src_data_rank=None),
                requires_grad=p.requires_grad))
        moe_axes(block_moe, mesh, cuts, path)
        block_moe.dp = dp


def shard_model(model: nn.Module, mesh, rules: Sequence[PartitionRule]
                ) -> nn.Module:
    """Lay ``model`` out on ``mesh`` under ``rules`` in place (see the
    module docstring) and return it, with ``model.layout`` set. Its
    parameters become ``DTensor``s: build the optimizer after this."""
    rules = tuple(rules)
    if layout_of(model) is not None:
        raise ValueError("the model is laid out on a mesh already")
    check_mesh(getattr(model, "cfg", None), mesh)
    # every parameter validated before anything is placed
    named_sharding(dict(model.named_parameters()), mesh, rules)
    sizes = mesh_shape(mesh)
    if sizes[AXIS_MODEL] > 1:
        # the model says what a model axis does to it
        model.tensor_parallel(mesh[AXIS_MODEL])
    if getattr(getattr(model, "cfg", None), "n_experts", 0):
        moe_parallel(model, mesh, rules)
    if sizes[AXIS_SEQ] > 1 and hasattr(model, "split_sequence"):
        model.split_sequence(mesh)
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
    if hasattr(model, "features"):
        # the chunked loss calls ``features``, not ``forward``: gather there
        register_fsdp_forward_method(model, "features")
    for module in model.modules():
        if isinstance(module, FSDPModule):
            # a sum: the loss is a mean over the global targets already
            module.set_gradient_divide_factor(1.0)
            module.set_force_sum_reduction_for_comms(True)
    model.layout = Layout(mesh, rules)
    return model


def sum_grads_over_seq(model: nn.Module, mesh) -> None:
    """Each parameter's gradient summed over the mesh's ``seq`` axis, in
    place, on its local block (every rank of a ``seq`` group holds the
    same blocks, each with its chunk's share); nothing on a ``seq`` axis
    of 1."""
    if mesh_shape(mesh).get(AXIS_SEQ, 1) == 1:
        return
    group = mesh.get_group(AXIS_SEQ)
    for p in model.parameters():
        if p.grad is not None:
            g = p.grad
            dist.all_reduce(g.to_local() if isinstance(g, DTensor) else g,
                            group=group)


class _Gather(torch.autograd.Function):
    """The whole of dim ``dim`` from each rank's block of it along a
    ``MeshAxis``; the backward sums the gradient over the axis and keeps
    the rank's block (a reduce-scatter, as an all-reduce and a slice: gloo
    has no reduce-scatter): each rank reads its own part of the whole, and
    every rank's reading of a block reaches the rank that holds it."""

    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=axis.group)
        n = g.shape[dim] // axis.size
        return g.narrow(dim, axis.rank * n, n), None, None


def gather(x: torch.Tensor, axis, dim: int = -1) -> torch.Tensor:
    """``axis.all_gather(x, dim)`` with a gradient (``_Gather``) where
    autograd records one."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, axis, dim)
    return axis.all_gather(x, dim)


class TensorParallel(MeshAxis):
    """A model's ``model`` axis (``MeshAxis``: its process group, this
    rank's index on it and its size) and the collectives a laid-out model
    calls (``shard_serving_model``; ``tensor_parallel``'s blocks and int8
    products). Each runs also on a group of one, where it is an identity.
    Made from a mesh with a ``model`` dim or from the one-dim ``model``
    mesh itself."""

    def __init__(self, mesh) -> None:
        super().__init__(mesh, None if mesh.ndim == 1 else AXIS_MODEL)

    def reduce(self, y: torch.Tensor) -> torch.Tensor:
        """Sum a row-parallel product's partial results over the axis."""
        dist.all_reduce(y, group=self.group)
        return y

    def reduce_max(self, y: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the axis, in place: a row-parallel int8
        product's row absmax over the whole K."""
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
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
        """``all_gather`` with a gradient (``_Gather``) where autograd
        records one."""
        return gather(x, self)

    def fit(self, t: torch.Tensor, width: int) -> torch.Tensor:
        """``t`` with ``width`` on its last dim: as it is, gathered whole
        from the ranks' blocks, or this rank's block of the whole."""
        have = t.shape[-1]
        if have == width:
            return t
        if have * self.size == width:
            return self.gather(t)
        if have == width * self.size:
            return t.narrow(-1, self.rank * width, width)
        raise ValueError(f"an activation of width {have} cannot fit {width} "
                         f"over a model axis of {self.size}")

    def block(self, p: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``p`` along ``dim``: ``p`` itself when the
        axis does not split it, else a compact copy."""
        if self.size == 1:
            return p
        n = p.shape[dim] // self.size
        return p.detach().narrow(dim, self.rank * n, n).clone()

    def parts_block(self, p: torch.Tensor, parts: Sequence[int]
                    ) -> torch.Tensor:
        """This rank's rows of each part of a fused leaf (``parts``: their
        row counts along dim 0), as one compact copy: q_r | k_r | v_r."""
        if self.size == 1:
            return p
        return torch.cat([self.block(t, 0) for t in
                          p.detach().split(list(parts), dim=0)])


#: what the model dim of a projection's weight makes it
_ROLES = {None: "whole", 0: "column parallel", 1: "row parallel"}
#: the root leaves a serving model splits over ``model``, and on which dim:
#: the vocab (embed's rows, the head's columns and scale) or the head's
#: hidden dim (row parallel); any other root leaf stays whole
_ROOT_DIMS = {"embed": (0,), "lm_head": (1, 0), "lm_head_q": (1, 0),
              "lm_head_scale": (0,)}


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


def serving_cuts(names: Iterable[str], rules: Sequence[PartitionRule]
                 ) -> Tuple[Dict[str, int], List[str]]:
    """The serving layout the rules give a model's parameters (``names``)
    over the ``model`` axis: the dim each split parameter is cut on, by
    name, and the row-parallel projections, by module path.
    Each projection's role comes from its weight's rule
    (``_projection_cuts``), and any mix of roles runs (the blocks fit each
    activation to the next projection). ``embed`` splits on its vocab
    rows, the head (``lm_head``, or ``lm_head_q`` with its scale) on its
    vocab columns or its hidden rows; a root leaf split otherwise (a norm,
    ``pos_embed``, ``embed``'s hidden dim) stays whole. What no projection
    can run raises (the engine's plan calls this before anything moves):
    a ``model`` dim past a weight's rank, a leaf whose own rule disagrees
    with its projection's role, a head scale split unlike its values."""
    names = list(names)
    cuts: Dict[str, int] = {}
    rows: List[str] = []
    projections: Dict[str, List[str]] = {}
    others = []
    for name in names:
        m = re.fullmatch(r"(blocks\.\d+\.(?:attn|mlp)\.\w+)\.(\w+)", name)
        if m:
            projections.setdefault(m[1], []).append(m[2])
        else:
            others.append(name)
    for path, leaves in projections.items():
        role, leaf_cuts = _projection_cuts(path, leaves, rules)
        cuts.update(leaf_cuts)
        if role == 1:
            rows.append(path)
    for name in others:
        dim = _axis_dim(name, rules, AXIS_MODEL)
        if dim is not None and dim in _ROOT_DIMS.get(name, ()):
            cuts[name] = dim
    if "lm_head_q" in names and (cuts.get("lm_head_q") == 1) != (
            "lm_head_scale" in cuts):
        raise ShardingValidationError(
            "lm_head_q and lm_head_scale: the rules split one over "
            f"{AXIS_MODEL}'s vocab and not the other")
    return cuts, rows


@dataclasses.dataclass(frozen=True)
class ServingLayout:
    """What the rules make of a serving model over ``model``
    (``serving_layout``): ``serving_cuts``' cuts and row-parallel
    projections, whether each layer runs its own query heads, and whether
    the KV pool holds each rank's kv heads (``kv_split``: every layer runs
    its own, the reference's ``kv_sharding`` where ``model`` divides the
    kv heads) or every kv head."""

    cuts: Dict[str, int]
    rows: List[str]
    own_q: Tuple[bool, ...]
    kv_split: bool


def serving_layout(cfg, names: Iterable[str],
                   rules: Sequence[PartitionRule], n_model: int
                   ) -> ServingLayout:
    """``serving_cuts`` and the heads each rank runs, for ``cfg``'s model.
    A fused projection split on its rows needs ``model`` to divide each
    of its parts (``ShardingValidationError``)."""
    names = list(names)
    cuts, rows = serving_cuts(names, rules)
    moe_cuts(names, rules)

    def column(path: str) -> bool:
        return 0 in (cuts.get(f"{path}.weight"), cuts.get(f"{path}.weight_q"))

    own_q, own_kv = [], []
    for i in range(cfg.n_layers):
        for part in ("attn.wqkv", "mlp.w_gateup"):
            parts = fused_parts(cfg, f".{part}")
            path = f"blocks.{i}.{part}"
            if column(path) and any(n % n_model for n in parts):
                raise ShardingValidationError(
                    f"{path}: {AXIS_MODEL}={n_model} does not divide its "
                    f"parts {parts} (each rank keeps its rows of each)")
        attn = f"blocks.{i}.attn"
        if cfg.fused_qkv:
            q = kv = column(f"{attn}.wqkv")
        else:
            q = column(f"{attn}.wq")
            kv = column(f"{attn}.wk") and column(f"{attn}.wv")
        heads = own_heads(cfg, n_model, q, kv)
        own_q.append(heads[0])
        own_kv.append(heads[1])
    return ServingLayout(cuts, rows, tuple(own_q), all(own_kv))


def _cut_experts(model: nn.Module, mesh, rules, tp: TensorParallel) -> None:
    """A serving model's MoE blocks as plain local tensors: each expert
    weight keeps its rank's experts over ``expert`` and its block of ``F``
    over ``model`` (``moe_cuts``), and each block sums ``w_down``'s partial
    products over ``model`` and the combined output over ``expert``
    (``moe_axes``)."""
    cuts = moe_cuts([n for n, _ in model.named_parameters()], rules)
    if not cuts:
        return
    sizes = mesh_shape(mesh)
    axes = {AXIS_EXPERT: MeshAxis(mesh, AXIS_EXPERT), AXIS_MODEL: tp}
    for name, dims in cuts.items():
        path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(path)
        t = getattr(mod, leaf)
        for axis, dim in zip((AXIS_EXPERT, AXIS_MODEL), dims):
            if dim is not None and sizes[axis] > 1:
                a = axes[axis]
                n = t.shape[dim] // a.size
                t = t.detach().narrow(dim, a.rank * n, n).clone()
        _keep(mod, leaf, t)
    for i, block in enumerate(model.blocks):
        if hasattr(block, "moe"):
            moe_axes(block.moe, mesh, cuts, f"blocks.{i}.moe", tp)


def _keep(module: nn.Module, name: str, t: torch.Tensor) -> None:
    if t is not getattr(module, name):
        setattr(module, name, nn.Parameter(t, requires_grad=False))


def shard_serving_model(model: nn.Module, mesh,
                        rules: Sequence[PartitionRule]) -> TensorParallel:
    """Lay a serving (decode-mode) model out on ``mesh`` in place (see the
    module docstring); returns its ``TensorParallel``. Refuses what
    ``check_mesh`` and ``serving_layout`` refuse, and validates every
    parameter against ``rules``, before anything moves."""
    rules = tuple(rules)
    if layout_of(model) is not None:
        raise ValueError("the model is laid out on a mesh already")
    cfg = model.cfg
    check_mesh(cfg, mesh, serving=True)
    named_sharding(dict(model.named_parameters()), mesh, rules)
    names = [n for n, _ in model.named_parameters()]
    tp = TensorParallel(mesh)
    layout = serving_layout(cfg, names, rules, tp.size)
    cuts = layout.cuts
    for name, dim in cuts.items():
        path, _, leaf = name.rpartition(".")
        mod = model.get_submodule(path)
        parts = fused_parts(cfg, path)
        t = getattr(mod, leaf)
        _keep(mod, leaf, tp.block(t, dim) if parts is None or dim
              else tp.parts_block(t, parts))
    for i, block in enumerate(model.blocks):
        for part in _dense_parts(block):
            for name, proj in getattr(block, part).named_children():
                path = f"blocks.{i}.{part}.{name}"
                proj.role = (1 if path in layout.rows else
                             0 if any(k.startswith(f"{path}.") for k in cuts)
                             else None)
        if tp.size > 1:
            block.attn.shard_heads(tp, layout.own_q[i], layout.kv_split,
                                   compact=True)
            if hasattr(block, "mlp"):
                block.mlp.shard(tp, compact=True)
    _cut_experts(model, mesh, rules, tp)
    for path in layout.rows:
        model.get_submodule(path).tp = tp
    if "embed" in cuts:
        model.embed_tp = tp
    head = cuts.get("lm_head", cuts.get("lm_head_q"))
    tied = not {"lm_head", "lm_head_q"} & set(names)
    if head == 1 or "embed" in cuts and tied:
        model.head_tp = tp              # a tied head is embed's transpose
    elif head == 0:
        model.head_row_tp = tp
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
