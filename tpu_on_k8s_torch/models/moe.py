"""Mixture-of-Experts MLP: the counterpart of ``tpu_on_k8s/models/moe.py``.

GShard top-k routing with a capacity per (batch row, expert), written as the
reference writes it: dense one-hot dispatch and combine masks ``[B, L, E,
C]``, the experts' products batched over the expert dim, and the Switch
load-balance loss. The routing runs in fp32 on an fp32 router ``[D, E]``
whatever ``param_dtype`` says. ``capacity = max(1, int(capacity_factor · k ·
l / E))`` with ``l`` the length of the call's own sequence, so a prefill
bucket, a prefill chunk, a verify window and a decode step (capacity 1)
each route with their own. ``k`` rounds of argmax: each round's gate is the
chosen probability (not renormalised), each chosen token takes the next slot
of its expert in its row (tokens earlier in the sequence win; the fill is
carried across rounds) and a token past the capacity is dropped (its
residual carries it). The dispatch mask is in x's dtype, the combine in
fp32, cast to ``cfg.dtype`` before the last product; the expert weights,
stacked ``w_gate``/``w_up [E, D, F]`` and ``w_down [E, F, D]`` as the
reference stacks them, are cast to ``cfg.dtype`` at each use. ``mlp_int8``
runs the experts' products through ``ops/int8_matmul.int8_matmul_batched``
(``int8_impl`` chooses the route). The dispatch, combine and expert
products are plain batched products (``torch.einsum``/``bmm``), as the
reference leaves them to XLA.

``forward`` returns ``(y, aux)``: the load-balance loss ``E · Σ_e
token_frac_e · prob_frac_e`` comes back by value (the reference ``sow``s it),
so a checkpoint that runs the forward twice counts it once.

On a mesh (``parallel/sharded.py``) the block holds its rank's experts
(``ep``: the ``expert`` axis, a block of ``E / expert`` experts) and, within
each expert, its rank's columns of ``w_gate``/``w_up`` and rows of
``w_down`` over ``F`` (``tp``: the ``model`` axis, Megatron; under
``mlp_int8`` ``w_down`` quantizes over the whole ``F`` and sums its fp32
partial products before one cast, as ``Int8Dense`` does). The batch is
the same on every rank of both axes, as in the reference, so no all-to-all
is needed: every rank routes all tokens (the router is whole), dispatches
them to its own experts only, sums ``w_down``'s partial products over
``model`` and the combined output over ``expert``. In training the inputs
of that region (x, and the combine weights) take their gradients summed
over the axes (``sum_grad_over``) and its outputs are summed with an
identity backward (``sum_over``), so the router, the norm and everything
before the block see every rank's experts. The load-balance loss is
computed from the whole routing on every rank, once. Training's step
(``train/trainer.py``) sets ``dp`` on a data-parallel mesh: the load-balance
statistics are then summed over the ranks that hold other rows of the
batch, so the loss is the global batch's, as the reference's.

On a ``seq`` axis (``seq``, which ``Transformer.split_sequence`` sets: the
rank holds one chunk of every row) the block routes as the reference
routes the whole sequence: the capacity comes from the whole length, and
in each of the k rounds a token's slot counts the tokens of the chunks
before its own (an exclusive prefix of the per-(row, expert) counts, from
one all-gather of ``[B, E]`` a round), so the slots are the whole
sequence's. Each slot then holds one token of one chunk: a rank's
dispatch fills the slots of its own tokens, its expert products leave the
others zero, and its combine reads its own, so no token moves between
ranks. The load-balance statistics are summed over ``seq`` as over the
data-parallel axes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from tpu_on_k8s_torch.ops.int8_matmul import int8_matmul_batched

_REGION = threading.local()


@contextlib.contextmanager
def batched_products():
    """Marks the experts' batched products (dispatch, expert products,
    combine) for the remat policies: the reference's
    ``dots_with_no_batch_dims_saveable`` does not save a product with a
    batch dim, and an expert's int8 product, which runs as a 2-D operator
    one expert at a time, is one."""
    depth = getattr(_REGION, "depth", 0)
    _REGION.depth = depth + 1
    try:
        yield
    finally:
        _REGION.depth = depth


def in_batched_products() -> bool:
    return getattr(_REGION, "depth", 0) > 0


class _SumOver(torch.autograd.Function):
    """Forward: the sum over the process groups; backward: the identity."""

    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone(memory_format=torch.contiguous_format)
        for group in groups:
            dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradOver(torch.autograd.Function):
    """Forward: the identity; backward: the gradient summed over the
    process groups."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def _groups(*axes) -> Tuple:
    return tuple(a.group for a in axes if a is not None and a.size > 1)


def sum_over(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` summed over the mesh axes (``MeshAxis``es; None or a size-1
    axis is skipped), with an identity backward."""
    groups = _groups(*axes)
    if not groups:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOver.apply(x, groups)
    for group in groups:
        dist.all_reduce(x, group=group)
    return x


def sum_grad_over(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over the mesh axes."""
    groups = _groups(*axes)
    if not groups or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _SumGradOver.apply(x, groups)


def _local(w: torch.Tensor) -> torch.Tensor:
    """A parameter's block on this rank: a ``DTensor``'s local tensor (its
    gradient comes back as a ``DTensor`` of the same layout)."""
    return w.to_local() if isinstance(w, DTensor) else w


def capacity(cfg, length: int) -> int:
    """The slots each expert has in each batch row, for a call of
    ``length`` tokens: the reference's Python float expression."""
    return max(1, int(cfg.expert_capacity_factor * cfg.experts_top_k
                      * length / cfg.n_experts))


class Routing(NamedTuple):
    """What the router makes of ``x [B, L, D]``: the probabilities ``[B, L,
    E]`` (fp32), the dispatch mask ``[B, L, E, C]`` in x's dtype and the
    combine weights ``[B, L, E, C]`` in fp32."""

    probs: torch.Tensor
    dispatch: torch.Tensor
    combine: torch.Tensor


def route(x: torch.Tensor, router: torch.Tensor, k: int,
          cap: int, seq=None) -> Routing:
    """GShard top-k routing with a capacity of ``cap`` per (row, expert).
    ``seq`` (a ``MeshAxis``): ``x`` is the rank's chunk of every row, and
    the slots are counted over the whole rows, the chunks of the ranks
    before this one first."""
    b, l, _ = x.shape
    e = router.shape[-1]
    logits = torch.matmul(x.float(), router.float())        # [B, L, E]
    probs = torch.softmax(logits, dim=-1)
    remaining = probs
    fill = torch.zeros(b, 1, e, dtype=torch.int32, device=x.device)
    slots = torch.arange(cap, device=x.device)
    experts = torch.arange(e, device=x.device)
    dispatch = torch.zeros(b, l, e, cap, dtype=x.dtype, device=x.device)
    combine = torch.zeros(b, l, e, cap, dtype=torch.float32, device=x.device)
    for _ in range(k):
        choice = remaining.argmax(dim=-1)                    # [B, L]
        gate = remaining.gather(-1, choice[..., None])[..., 0]
        # F.one_hot's range check would sync the host with the card
        onehot_e = (choice[..., None] == experts).to(torch.int32)  # [B, L, E]
        counts = onehot_e.sum(dim=1, keepdim=True, dtype=torch.int32)
        before = 0
        if seq is not None:
            # every chunk's counts [n, B, 1, E]: the chunks before this one
            # take their slots first, and the round fills the whole rows'
            every = seq.all_gather(counts[None], 0)
            before = every[:seq.rank].sum(dim=0, dtype=torch.int32)
            counts = every.sum(dim=0, dtype=torch.int32)
        # slot index per token: tokens earlier in the sequence win
        pos = (fill + before + torch.cumsum(onehot_e, dim=1, dtype=torch.int32)
               - onehot_e)
        slot = (pos * onehot_e).sum(dim=-1)                  # [B, L]
        # a slot at or past the capacity matches no column: dropped
        onehot_c = slot[..., None] == slots                  # [B, L, C]
        mask = (onehot_e.bool()[..., None]
                & onehot_c[:, :, None, :]).to(x.dtype)
        dispatch = dispatch + mask
        combine = combine + mask.float() * gate[:, :, None, None]
        fill = fill + counts
        remaining = remaining * (1.0 - onehot_e.float())
    return Routing(probs, dispatch, combine)


def load_balance(routing: Routing, dp: Sequence = ()) -> torch.Tensor:
    """Switch's load-balance loss ``E · Σ_e token_frac_e · prob_frac_e``:
    the share of the rows' tokens that reach each expert (read from the
    dispatch mask) times its mean probability. With ``dp`` (the
    data-parallel axes, ``MeshAxis``es whose ranks hold other rows) both
    are the global batch's: the local sums and the token count are summed
    over them in one all-reduce (rows that two ranks hold alike count
    twice in both, so the shares are unchanged)."""
    e = routing.probs.shape[-1]
    reached = (routing.dispatch.sum(dim=-1) > 0).float()     # [B, L, E]
    if not _groups(*dp):
        return e * torch.sum(reached.mean(dim=(0, 1))
                             * routing.probs.mean(dim=(0, 1)))
    n = reached.shape[0] * reached.shape[1]
    stats = sum_over(torch.cat([routing.probs.sum(dim=(0, 1)),
                                reached.sum(dim=(0, 1)),
                                reached.new_full((1,), float(n))]), *dp)
    prob_frac, token_frac = stats[:e] / stats[-1], stats[e:2 * e] / stats[-1]
    return e * torch.sum(token_frac * prob_frac)


class MoEMLP(nn.Module):
    """The dense MLP's drop-in: ``forward(x [B, L, D])`` → ``(y [B, L, D],
    the load-balance loss)``. Parameters: ``router [D, E]`` (fp32),
    ``w_gate`` (SwiGLU only) and ``w_up [E, D, F]``, ``w_down [E, F, D]``
    in ``cfg.param_dtype``. ``activation="gelu"`` runs ``w_down(gelu(
    w_up(x)))`` with the tanh form; SwiGLU ``w_down(silu(w_gate(x)) ·
    w_up(x))``."""

    #: the ``expert`` and ``model`` axes a layout sets (a ``MeshAxis`` and
    #: a ``TensorParallel``; None: the whole product is here), and the
    #: data-parallel axes whose ranks hold other rows of the batch (a
    #: training layout's)
    ep = None
    tp = None
    dp: Sequence = ()
    #: the ``seq`` axis whose ranks hold the other chunks of every row
    #: (None: the rows are whole here)
    seq = None

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.gelu = cfg.activation == "gelu"
        self.router = nn.Parameter(torch.empty(d, e, dtype=torch.float32))
        if not self.gelu:
            self.w_gate = nn.Parameter(torch.empty(e, d, f,
                                                   dtype=cfg.param_dtype))
        self.w_up = nn.Parameter(torch.empty(e, d, f, dtype=cfg.param_dtype))
        self.w_down = nn.Parameter(torch.empty(e, f, d,
                                               dtype=cfg.param_dtype))

    def _product(self, a: torch.Tensor, w: torch.Tensor,
                 rows=None) -> torch.Tensor:
        """``a [E, B, C, K] @ w [E, K, N]`` per expert, w cast to
        ``cfg.dtype``. ``rows`` (the ``model`` axis, for ``w_down``: a and w
        hold one block of K) sums the partial products over the axis; an
        int8 product is then quantized over the whole K and sums its fp32
        partial products before one cast, as ``Int8Dense`` does."""
        cfg = self.cfg
        w = w.to(cfg.dtype)
        if cfg.mlp_int8:
            sums = ({} if rows is None else
                    dict(reduce_max=rows.reduce_max, reduce_sum=rows.reduce))
            return int8_matmul_batched(a, w, cfg.int8_impl, **sums)
        e, b, c, kk = a.shape
        y = torch.bmm(a.reshape(e, b * c, kk), w).view(e, b, c, -1)
        return sum_over(y, rows)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        n_seq = 1 if self.seq is None else self.seq.size
        routing = route(x, self.router, cfg.experts_top_k,
                        capacity(cfg, x.shape[1] * n_seq), self.seq)
        aux = load_balance(routing, (*self.dp, self.seq))
        w_up = _local(self.w_up)
        w_down = _local(self.w_down)
        n = w_up.shape[0]
        e0 = self.ep.rank * n if self.ep is not None else 0
        dispatch = routing.dispatch[:, :, e0:e0 + n]
        # the combine's gradient and x's are summed over the ranks that
        # hold the other experts (and the other columns of F)
        combine = sum_grad_over(routing.combine, self.ep)[:, :, e0:e0 + n]
        x_in = sum_grad_over(x, self.ep, self.tp)
        with batched_products():
            expert_in = torch.einsum("blec,bld->ebcd", dispatch, x_in)
            if self.gelu:
                h = F.gelu(self._product(expert_in, w_up), approximate="tanh")
            else:
                h = (F.silu(self._product(expert_in, _local(self.w_gate)))
                     * self._product(expert_in, w_up))
            out = self._product(h, w_down, self.tp)
            y = torch.einsum("ebcd,blec->bld", out, combine.to(cfg.dtype))
        return sum_over(y, self.ep), aux
