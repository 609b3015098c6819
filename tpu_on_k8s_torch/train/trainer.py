"""The training step on one card: the counterpart of
``tpu_on_k8s/train/trainer.py``.

Next-token cross-entropy on fp32 logits (or chunked, never materialising
them), plus ``aux_loss_weight`` times the MoE blocks' load-balance loss
(every step reports ``"aux_loss"``), packed-window positions, segments and
loss masks, gradient
accumulation weighted by counted targets, ``ClipAdamW`` (optax's chain),
the ``TrainState`` a checkpoint holds and ``Trainer.fit``, which drives
``train/loop.py``'s ``TrainLoop``. PyTorch idiom in place of JAX's: the
model's parameters and the optimizer's state are the training state and are
updated in place (a ``TrainState`` names them, with the step); a step is
eager, not jitted.

On a mesh (``Trainer(model, rules=..., mesh=...)``, the reference's
``Trainer(model, rules, mesh, opt)``) the model is laid out by
``parallel/sharded.py`` (tensor parallelism over ``model``, FSDP2 over
``data`` and ``fsdp``) and each rank takes the rows of its (data, fsdp)
coordinate (``shard_batch``). On a ``seq`` axis > 1 each rank then runs
one chunk of every row: the steps shift the ``[b, L+1]`` rows, then keep
the rank's chunk of the inputs, targets, loss mask, segments and *global*
positions (so RoPE and a learned position table read the right rows),
and the model's attention runs over ``seq`` as ``attn_impl`` says
(``parallel/ring.py``, ``parallel/ulysses.py``, or gathered whole). The
objective stays the reference's: a mean over the global batch's counted
targets. Each rank sums its targets' loss and divides by the count
all-reduced over (data, fsdp, seq); FSDP2 sums the gradients over (data,
fsdp) and ``sum_grads_over_seq`` over ``seq``, so packed batches whose
masks count different targets on different ranks, and microbatches
likewise, weigh as one batch. Unlike the reference's, the ``Trainer``
enters no ``ring_context``: ``shard_model`` hands each block's attention
the mesh itself.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.models.params import load_model
from tpu_on_k8s_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    _logits,
)
from torch.distributed.tensor import DTensor, distribute_tensor

from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_SEQ,
    MeshAxis,
    NamedSharding,
    batch_sharding,
    data_shard,
    local_rows,
    mesh_shape,
)
from tpu_on_k8s_torch.parallel.sharded import (
    layout_of,
    shard_model,
    sum_grads_over_seq,
)
from tpu_on_k8s_torch.train.optimizer import ClipAdamW, default_optimizer


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE, ``logsumexp − gold``. logits [B, L, V] fp32;
    targets [B, L] int; ``mask`` [B, L] (1 = count the token)."""
    nll = _nll(logits, targets)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - gold


def _chunk_nll_sum(f: torch.Tensor, head: torch.Tensor, t: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
    logits = _logits(f, head)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t.long()[:, None])[:, 0]
    return ((lse - gold) * m).sum()


def chunked_cross_entropy(feats: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor, n_chunks: int = 8,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean next-token CE without the [B, L, V] logits: ``feats`` [B, L, D]
    and ``head`` [D, V] from ``Transformer.features``. The B·L tokens go in
    ``n_chunks`` chunks, each under a checkpoint: its logits are made,
    reduced to Σ(lse − gold)·mask and dropped, and remade in the backward
    pass. The chunk sums add in order, in fp32."""
    total, denom = _chunked_nll_sum(feats, head, targets, n_chunks, mask)
    return total / (denom if mask is None
                    else torch.clamp(denom, min=1.0))


def _chunked_nll_sum(feats, head, targets, n_chunks: int, mask):
    """(Σ(lse − gold)·mask over the chunks, the count of targets)."""
    b, l, d = feats.shape
    n = b * l
    if n % n_chunks:
        raise ValueError(f"B*L={n} not divisible by n_chunks={n_chunks}")
    chunk = n // n_chunks
    fl = feats.reshape(n_chunks, chunk, d)
    tg = targets.reshape(n_chunks, chunk)
    mk = (torch.ones(n_chunks, chunk, device=feats.device) if mask is None
          else mask.reshape(n_chunks, chunk).float())
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(n_chunks):
        total = total + checkpoint(_chunk_nll_sum, fl[i], head, tg[i], mk[i],
                                   use_reentrant=False)
    return total, (n if mask is None else mk.sum())


def packed_positions_and_segments(tokens: torch.Tensor, eos_id: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positions, segments) [B, L] int32 for stream-packed windows: a
    token's segment is the number of EOS tokens strictly before it (the EOS
    closes its own document), and its position restarts at each segment."""
    eq = (tokens == eos_id).to(torch.int32)
    segments = torch.cumsum(eq, dim=1, dtype=torch.int32) - eq
    idx = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=tokens.device)[None, :]
    # start of a token's segment = (last EOS index before it) + 1: an
    # exclusive running max of (i+1)·[token_i is EOS]
    cmax = torch.cummax((idx + 1) * eq, dim=1).values
    starts = torch.cat([torch.zeros_like(cmax[:, :1]), cmax[:, :-1]], dim=1)
    return idx - starts, segments


def packed_loss_mask(tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """[B, L] fp32 mask over the shifted targets of packed ``tokens
    [B, L+1]``: a position counts only when its input and target share a
    segment (no EOS → next-document targets, no EOS-padded tails)."""
    _, seg = packed_positions_and_segments(tokens, eos_id)
    return (seg[:, :-1] == seg[:, 1:]).float()


LossFn = Callable[[torch.Tensor],
                  Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]


def _aux_term(aux: torch.Tensor, aux_loss_weight: float) -> torch.Tensor:
    """The load-balance loss a step reports: the model's (summed over its
    MoE blocks) where ``aux_loss_weight`` folds it into the objective, else
    0, as the reference collects the ``losses`` only then."""
    if aux_loss_weight:
        return aux
    return torch.zeros((), dtype=torch.float32, device=aux.device)


def _make_loss_fn(model: Transformer, loss_chunks: int,
                  segment_eos: Optional[int] = None,
                  aux_loss_weight: float = 0.0) -> LossFn:
    """tokens [B, L+1] → (objective, (aux, weight)), shared by the train
    and eval steps: the objective is ``ce + aux_loss_weight · aux``, aux
    the MoE blocks' load-balance loss (0 for a dense model or a weight of
    0). ``weight`` counts the targets the mean covers: gradient
    accumulation weights microbatch means by it."""

    def loss_fn(tokens: torch.Tensor):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        positions = segments = loss_mask = None
        if segment_eos is not None:
            positions, segments = packed_positions_and_segments(
                inputs, segment_eos)
            loss_mask = packed_loss_mask(tokens, segment_eos)
        if loss_chunks:
            feats, head, aux = model.features(inputs, positions, segments,
                                              with_aux=True)
            ce = chunked_cross_entropy(feats, head, targets, loss_chunks,
                                       mask=loss_mask)
        else:
            logits, aux = model(inputs, positions, segments=segments,
                                with_aux=True)
            ce = cross_entropy_loss(logits, targets, mask=loss_mask)
        weight = (loss_mask.sum() if loss_mask is not None
                  else torch.full((), float(inputs.numel()),
                                  device=tokens.device))
        aux = _aux_term(aux, aux_loss_weight)
        loss = ce + aux_loss_weight * aux if aux_loss_weight else ce
        return loss, (aux, weight)

    return loss_fn


def make_eval_step(model: Transformer, loss_chunks: int = 0,
                   segment_eos: Optional[int] = None,
                   aux_loss_weight: float = 0.0
                   ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Forward-only loss on a [B, L+1] batch, the train step's objective:
    {"loss", "perplexity", "aux_loss"}, the perplexity that of the
    cross-entropy alone (``exp(loss − aux_loss_weight · aux)``). No
    gradients, no state change."""
    loss_fn = _make_loss_fn(model, loss_chunks, segment_eos, aux_loss_weight)

    @torch.no_grad()
    def step(tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        loss, (aux, _) = loss_fn(tokens)
        return {"loss": loss,
                "perplexity": torch.exp(loss - aux_loss_weight * aux),
                "aux_loss": aux}

    return step


GradsFn = Callable[[torch.Tensor],
                   Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]]


def make_grads_fn(model: Transformer, loss_chunks: int = 0,
                  grad_accum: int = 1, segment_eos: Optional[int] = None,
                  aux_loss_weight: float = 0.0) -> GradsFn:
    """The step's forward and backward on a [B, L+1] token batch, without
    the update: tokens → (loss, one gradient per parameter, aux loss). The
    loss is the objective, ``ce + aux_loss_weight · aux``.

    ``grad_accum`` > 1 splits the batch into that many microbatches and sums
    their gradients, each weighted by its counted targets, in fp32, then
    divides by the total weight: the full-batch mean even when packed loss
    masks count different targets per microbatch. The aux loss is the
    microbatches' weighted mean alike."""
    loss_fn = _make_loss_fn(model, loss_chunks, segment_eos, aux_loss_weight)
    params = list(model.parameters())

    def grads_fn(tokens: torch.Tensor):
        if grad_accum <= 1:
            loss, (aux, _) = loss_fn(tokens)
            return (loss, list(torch.autograd.grad(loss, params)),
                    aux.detach())
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(
                f"batch {b} not divisible by grad_accum {grad_accum}")
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        lsum = asum = wsum = torch.zeros((), device=tokens.device)
        for mb in tokens.reshape(grad_accum, b // grad_accum, -1):
            mloss, (aux, w) = loss_fn(mb)
            for s, g in zip(gsum, torch.autograd.grad(mloss, params)):
                s.add_(w * g.float())
            lsum, wsum = lsum + w * mloss.detach(), wsum + w
            asum = asum + w * aux.detach()
        wsum = torch.clamp(wsum, min=1.0)
        return lsum / wsum, [(s / wsum).to(p.dtype)
                             for s, p in zip(gsum, params)], asum / wsum

    return grads_fn


def make_train_step(model: Transformer, optimizer: ClipAdamW,
                    loss_chunks: int = 0, grad_accum: int = 1,
                    segment_eos: Optional[int] = None,
                    aux_loss_weight: float = 0.0
                    ) -> Callable[[torch.Tensor], Dict[str, object]]:
    """One training step on a [B, L+1] token batch (next-token CE, shifted
    inside, plus ``aux_loss_weight`` times the MoE load-balance loss):
    ``make_grads_fn``'s gradients into each parameter's ``.grad``, then one
    optimizer step. Returns {"loss", "aux_loss", "grad_norm" (before the
    clip)} as 0-d device tensors and "step", the optimizer's count before
    this step."""
    grads_fn = make_grads_fn(model, loss_chunks, grad_accum, segment_eos,
                             aux_loss_weight)
    params = list(model.parameters())

    def step(tokens: torch.Tensor) -> Dict[str, object]:
        count = optimizer.count
        loss, grads, aux = grads_fn(tokens)
        for p, g in zip(params, grads):
            p.grad = g
        grad_norm = optimizer.step()
        for p in params:
            p.grad = None
        return {"loss": loss.detach(), "aux_loss": aux,
                "grad_norm": grad_norm, "step": count}

    return step


def _dp_sum(t: torch.Tensor, mesh,
            axes=(AXIS_DATA, AXIS_FSDP, AXIS_SEQ)) -> torch.Tensor:
    """``t`` summed over the ranks that hold other targets of the batch, in
    place: over the data-parallel axes (data, fsdp) and ``seq`` (``axes``:
    those of them whose ranks hold other targets; a ``seq`` axis that
    splits nothing holds the same ones)."""
    sizes = mesh_shape(mesh)
    for axis in axes:
        if sizes[axis] > 1:
            dist.all_reduce(t, group=mesh.get_group(axis))
    return t


@dataclasses.dataclass
class _Rows:
    """What a rank's step runs of its ``[b, L+1]`` rows: the inputs and
    targets, and the positions, segments and loss mask (None where
    ``_make_loss_fn`` makes none) of its chunk of the sequence, and the
    count of its targets."""

    inputs: torch.Tensor
    targets: torch.Tensor
    positions: Optional[torch.Tensor]
    segments: Optional[torch.Tensor]
    mask: Optional[torch.Tensor]
    count: torch.Tensor


def _rank_rows(tokens: torch.Tensor, segment_eos: Optional[int],
               mesh) -> _Rows:
    """A ``[b, L+1]`` batch shifted and made into ``_make_loss_fn``'s
    positions, segments and mask, then cut to this rank's chunk of the
    sequence on a ``seq`` axis of n > 1 (chunk i of L/n, i the rank's place
    on ``seq``), with the positions global."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    positions = segments = mask = None
    if segment_eos is not None:
        positions, segments = packed_positions_and_segments(inputs,
                                                            segment_eos)
        mask = packed_loss_mask(tokens, segment_eos)
    n = mesh_shape(mesh)[AXIS_SEQ]
    if n > 1:
        l = inputs.shape[1]
        if l % n:
            raise ValueError(f"sequence {l} not divisible by {AXIS_SEQ}={n}")
        if positions is None:
            positions = torch.arange(l, dtype=torch.int32,
                                     device=tokens.device).expand_as(inputs)
        i, c = MeshAxis(mesh, AXIS_SEQ).rank, l // n
        inputs, targets, positions, segments, mask = (
            None if t is None else t[:, i * c:(i + 1) * c]
            for t in (inputs, targets, positions, segments, mask))
    count = (mask.sum() if mask is not None
             else torch.full((), float(inputs.numel()),
                             device=tokens.device))
    return _Rows(inputs, targets, positions, segments, mask, count)


def _nll_sum(model: Transformer, rows: _Rows, loss_chunks: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Σ over this rank's counted targets of the next-token loss, the
    model's load-balance loss: the global batch's on a laid-out MoE
    model)."""
    inputs, targets = rows.inputs, rows.targets
    positions, segments, mask = rows.positions, rows.segments, rows.mask
    if loss_chunks:
        feats, head, aux = model.features(inputs, positions, segments,
                                          with_aux=True)
        return (_chunked_nll_sum(feats, head, targets, loss_chunks,
                                 mask)[0], aux)
    logits, aux = model(inputs, positions, segments=segments, with_aux=True)
    nll = _nll(logits, targets)
    return (nll * mask).sum() if mask is not None else nll.sum(), aux


def make_sharded_grads_fn(model: Transformer, mesh, loss_chunks: int = 0,
                          grad_accum: int = 1,
                          segment_eos: Optional[int] = None,
                          aux_loss_weight: float = 0.0
                          ) -> Callable[[torch.Tensor],
                                        Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]]:
    """The sharded step's forward and backward, without the update: this
    rank's rows ``[b, L+1]`` → (the global batch's summed loss on this
    rank's rows and chunk, the global count of targets, the aux loss), each
    parameter's ``.grad`` the gradient of the global objective (summed by
    FSDP2 over the data-parallel ranks, then over ``seq``). Each
    microbatch's loss is its rows' summed loss over the global count of
    targets (all microbatches, all ranks), so the backward passes added up
    over the microbatches give the gradient of the global mean. The
    load-balance loss (the global batch's on every rank: ``moe.MoEMLP.dp``)
    enters each rank's objective once, weighted by its microbatch's share
    of the targets: its statistics' sum over the ranks has an identity
    backward, so FSDP2's sum over the ranks makes its whole gradient."""
    def grads(tokens: torch.Tensor):
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(
                f"batch {b} not divisible by grad_accum {grad_accum}")
        micro = tokens.reshape(grad_accum, b // grad_accum, -1)
        prepared = [_rank_rows(mb, segment_eos, mesh) for mb in micro]
        counts = _dp_sum(torch.stack([rows.count for rows in prepared]),
                         mesh)
        denom = torch.clamp(counts.sum(), min=1.0)
        lsum = asum = torch.zeros((), device=tokens.device)
        for rows, weight in zip(prepared, counts):
            part, aux = _nll_sum(model, rows, loss_chunks)
            objective = part / denom
            aux = _aux_term(aux, aux_loss_weight)
            if aux_loss_weight:
                objective = objective + aux_loss_weight * aux * (
                    weight / denom)
            objective.backward()
            lsum = lsum + part.detach()
            asum = asum + aux.detach() * weight
        sum_grads_over_seq(model, mesh)
        return lsum, denom, asum / denom

    return grads


def make_sharded_train_step(model: Transformer, optimizer: ClipAdamW,
                            mesh, loss_chunks: int = 0, grad_accum: int = 1,
                            segment_eos: Optional[int] = None,
                            aux_loss_weight: float = 0.0
                            ) -> Callable[[torch.Tensor],
                                          Dict[str, object]]:
    """``make_train_step`` for a model laid out on ``mesh``: this rank's
    rows ``[b, L+1]`` (``Trainer.shard_batch``) → the same metrics, of the
    global batch: ``make_sharded_grads_fn``'s gradients, then one
    optimizer step."""
    grads = make_sharded_grads_fn(model, mesh, loss_chunks, grad_accum,
                                  segment_eos, aux_loss_weight)

    def step(tokens: torch.Tensor) -> Dict[str, object]:
        count = optimizer.count
        lsum, denom, aux = grads(tokens)
        grad_norm = optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        loss = _dp_sum(lsum, mesh) / denom
        if aux_loss_weight:
            loss = loss + aux_loss_weight * aux
        return {"loss": loss, "aux_loss": aux, "grad_norm": grad_norm,
                "step": count}

    return step


def make_sharded_eval_step(model: Transformer, mesh, loss_chunks: int = 0,
                           segment_eos: Optional[int] = None,
                           aux_loss_weight: float = 0.0
                           ) -> Callable[[torch.Tensor],
                                         Dict[str, torch.Tensor]]:
    """``make_eval_step`` on this rank's rows: the global objective's loss,
    the perplexity of its cross-entropy and the aux loss. FSDP2 keeps the
    root's gathered parameters after a forward until the backward frees
    them; with no backward the step reshards them itself, so the model's
    parameters are again the optimizer's."""
    @torch.no_grad()
    def step(tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        rows = _rank_rows(tokens, segment_eos, mesh)
        try:
            part, aux = _nll_sum(model, rows, loss_chunks)
        finally:
            model.reshard()
        aux = _aux_term(aux, aux_loss_weight)
        ce = (_dp_sum(part, mesh)
              / torch.clamp(_dp_sum(rows.count, mesh), min=1.0))
        loss = ce + aux_loss_weight * aux if aux_loss_weight else ce
        return {"loss": loss,
                "perplexity": torch.exp(loss - aux_loss_weight * aux),
                "aux_loss": aux}

    return step


@dataclasses.dataclass
class TrainState:
    """What a checkpoint holds of a run: the model (its parameters, the fp32
    masters), the optimizer (both Adam moments in their stored dtypes and
    ``count``, which sets the schedule's learning rate and the bias
    correction) and the step. Updated in place by each step; the
    counterpart of the reference's ``TrainState(step, params, opt_state)``.

    ``state_dict()`` is the flat mapping a checkpoint stores, of the live
    tensors (no copies): ``params/<name>``, ``mu/<name>``, ``nu/<name>``
    for every parameter, and ``count`` and ``step`` as 0-d int64 tensors
    on the CPU. ``load_state_dict`` writes such a mapping back in place. On
    a mesh the tensors are ``DTensor``s (each moment laid out like its
    parameter), and a full tensor loads into one as its local block."""

    model: Transformer
    optimizer: ClipAdamW
    step: int = 0

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def state_dict(self) -> Dict[str, torch.Tensor]:
        self.optimizer.init_state()
        out = {}
        for name, p in self.model.named_parameters():
            out[f"params/{name}"] = p.data
        for name, p in self.model.named_parameters():
            out[f"mu/{name}"] = self.optimizer.state[p]["mu"]
        for name, p in self.model.named_parameters():
            out[f"nu/{name}"] = self.optimizer.state[p]["nu"]
        out["count"] = torch.tensor(self.optimizer.count, dtype=torch.int64)
        out["step"] = torch.tensor(self.step, dtype=torch.int64)
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        own = self.state_dict()
        if set(own) != set(sd):
            raise KeyError(f"state keys differ: missing "
                           f"{sorted(set(own) - set(sd))[:4]}, unexpected "
                           f"{sorted(set(sd) - set(own))[:4]}")
        for key, t in own.items():
            if key not in ("count", "step") and t is not sd[key]:
                _copy_into(t, sd[key])
        self.optimizer.count = int(sd["count"])
        self.step = int(sd["step"])


def _copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``src`` into ``dst`` in place: a full tensor into a ``DTensor`` as its
    block (every rank holds the full value; no communication), a
    ``DTensor`` into one of the same layout block for block."""
    if isinstance(dst, DTensor):
        if not isinstance(src, DTensor):
            src = distribute_tensor(src.to(dst.to_local().device),
                                    dst.device_mesh, dst.placements,
                                    src_data_rank=None)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def train_state_template(cfg: TransformerConfig,
                         device: str | torch.device = "cuda",
                         mesh=None, rules=None,
                         **optimizer_kwargs) -> TrainState:
    """An empty ``TrainState`` to restore a checkpoint into, the counterpart
    of the reference's ``abstract_train_state``: a model of ``cfg`` whose
    parameters are allocated on ``device`` and not initialised, and a
    ``default_optimizer(**optimizer_kwargs)`` over them with both moments
    allocated (in ``mu_dtype`` / ``nu_dtype``, as the run that saved used).
    With ``mesh`` and ``rules`` the model is laid out there first
    (``parallel/sharded.py``, validated before anything is allocated): each
    rank allocates its blocks only."""
    if (mesh is None) != (rules is None):
        raise ValueError("pass mesh and rules together (or neither)")
    dev = resolve_device(device)
    if mesh is not None:
        with torch.device("meta"):
            model = Transformer(cfg)
        shard_model(model, mesh, rules)
        model.to_empty(device=dev)
        optimizer = default_optimizer(model.parameters(), **optimizer_kwargs)
        optimizer.mesh = mesh
        optimizer.init_state()
        return TrainState(model, optimizer)
    with torch.device("meta"):
        shapes = Transformer(cfg).state_dict()
    model = load_model(cfg, {name: torch.empty_like(t, device=dev)
                             for name, t in shapes.items()}, dev)
    optimizer = default_optimizer(model.parameters(), **optimizer_kwargs)
    optimizer.init_state()
    return TrainState(model, optimizer)


class Trainer:
    """A model, its optimizer (``default_optimizer`` over the model's
    parameters unless given) and the steps built from them, on [B, L+1]
    token batches on the model's device.

    ``train_step(tokens)`` and ``eval_step(tokens)`` take one batch;
    ``train_step(state, tokens)`` → ``(state, metrics)`` and
    ``eval_step(state, tokens)`` are the reference's forms, on the
    ``TrainState`` of this trainer's model and optimizer (``state()``, or
    a restored ``train_state_template`` that the trainer was built on).
    ``fit`` drives ``TrainLoop``.

    With ``mesh`` (``parallel/mesh.py``'s ``create_mesh``) and ``rules``
    (default ``flagship_partition_rules()``) the model is laid out on the
    mesh (``parallel/sharded.py``; a model laid out there already, e.g. a
    restored template, is taken as it is) and a fresh optimizer is pointed
    at its new parameters; the steps then take this rank's rows
    (``shard_batch``). Without a mesh nothing changes.

    ``aux_loss_weight`` folds the MoE blocks' load-balance loss into the
    objective (``ce + aux_loss_weight · aux``), as the reference's; every
    step's metrics carry ``"aux_loss"`` (0 for a dense model or a weight
    of 0)."""

    def __init__(self, model: Transformer,
                 optimizer: Optional[ClipAdamW] = None,
                 loss_chunks: int = 0, grad_accum: int = 1,
                 segment_eos: Optional[int] = None, *,
                 rules=None, mesh=None, aux_loss_weight: float = 0.0):
        self.model = model
        self.mesh = mesh
        if mesh is None:
            if rules is not None:
                raise ValueError("rules without a mesh lay nothing out")
            self.rules = None
            self.optimizer = optimizer or default_optimizer(
                model.parameters())
            self._grads = make_grads_fn(model, loss_chunks, grad_accum,
                                        segment_eos, aux_loss_weight)
            self._step = make_train_step(model, self.optimizer, loss_chunks,
                                         grad_accum, segment_eos,
                                         aux_loss_weight)
            self._eval = make_eval_step(model, loss_chunks, segment_eos,
                                        aux_loss_weight)
            return
        from tpu_on_k8s_torch.models.transformer import (
            flagship_partition_rules,
        )
        self.rules = tuple(flagship_partition_rules() if rules is None
                           else rules)
        layout = layout_of(model)
        if layout is None:
            shard_model(model, mesh, self.rules)
        elif layout.mesh is not mesh or layout.rules != self.rules:
            raise ValueError("the model is laid out on another mesh or "
                             "under other rules")
        if optimizer is None:
            optimizer = default_optimizer(model.parameters())
        elif layout is None:
            optimizer.rebind(model.parameters())
        optimizer.mesh = mesh
        self.optimizer = optimizer
        self._grads = make_sharded_grads_fn(model, mesh, loss_chunks,
                                            grad_accum, segment_eos,
                                            aux_loss_weight)
        self._step = make_sharded_train_step(model, optimizer, mesh,
                                             loss_chunks, grad_accum,
                                             segment_eos, aux_loss_weight)
        self._eval = make_sharded_eval_step(model, mesh, loss_chunks,
                                            segment_eos, aux_loss_weight)

    def shard_batch(self, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a batch every rank holds in full (the
        reference's ``shard_batch``): its (data, fsdp) coordinate's block;
        an axis that does not divide the batch is shed (those ranks take
        the same rows). The ``[B, L+1]`` rows stay whole over ``seq``: the
        steps cut each rank's chunk after the shift. Off a mesh, the batch
        itself."""
        if self.mesh is None:
            return tokens
        spec = batch_sharding(self.mesh, tokens.shape).spec[:1]
        return local_rows(tokens, NamedSharding(self.mesh, spec))

    def data_shard(self) -> Tuple[int, int]:
        """(shard id, shard count) for this rank's ``DataLoader``: its
        (data, fsdp) coordinate among data × fsdp (ranks that differ only
        on ``model`` read the same rows). (0, 1) off a mesh. A loader so
        sharded yields this rank's rows, which the steps take as they are:
        the reference's ``shard_local_batch`` has nothing left to do."""
        return (0, 1) if self.mesh is None else data_shard(self.mesh)

    def state(self) -> TrainState:
        """This trainer's ``TrainState``, at the optimizer's count."""
        return TrainState(self.model, self.optimizer, self.optimizer.count)

    def _check(self, state: TrainState) -> None:
        if state.model is not self.model or (
                state.optimizer is not self.optimizer):
            raise ValueError("the TrainState is not this trainer's model and "
                             "optimizer")

    def train_step(self, *args):
        """``train_step(tokens)`` → metrics, or ``train_step(state,
        tokens)`` → ``(state, metrics)`` with ``state.step`` advanced."""
        if len(args) == 1:
            return self._step(args[0])
        state, tokens = args
        self._check(state)
        metrics = self._step(tokens)
        state.step += 1
        return state, metrics

    def eval_step(self, *args) -> Dict[str, torch.Tensor]:
        """Forward-only loss and perplexity: ``eval_step(tokens)`` or
        ``eval_step(state, tokens)``. No state changes."""
        if len(args) == 2:
            self._check(args[0])
        return self._eval(args[-1])

    def fit(self, state: TrainState, batches, steps: int, **loop_kwargs):
        """Drive ``steps`` training steps through ``TrainLoop``
        (device-resident metrics, bounded dispatch, non-blocking
        checkpoints; ``train/loop.py``), as the reference's ``fit``.
        ``batches`` yields device-ready token batches (pair with
        ``data/prefetch.py``'s ``device_prefetch``). Returns a
        ``LoopResult``."""
        from tpu_on_k8s_torch.train.loop import TrainLoop

        self._check(state)
        return TrainLoop(self.train_step, state, batches,
                         **loop_kwargs).run(steps)
