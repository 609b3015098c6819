"""The training step on one card: the counterpart of
``tpu_on_k8s/train/trainer.py``.

Next-token cross-entropy on fp32 logits (or chunked, never materialising
them), packed-window positions, segments and loss masks, gradient
accumulation weighted by counted targets, and ``ClipAdamW`` (optax's chain).
PyTorch idiom in place of JAX's: the model's parameters and the optimizer's
state are the training state and are updated in place; a step is eager, not
jitted. There is no mesh: the reference's sharding rules and its
``TrainState`` are for the slice that ports mesh sharding.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from tpu_on_k8s_torch.models.transformer import Transformer
from tpu_on_k8s_torch.train.optimizer import ClipAdamW, default_optimizer


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token CE, ``logsumexp − gold``. logits [B, L, V] fp32;
    targets [B, L] int; ``mask`` [B, L] (1 = count the token)."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _chunk_nll_sum(f: torch.Tensor, head: torch.Tensor, t: torch.Tensor,
                   m: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(f.float(), head.float())
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
    denom = n if mask is None else torch.clamp(mk.sum(), min=1.0)
    return total / denom


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


LossFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _make_loss_fn(model: Transformer, loss_chunks: int,
                  segment_eos: Optional[int] = None) -> LossFn:
    """tokens [B, L+1] → (objective, weight), shared by the train and eval
    steps. ``weight`` counts the targets the mean covers: gradient
    accumulation weights microbatch means by it."""

    def loss_fn(tokens: torch.Tensor):
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        positions = segments = loss_mask = None
        if segment_eos is not None:
            positions, segments = packed_positions_and_segments(
                inputs, segment_eos)
            loss_mask = packed_loss_mask(tokens, segment_eos)
        if loss_chunks:
            feats, head = model.features(inputs, positions, segments)
            ce = chunked_cross_entropy(feats, head, targets, loss_chunks,
                                       mask=loss_mask)
        else:
            logits = model(inputs, positions, segments=segments)
            ce = cross_entropy_loss(logits, targets, mask=loss_mask)
        weight = (loss_mask.sum() if loss_mask is not None
                  else torch.tensor(float(inputs.numel()),
                                    device=tokens.device))
        return ce, weight

    return loss_fn


def make_eval_step(model: Transformer, loss_chunks: int = 0,
                   segment_eos: Optional[int] = None
                   ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Forward-only loss on a [B, L+1] batch, the train step's objective:
    {"loss", "perplexity"}. No gradients, no state change."""
    loss_fn = _make_loss_fn(model, loss_chunks, segment_eos)

    @torch.no_grad()
    def step(tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        loss, _ = loss_fn(tokens)
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return step


def make_train_step(model: Transformer, optimizer: ClipAdamW,
                    loss_chunks: int = 0, grad_accum: int = 1,
                    segment_eos: Optional[int] = None
                    ) -> Callable[[torch.Tensor], Dict[str, object]]:
    """One training step on a [B, L+1] token batch (next-token CE, shifted
    inside): gradients into each parameter's ``.grad``, then one optimizer
    step. Returns {"loss", "grad_norm" (before the clip)} as 0-d device
    tensors and "step", the optimizer's count before this step.

    ``grad_accum`` > 1 splits the batch into that many microbatches and sums
    their gradients, each weighted by its counted targets, in fp32, then
    divides by the total weight before the one update: the full-batch mean
    even when packed loss masks count different targets per microbatch."""
    loss_fn = _make_loss_fn(model, loss_chunks, segment_eos)
    params = list(model.parameters())

    def step(tokens: torch.Tensor) -> Dict[str, object]:
        count = optimizer.count
        if grad_accum <= 1:
            loss, _ = loss_fn(tokens)
            grads = torch.autograd.grad(loss, params)
        else:
            b = tokens.shape[0]
            if b % grad_accum:
                raise ValueError(
                    f"batch {b} not divisible by grad_accum {grad_accum}")
            gsum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            lsum = wsum = torch.zeros((), device=tokens.device)
            for mb in tokens.reshape(grad_accum, b // grad_accum, -1):
                mloss, w = loss_fn(mb)
                for s, g in zip(gsum, torch.autograd.grad(mloss, params)):
                    s.add_(w * g.float())
                lsum, wsum = lsum + w * mloss.detach(), wsum + w
            wsum = torch.clamp(wsum, min=1.0)
            grads = [(s / wsum).to(p.dtype) for s, p in zip(gsum, params)]
            loss = lsum / wsum
        for p, g in zip(params, grads):
            p.grad = g
        grad_norm = optimizer.step()
        for p in params:
            p.grad = None
        return {"loss": loss.detach(), "grad_norm": grad_norm,
                "step": count}

    return step


class Trainer:
    """A model, its optimizer (``default_optimizer`` over the model's
    parameters unless given) and the steps built from them: ``train_step``
    and ``eval_step`` on [B, L+1] token batches on the model's device."""

    def __init__(self, model: Transformer,
                 optimizer: Optional[ClipAdamW] = None,
                 loss_chunks: int = 0, grad_accum: int = 1,
                 segment_eos: Optional[int] = None):
        self.model = model
        self.optimizer = optimizer or default_optimizer(model.parameters())
        self._step = make_train_step(model, self.optimizer, loss_chunks,
                                     grad_accum, segment_eos)
        self._eval = make_eval_step(model, loss_chunks, segment_eos)

    def train_step(self, tokens: torch.Tensor) -> Dict[str, object]:
        return self._step(tokens)

    def eval_step(self, tokens: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._eval(tokens)
