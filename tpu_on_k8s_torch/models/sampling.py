"""Token sampling: greedy, temperature, top-k, nucleus (top-p).

Counterpart of ``tpu_on_k8s/models/sampling.py``. Random draws take an
explicit ``torch.Generator``; a sample is the Gumbel-max draw that
``jax.random.categorical`` makes, so the two packages agree in distribution,
not bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Sampling configuration.

    ``temperature <= 0`` is greedy argmax and ignores the rest. ``top_k``
    keeps the k highest logits; ``top_p`` keeps the smallest set of
    tokens whose probability mass reaches p (the first token always
    survives). Both filters compose: top-k first, then top-p over the
    renormalized survivors.
    """

    temperature: float = 0.0
    top_k: int = 0        # 0 = off
    top_p: float = 0.0    # 0 or 1 = off (values outside [0, 1] rejected)

    def __post_init__(self):
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 <= self.top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {self.top_p}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0


_NEG = -1e30


def _top_k_mask(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask all but EXACTLY the k highest logits per row to -1e30. Ties
    truncate by index, as ``jax.lax.top_k`` does: a stable descending sort,
    not ``torch.topk``. k beyond the vocabulary clamps."""
    k = min(k, logits.shape[-1])
    idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices
    keep = torch.zeros_like(logits, dtype=torch.bool).scatter_(
        -1, idx[..., :k], True)
    return torch.where(keep, logits, _NEG)


def _top_p_mask(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest prefix of the probability-sorted
    vocabulary whose mass reaches ``p``; the top token always survives."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # a token is kept if the mass BEFORE it is < p (so the token that
    # crosses the threshold is included)
    keep_sorted = (cum - probs) < p
    kth = torch.where(keep_sorted, sorted_logits,
                      torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= kth, logits, _NEG)


def sample(logits: torch.Tensor, generator: torch.Generator,
           params: SamplingParams) -> torch.Tensor:
    """Next token (int32) per row of ``logits [..., V]`` under ``params``."""
    if params.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / params.temperature
    if params.top_k:
        logits = _top_k_mask(logits, params.top_k)
    if 0.0 < params.top_p < 1.0:
        logits = _top_p_mask(logits, params.top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)
