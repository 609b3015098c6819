"""The reference's optimizer, optax's chain written out by hand.

``default_optimizer`` in ``tpu_on_k8s/train/trainer.py`` is
``chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))`` (or,
with ``nu_dtype``, its ``_scale_by_adam_lp`` variant). ``torch.optim.AdamW``
and ``clip_grad_norm_`` compute other functions (an epsilon in the clip, a
decoupled decay scaled differently, the schedule read after the increment),
so ``ClipAdamW`` repeats optax's arithmetic step for step:

1. ``clip_by_global_norm``: g if ‖g‖ < max, else g / ‖g‖ · max (no epsilon);
   ‖g‖ is the global norm over every parameter, returned by ``step``;
2. Adam moments with bias correction at the incremented count;
   ``mu_hat / (sqrt(nu_hat) + eps)``;
3. weight decay on every parameter (norms and embedding included):
   ``update += wd · p``;
4. ``update *= −lr(count)`` with the schedule read at the count *before*
   the increment, so the first step runs at lr 0 under warmup from 0;
5. ``p += update``.

Moment dtypes: ``mu_dtype`` alone is ``optax.adamw(mu_dtype=…)``: this
step's fp32 mu drives the update and is stored cast. With ``nu_dtype`` both
moments are cast first and the cast values drive the update, as
``_scale_by_adam_lp`` does. Parameters are updated in place.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import numpy as np
import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine to
    ``end_value`` at ``decay_steps``. Evaluated in fp32, as optax does."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def linear(count: int) -> f32:
        if warmup_steps <= 0:
            return f32(init_value)
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count: int) -> f32:
        c = f32(min(count, cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        return f32(peak_value) * (f32(1 - alpha) * decay + f32(alpha))

    def schedule(count: int) -> float:
        return float(linear(count) if count < warmup_steps
                     else cosine(count - warmup_steps))

    return schedule


class ClipAdamW(torch.optim.Optimizer):
    """optax's ``clip_by_global_norm → adamw`` chain (see the module
    docstring). ``step()`` takes no closure, reads each parameter's
    ``.grad``, and returns the global norm of the gradients before the clip,
    a 0-d fp32 tensor on their device (no host sync)."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 mu_dtype: Optional[torch.dtype] = None,
                 nu_dtype: Optional[torch.dtype] = None):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.mu_dtype = mu_dtype
        self.nu_dtype = nu_dtype
        #: optimizer steps taken (optax's ``count``)
        self.count = 0

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def init_state(self) -> None:
        """Allocate both moments (zeros, in ``mu_dtype`` / ``nu_dtype``) of
        every parameter that has none yet: what the first ``step`` would
        make, so a checkpoint of a fresh run, or a template to restore
        into, holds them."""
        for p in self._params():
            state = self.state[p]
            if not state:
                state["mu"] = torch.zeros_like(
                    p, dtype=self.mu_dtype or p.dtype)
                state["nu"] = torch.zeros_like(
                    p, dtype=self.nu_dtype or p.dtype)

    @torch.no_grad()
    def step(self, closure=None) -> torch.Tensor:
        if closure is not None:
            raise ValueError("ClipAdamW.step takes no closure")
        params = self._params()
        missing = [i for i, p in enumerate(params) if p.grad is None]
        if missing:
            raise ValueError(f"parameters {missing} have no gradient")
        # optax.global_norm: sqrt of the sum over leaves of each leaf's sum
        norm = torch.sqrt(sum(torch.sum(p.grad.float().square())
                              for p in params))
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            for p in group["params"]:
                self._update(p, group, norm, lr)
        return norm

    def _update(self, p: torch.Tensor, group: dict, norm: torch.Tensor,
                lr: float) -> None:
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        g = p.grad
        g = torch.where(norm < self.max_grad_norm, g,
                        (g / norm.to(g.dtype)) * self.max_grad_norm)
        if not self.state[p]:
            self.init_state()
        state = self.state[p]
        f32 = torch.float32
        count = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(b1) ** count)
        bc2 = float(np.float32(1) - np.float32(b2) ** count)
        if self.nu_dtype is None:
            # optax.scale_by_adam: update from this step's mu and nu
            mu = (1 - b1) * g + b1 * state["mu"].to(g.dtype)
            nu = (1 - b2) * g.square() + b2 * state["nu"]
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            state["mu"] = mu.to(state["mu"].dtype)
            state["nu"] = nu
        else:
            # _scale_by_adam_lp: accumulate in fp32, store, use the stored
            mu = (b1 * state["mu"].to(f32) + (1 - b1) * g.to(f32)).to(
                self.mu_dtype or g.dtype)
            nu = (b2 * state["nu"].to(f32) + (1 - b2) * g.to(f32).square()
                  ).to(self.nu_dtype)
            update = ((mu.to(f32) / bc1)
                      / (torch.sqrt(nu.to(f32) / bc2) + eps)).to(g.dtype)
            state["mu"], state["nu"] = mu, nu
        update = update + group["weight_decay"] * p
        p.add_(-lr * update)


def default_optimizer(params: Iterable[torch.Tensor],
                      learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      decay_steps: int = 10000,
                      max_grad_norm: float = 1.0,
                      mu_dtype: Optional[torch.dtype] = None,
                      nu_dtype: Optional[torch.dtype] = None) -> ClipAdamW:
    """The reference's ``default_optimizer``: clip at 1.0, AdamW (b1 0.9,
    b2 0.95, eps 1e-8, weight decay 0.1), warmup-cosine from 0 to
    ``learning_rate``."""
    sched = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(decay_steps, warmup_steps + 1))
    return ClipAdamW(params, sched, weight_decay=weight_decay,
                     max_grad_norm=max_grad_norm, mu_dtype=mu_dtype,
                     nu_dtype=nu_dtype)
