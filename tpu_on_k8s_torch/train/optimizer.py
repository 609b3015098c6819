"""The reference's optimizer, optax's chain written out by hand.

``default_optimizer`` in ``tpu_on_k8s/train/trainer.py`` is
``chain(clip_by_global_norm, adamw(warmup_cosine_decay_schedule))`` (or,
with ``nu_dtype``, its ``_scale_by_adam_lp`` variant). ``torch.optim.AdamW``
and ``clip_grad_norm_`` compute other functions (an epsilon in the clip, a
decoupled decay scaled differently, the schedule read after the increment),
so ``ClipAdamW`` repeats optax's arithmetic step for step:

1. ``clip_by_global_norm``: g if ‖g‖ < max, else g / ‖g‖ · max (no epsilon);
   ‖g‖ is the global norm over every parameter, returned by ``step``
   (``max_grad_norm=None``: no clip and no norm, ``optax.adam(w)``'s chain);
2. Adam moments with bias correction at the incremented count;
   ``mu_hat / (sqrt(nu_hat) + eps)``;
3. weight decay on every parameter (norms and embedding included):
   ``update += wd · p``;
4. ``update *= −lr(count)`` with the schedule read at the count *before*
   the increment, so the first step runs at lr 0 under warmup from 0;
5. ``p += update``.

``adam`` and ``adamw`` build ``optax.adam`` and ``optax.adamw`` (b2 0.999,
no clip) this way, and ``SGD`` is ``optax.sgd``'s chain: the vision and
BERT examples' optimizers.

Moment dtypes: ``mu_dtype`` alone is ``optax.adamw(mu_dtype=…)``: this
step's fp32 mu drives the update and is stored cast. With ``nu_dtype`` both
moments are cast first and the cast values drive the update, as
``_scale_by_adam_lp`` does. Parameters are updated in place.

On a mesh (``parallel/sharded.py``) the parameters, gradients and moments
are ``DTensor``s, each moment laid out like its parameter. The update is
element-wise, so it runs on each rank's local blocks, in the same order of
operations as off a mesh. The clip's norm is that of the full gradient:
each rank sums the squares of the blocks it owns (a block replicated over
a mesh axis counts once, at coordinate 0 of that axis), and all-reduces
over the mesh's axes add them.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

Schedule = Callable[[int], float]


def as_schedule(learning_rate: Union[float, Schedule]) -> Schedule:
    """A learning rate as optax takes it: a schedule of the count, or a
    constant."""
    if callable(learning_rate):
        return learning_rate
    return lambda count: learning_rate


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
    a 0-d fp32 tensor on their device (no host sync); with
    ``max_grad_norm=None`` nothing is clipped and it returns None."""

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: Optional[float] = 1.0,
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
        #: the mesh the parameters are laid out on (``Trainer`` sets it)
        self.mesh = None
        self._owned: Optional[list] = None

    def hyperparameters(self) -> dict:
        """The keyword arguments that rebuild this optimizer's arithmetic
        over other parameters (``ClipAdamW(params, **them)``)."""
        group = self.param_groups[0]
        return dict(schedule=self.schedule, b1=group["b1"], b2=group["b2"],
                    eps=group["eps"], weight_decay=group["weight_decay"],
                    max_grad_norm=self.max_grad_norm,
                    mu_dtype=self.mu_dtype, nu_dtype=self.nu_dtype)

    def rebind(self, params: Iterable[torch.Tensor]) -> None:
        """Point a fresh optimizer (no step taken, no moments made) at other
        parameters: the ones a model has after ``shard_model`` replaced
        them."""
        if self.count or self.state:
            raise ValueError("the optimizer has state already: lay the "
                             "model out on its mesh before it steps")
        self.param_groups[0]["params"] = list(params)
        self._owned = None

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
        norm = (None if self.max_grad_norm is None
                else torch.sqrt(self._square_sum(params)))
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            for p in group["params"]:
                self._update(p, group, norm, lr)
        return norm

    def _square_sum(self, params) -> torch.Tensor:
        """Σ over the parameters of each gradient's sum of squares: off a
        mesh in one sum; on one, the blocks this rank owns, all-reduced."""
        if self.mesh is None:
            return sum(torch.sum(p.grad.float().square()) for p in params)
        if self._owned is None:
            self._owned = [_owns_block(p, self.mesh) for p in params]
        total = sum(torch.sum(_local(p.grad).float().square()) if own
                    else torch.zeros((), device=_local(p.grad).device)
                    for p, own in zip(params, self._owned))
        for i in range(self.mesh.ndim):
            if self.mesh.size(i) > 1:     # the sum over each axis in turn
                dist.all_reduce(total, group=self.mesh.get_group(i))
        return total

    def _update(self, p: torch.Tensor, group: dict, norm: torch.Tensor,
                lr: float) -> None:
        b1, b2, eps = group["b1"], group["b2"], group["eps"]
        g = _local(p.grad)
        if norm is not None:
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
            mu = (1 - b1) * g + b1 * _local(state["mu"]).to(g.dtype)
            nu = (1 - b2) * g.square() + b2 * _local(state["nu"])
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
            _store(state, "mu", mu.to(state["mu"].dtype))
            _store(state, "nu", nu)
        else:
            # _scale_by_adam_lp: accumulate in fp32, store, use the stored
            mu = (b1 * _local(state["mu"]).to(f32)
                  + (1 - b1) * g.to(f32)).to(self.mu_dtype or g.dtype)
            nu = (b2 * _local(state["nu"]).to(f32)
                  + (1 - b2) * g.to(f32).square()).to(self.nu_dtype)
            update = ((mu.to(f32) / bc1)
                      / (torch.sqrt(nu.to(f32) / bc2) + eps)).to(g.dtype)
            _store(state, "mu", mu)
            _store(state, "nu", nu)
        w = _local(p)
        if group["weight_decay"]:
            update = update + group["weight_decay"] * w
        w.add_(-lr * update)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _store(state: dict, key: str, value: torch.Tensor) -> None:
    """A moment's new value: into a ``DTensor`` moment's local block in
    place (its layout stays its parameter's), else as the new tensor."""
    if isinstance(state[key], DTensor):
        state[key].to_local().copy_(value)
    else:
        state[key] = value


def _owns_block(p: torch.Tensor, mesh) -> bool:
    """Whether this rank's block of ``p`` counts toward the global norm: on
    every axis of ``mesh`` that does not shard ``p``, the rank sits at
    coordinate 0 (so each replicated block counts once)."""
    sharded = set()
    if isinstance(p, DTensor):
        names = p.device_mesh.mesh_dim_names
        sharded = {names[i] for i, pl in enumerate(p.placements)
                   if isinstance(pl, Shard)}
    coord = mesh.get_coordinate()
    if coord is None:
        return False
    return all(c == 0 for c, name in zip(coord, mesh.mesh_dim_names)
               if name not in sharded)


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


class SGD(torch.optim.Optimizer):
    """``optax.sgd(learning_rate, momentum, nesterov)``: with a momentum
    the trace ``t' = g + momentum·t`` (zeros at first), the update ``g +
    momentum·t'`` (nesterov) or ``t'``; without one the update is ``g``;
    then ``p += −lr(count)·update``, the schedule read at the count before
    the increment, as ``ClipAdamW``. Element-wise, so on a mesh it runs on
    each rank's local blocks, each trace laid out like its parameter.
    ``step()`` returns None."""

    def __init__(self, params: Iterable[torch.Tensor],
                 learning_rate: Union[float, Schedule],
                 momentum: Optional[float] = None, nesterov: bool = False):
        super().__init__(params, dict(momentum=momentum, nesterov=nesterov))
        self.schedule = as_schedule(learning_rate)
        #: optimizer steps taken (optax's ``count``)
        self.count = 0

    def rebind(self, params: Iterable[torch.Tensor]) -> None:
        """Point a fresh optimizer at other parameters (``ClipAdamW``'s)."""
        if self.count or self.state:
            raise ValueError("the optimizer has state already: lay the "
                             "model out on its mesh before it steps")
        self.param_groups[0]["params"] = list(params)

    @torch.no_grad()
    def step(self, closure=None) -> None:
        if closure is not None:
            raise ValueError("SGD.step takes no closure")
        lr = self.schedule(self.count)
        self.count += 1
        for group in self.param_groups:
            m = group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    raise ValueError("a parameter has no gradient")
                g = _local(p.grad)
                if m is not None:
                    state = self.state[p]
                    if not state:
                        state["trace"] = torch.zeros_like(p)
                    trace = g + m * _local(state["trace"])
                    _store(state, "trace", trace)
                    g = g + m * trace if group["nesterov"] else trace
                _local(p).add_(-lr * g)


def adam(params: Iterable[torch.Tensor],
         learning_rate: Union[float, Schedule]) -> ClipAdamW:
    """``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8): ``ClipAdamW`` with no
    weight decay and no clip."""
    return adamw(params, learning_rate, weight_decay=0.0)


def adamw(params: Iterable[torch.Tensor],
          learning_rate: Union[float, Schedule],
          weight_decay: float = 1e-4) -> ClipAdamW:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8) with no mask: the decay
    on every parameter, norms and biases included; no clip."""
    return ClipAdamW(params, as_schedule(learning_rate), b2=0.999,
                     weight_decay=weight_decay, max_grad_norm=None)
