"""Classifier training: the counterpart of ``tpu_on_k8s/train/vision.py``.

The same shape as the LM ``Trainer`` (``train/trainer.py``), on
``(images, labels)`` batches, with the model's BatchNorm running
statistics (its buffers, the reference's ``batch_stats``) carried through
the step: a training step normalises with the batch's statistics and
updates them, an evaluation reads them. A model without BatchNorm
(``MnistCNN``) runs the same step.

On a mesh (``ClassifierTrainer(model, opt, rules=..., mesh=...)``) the
model is laid out by ``parallel/sharded.py`` (FSDP2 over data × fsdp on
the rules' dims; the rules name no ``model`` axis, so a model axis holds
whole weights), each rank takes the rows of its (data, fsdp) coordinate
(``shard_batch``), every BatchNorm sums its statistics over the batch axes
(``models/vision.py``'s ``sync_batch_stats``), and the objective stays the
reference's mean over the global batch: each rank's summed loss over the
all-reduced count, with FSDP2 summing the gradients. A ``seq`` axis is one
more replica axis, as the reference's ``data_sharding`` leaves images
whole over it: every rank of it steps the same rows, so the count, the
statistics and the gradients are summed over (data, fsdp) alone.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    data_shard,
    data_sharding,
    local_rows,
    mesh_shape,
)
from tpu_on_k8s_torch.parallel.sharded import shard_model
from tpu_on_k8s_torch.train.optimizer import SGD
from tpu_on_k8s_torch.train.trainer import _copy_into, _dp_sum, _nll


@dataclasses.dataclass
class ClassifierState:
    """The step, the model (its parameters and BatchNorm buffers) and the
    optimizer: the reference's ``ClassifierState(step, params, batch_stats,
    opt_state)``, updated in place by each step."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over integer labels. logits [B, C] fp32; labels [B] int."""
    return _nll(logits, labels).mean()


class ClassifierTrainer:
    """Model + optimizer (default ``optax.sgd(0.1, momentum=0.9)``'s) +
    mesh + partition rules for image classification, on NHWC image batches
    and integer labels on the model's device. Without a mesh nothing is
    laid out and the steps take the whole batch."""

    def __init__(self, model: nn.Module,
                 optimizer: Optional[torch.optim.Optimizer] = None, *,
                 rules=None, mesh=None):
        from tpu_on_k8s_torch.models.vision import (
            sync_batch_stats,
            vision_partition_rules,
        )
        self.model = model
        self.mesh = mesh
        self.optimizer = optimizer or SGD(model.parameters(), 0.1,
                                          momentum=0.9)
        if mesh is None:
            if rules is not None:
                raise ValueError("rules without a mesh lay nothing out")
            self.rules = None
            return
        self.rules = tuple(vision_partition_rules() if rules is None
                           else rules)
        shard_model(model, mesh, self.rules)
        self.optimizer.rebind(model.parameters())
        self.optimizer.mesh = mesh
        sizes = mesh_shape(mesh)
        sync_batch_stats(model, [mesh.get_group(axis)
                                 for axis in (AXIS_DATA, AXIS_FSDP)
                                 if sizes[axis] > 1])

    # ------------------------------------------------------------------ init
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> ClassifierState:
        """The ``ClassifierState`` at step 0. With ``generator`` the
        parameters and buffers are drawn first, as the reference's
        ``model.init`` makes them (``models/vision.py``'s
        ``init_variables``; every rank draws the same full tensors and keeps
        its blocks); without one the model keeps the values it holds."""
        if generator is not None:
            from tpu_on_k8s_torch.models.vision import init_variables
            if self.optimizer.count or self.optimizer.state:
                raise ValueError("the optimizer has stepped: build a fresh "
                                 "trainer to initialise again")
            with torch.no_grad():
                values = init_variables(self.model, generator)
                for name, t in self.model.state_dict().items():
                    _copy_into(t, values[name].to(_local_device(t)))
        return ClassifierState(self.model, self.optimizer)

    # ------------------------------------------------------------------ step
    def _dp_sum(self, t: torch.Tensor) -> torch.Tensor:
        # over the batch axes alone: every rank of a seq axis holds the
        # same rows
        return (t if self.mesh is None
                else _dp_sum(t, self.mesh, (AXIS_DATA, AXIS_FSDP)))

    def _sums(self, images, labels, train: bool):
        """(summed loss, correct count, global count) of this rank's rows."""
        logits = self.model(images, train=train)
        correct = (logits.argmax(-1) == labels).sum().float()
        count = self._dp_sum(torch.full((), float(labels.shape[0]),
                                        device=logits.device))
        return _nll(logits, labels).sum(), correct, count

    def _step(self, images: torch.Tensor, labels: torch.Tensor
              ) -> Dict[str, object]:
        count = self.optimizer.count
        part, correct, n = self._sums(images, labels, True)
        (part / n).backward()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        return {"loss": self._dp_sum(part.detach()) / n,
                "accuracy": self._dp_sum(correct) / n, "step": count}

    @torch.no_grad()
    def _eval(self, images: torch.Tensor, labels: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
        try:
            part, correct, n = self._sums(images, labels, False)
        finally:
            if self.mesh is not None:
                # no backward frees FSDP2's gathered root parameters
                self.model.reshard()
        return {"loss": self._dp_sum(part) / n,
                "accuracy": self._dp_sum(correct) / n}

    # ------------------------------------------------------------------- API
    def shard_batch(self, *arrays: torch.Tensor):
        """This rank's rows of each array every rank holds in full: the
        batch over (data, fsdp) (``data_sharding``). Off a mesh, the arrays
        themselves."""
        out = tuple(a if self.mesh is None
                    else local_rows(a, data_sharding(self.mesh))
                    for a in arrays)
        return out if len(out) > 1 else out[0]

    def data_shard(self):
        """(shard id, shard count) of this rank's ``DataLoader``."""
        return (0, 1) if self.mesh is None else data_shard(self.mesh)

    def _check(self, state: ClassifierState) -> None:
        if state.model is not self.model or (
                state.optimizer is not self.optimizer):
            raise ValueError("the ClassifierState is not this trainer's "
                             "model and optimizer")

    def train_step(self, state: ClassifierState, images: torch.Tensor,
                   labels: torch.Tensor):
        """→ ``(state, {"loss", "accuracy", "step"})``: the global batch's
        mean loss and accuracy as 0-d device tensors (no host sync), the
        step before this one; ``state.step`` advanced."""
        self._check(state)
        metrics = self._step(images, labels)
        state.step += 1
        return state, metrics

    def eval_step(self, state: ClassifierState, images: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The running statistics' loss and accuracy; nothing changes."""
        self._check(state)
        return self._eval(images, labels)

    def fit(self, state: ClassifierState, batches, steps: int,
            **loop_kwargs):
        """Drive the step through ``TrainLoop`` (``train/loop.py``):
        ``batches`` yields device-ready ``(images, labels)`` tuples (e.g.
        ``device_prefetch`` over the loader with a split transform); the
        metrics stay on the device between ``log_every`` windows, as in
        the LM loop. Returns a ``LoopResult``."""
        from tpu_on_k8s_torch.train.loop import TrainLoop

        self._check(state)
        return TrainLoop(lambda s, batch: self.train_step(s, *batch), state,
                         batches, **loop_kwargs).run(steps)


def _local_device(t: torch.Tensor) -> torch.device:
    return t.to_local().device if hasattr(t, "to_local") else t.device
