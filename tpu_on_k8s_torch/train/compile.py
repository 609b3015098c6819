"""The exact FLOP count of a training step: the counterpart of
``tpu_on_k8s/train/compile.py``.

``train_step_flops`` counts one step's products with
``torch.utils.flop_counter.FlopCounterMode``: every dense and batched
matmul PyTorch runs, and the hand-written kernels, which run as operators
with FLOP formulas of their own (``ops/flash_attention.py``: the flash
forward, dq and dk/dv over the causal pairs; ``ops/int8_matmul.py``: the
int8 GEMM, and ``torch._int_mm``). The count includes what a remat policy
recomputes and the attention products that the 6·N·T estimate
(``analytic_train_flops``, kept for continuity) misses; the optimizer's
elementwise work counts nothing, as in the reference's cost analysis. It
is the MFU numerator the training loop's ``mfu`` gauge divides.

The reference's ``setup_compilation_cache``, ``apply_perf_env`` and
``perf_env`` point XLA at a persistent compile cache and set libtpu's
latency-hiding flags. An eager PyTorch step compiles nothing (the CUDA
kernels are built once per source by ``ops/_build.py``, keyed by a hash
of the sources), and no environment knob takes their place: the port
leaves ``os.environ`` as the user set it.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode


def train_step_flops(trainer: Any, state: Any, tokens: torch.Tensor
                     ) -> Tuple[float, Callable]:
    """(FLOPs of one training step on ``tokens``, the step function the
    training loop drives: ``trainer.train_step``). The step's forward and
    backward run once under the counter, on ``state``'s model, and their
    gradients are dropped: the state does not change."""
    trainer._check(state)
    if trainer.mesh is not None:
        raise NotImplementedError(
            "train_step_flops counts an unsharded step; on a mesh FSDP2's "
            "backward feeds its own gradient reduction")
    with FlopCounterMode(display=False) as counter:
        trainer._grads(tokens)
    return float(counter.get_total_flops()), trainer.train_step


def analytic_train_flops(n_params: int, tokens_per_step: int) -> float:
    """The classic 6·N·T estimate (2N forward + 4N backward per token),
    kept as the continuity number logged beside the exact count."""
    return 6.0 * float(n_params) * float(tokens_per_step)
