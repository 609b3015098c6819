"""The exact FLOP count of a training step: the counterpart of
``tpu_on_k8s/train/compile.py``.

``train_step_flops`` counts one step's products with
``torch.utils.flop_counter.FlopCounterMode``: every dense and batched
matmul PyTorch runs (an MoE block's router, dispatch, expert and combine
products among them, so ``mfu`` divides the work the dense dispatch
runs), and the hand-written kernels, which run as operators
with FLOP formulas of their own (``ops/flash_attention.py``: the flash
forward, dq and dk/dv over the causal pairs; ``ops/int8_matmul.py``: the
int8 GEMM, and ``torch._int_mm``). The count includes what a remat policy
recomputes and the attention products that the 6·N·T estimate
(``analytic_train_flops``, kept for continuity) misses; the optimizer's
elementwise work counts nothing, as in the reference's cost analysis. It
is the MFU numerator the training loop's ``mfu`` gauge divides. On a mesh
it is the rank's own count (``LocalFlopCounter``), the per-device count
the reference's compiled SPMD program reports.

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
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_map_only
from torch.utils.flop_counter import FlopCounterMode


class LocalFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` that counts each operator on the blocks this
    rank holds. The counter's dispatch mode meets an operator on
    ``DTensor``s before the ``DTensor`` dispatches it to the local one, so
    its shapes are the global tensor's: a tensor-parallel product would
    count whole on every rank. Here each ``DTensor`` argument counts as its
    local tensor, which is what the rank's local operator multiplies (the
    tensor-parallel products need no redistribution of their operands).
    Plain tensors count as they are: the flash and int8 kernels' operators
    and FSDP2's gathered parameters inside a block. Collectives have no
    FLOP formula and count nothing."""

    def _count_flops(self, func_packet, out, args, kwargs):
        args, kwargs, local = tree_map_only(
            DTensor, lambda t: t._local_tensor, (args, kwargs, out))
        super()._count_flops(func_packet, local, args, kwargs)
        return out


def train_step_flops(trainer: Any, state: Any, tokens: torch.Tensor
                     ) -> Tuple[float, Callable]:
    """(FLOPs of one training step on ``tokens``, the step function the
    training loop drives: ``trainer.train_step``). The step's forward and
    backward run once under the counter, on ``state``'s model, and their
    gradients are dropped: the state does not change.

    On a mesh every rank calls it (the step runs collectives), on its own
    rows (``trainer.shard_batch``), and it returns this rank's count: the
    products its own program runs on its own blocks
    (``LocalFlopCounter``), the reference's per-device count, which the
    loop's ``mfu`` divides by one card's peak. Work a layout runs whole on
    every rank (attention over heads ``model`` does not divide) counts on
    every rank, as XLA's per-device program counts it."""
    trainer._check(state)
    with LocalFlopCounter(display=False) as counter:
        trainer._grads(tokens)
    if trainer.mesh is not None:
        trainer.optimizer.zero_grad(set_to_none=True)
    return float(counter.get_total_flops()), trainer.train_step


def analytic_train_flops(n_params: int, tokens_per_step: int) -> float:
    """The classic 6·N·T estimate (2N forward + 4N backward per token),
    kept as the continuity number logged beside the exact count."""
    return 6.0 * float(n_params) * float(tokens_per_step)
