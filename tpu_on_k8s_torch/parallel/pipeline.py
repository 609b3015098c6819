"""Pipeline parallelism: a GPipe pipeline over a ``stage`` mesh axis. The
counterpart of ``tpu_on_k8s/parallel/pipeline.py``.

Layer parameters stacked on a leading ``layers`` dim (one tensor per leaf,
the reference's scan-stacked layout) are split over ``stage``: stage i runs
layers ``[i·n/S, (i+1)·n/S)``, and the ranks of a stage (its ``fsdp``
coordinates) replicate them, as the reference's ``P(stage)`` does. Every
rank holds the whole stacked tree and the whole input, as the reference's
global arrays; each keeps its stage's slice.

The schedule is the reference's: the batch is cut into M microbatches and
the pipeline runs M + S − 1 ticks. At tick t stage 0 feeds microbatch t
and stage i runs microbatch t − i, whose activations stage i − 1 sent it
(a P2P send to the next stage); the last stage banks microbatch
t − (S − 1). A stage skips the ticks where it holds no microbatch (the
bubble), which the reference computes on zeros and discards. The banked
outputs are replicated to every stage by a sum over ``stage`` (the other
stages add zeros).

The backward is the reverse schedule, written out (``_GPipe``): the
forward keeps each tick's autograd graph, and the backward walks the ticks
in reverse, each stage receiving its output's gradient from the next stage
(the last stage: the output's own cotangent, which every rank holds alike,
so the replicating sum passes it through once, not S times), running its
tick's graph backward and sending its input's gradient to the previous
stage. Each stage's parameter gradients and stage 0's input gradient are
then summed over ``stage`` into the whole gradient every rank holds, as
the reference's ``jax.grad`` of the replicated output gives it. Sends and
receives between two stages run in one order on both sides (increasing
microbatches forward, decreasing backward), so they pair by order alone.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_flatten, tree_unflatten

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.parallel.mesh import AXIS_FSDP, MeshAxis, axis_size

AXIS_STAGE = "stage"


def stage_mesh(n_stages: int, per_stage: int = 1,
               ranks: Optional[Sequence[int]] = None,
               device: str | torch.device = "cuda") -> DeviceMesh:
    """A ``(stage, fsdp)`` mesh of ``n_stages`` × ``per_stage`` ranks
    (default: the first ones of the ``torch.distributed`` world, which
    every rank of the world builds together)."""
    if not dist.is_initialized():
        raise RuntimeError("stage_mesh needs an initialised "
                           "torch.distributed world")
    n = n_stages * per_stage
    ranks = list(range(n)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) != n:
        raise ValueError(f"{n_stages} stages x {per_stage} need {n} ranks, "
                         f"got {len(ranks)}")
    if n > dist.get_world_size():
        raise ValueError(f"{n_stages} stages x {per_stage} need {n} ranks; "
                         f"the world has {dist.get_world_size()}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(n_stages, per_stage)
    return DeviceMesh(resolve_device(device).type, grid,
                      mesh_dim_names=(AXIS_STAGE, AXIS_FSDP))


class _Stage(MeshAxis):
    """This rank's place on the ``stage`` axis (``MeshAxis``: ``rank`` is
    its stage) and what its run needs."""

    def __init__(self, mesh, axis_name: str, layer_fn, spec, n_micro: int,
                 n_layers: int) -> None:
        super().__init__(mesh, axis_name)
        self.layer_fn, self.spec, self.n_micro = layer_fn, spec, n_micro
        per = n_layers // self.size
        self.layers = slice(self.rank * per, (self.rank + 1) * per)

    @property
    def first(self) -> bool:
        return self.rank == 0

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1

    def neighbour(self, step: int) -> int:
        return self.ranks[self.rank + step]

    def apply(self, local: List[torch.Tensor], h: torch.Tensor
              ) -> torch.Tensor:
        """The stage's layers on ``h``, in order."""
        for i in range(local[0].shape[0]):
            h = self.layer_fn(tree_unflatten([leaf[i] for leaf in local],
                                             self.spec), h)
        return h


def _recv_like(t: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.irecv(buf, src, group=group).wait()
    return buf


class _GPipe(torch.autograd.Function):
    """(x, *stacked leaves) → the replicated output ``[M, Bm, ...]``; the
    backward runs the reverse schedule (module docstring)."""

    @staticmethod
    def forward(ctx, x, stage: _Stage, *leaves):
        micro = x.reshape((stage.n_micro, x.shape[0] // stage.n_micro)
                          + tuple(x.shape[1:]))
        want_x = ctx.needs_input_grad[0]
        graphs = any(ctx.needs_input_grad)
        local = [leaf.detach()[stage.layers].requires_grad_(need)
                 for leaf, need in zip(leaves, ctx.needs_input_grad[2:])]
        outputs = torch.zeros_like(micro)
        ticks, sends = [], []
        for t in range(stage.n_micro + stage.size - 1):
            m = t - stage.rank
            if not 0 <= m < stage.n_micro:
                continue                    # the bubble
            inp = (micro[m] if stage.first else
                   _recv_like(micro[0], stage.neighbour(-1), stage.group))
            inp = inp.detach().requires_grad_(
                graphs and (want_x or not stage.first))
            with torch.set_grad_enabled(graphs):
                out = stage.apply(local, inp)
            if stage.last:
                outputs[m] = out.detach()
            else:
                buf = out.detach().contiguous()
                sends.append((buf, dist.isend(buf, stage.neighbour(1),
                                              group=stage.group)))
            if graphs:
                ticks.append((m, inp, out))
        for _, work in sends:
            work.wait()
        dist.all_reduce(outputs, group=stage.group)
        ctx.stage, ctx.ticks, ctx.local = stage, ticks, local
        ctx.x_shape, ctx.leaf_shapes = x.shape, [leaf.shape for leaf in leaves]
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        stage, local = ctx.stage, ctx.local
        want_x = ctx.needs_input_grad[0]
        wanted = [leaf for leaf in local if leaf.requires_grad]
        sums: List[Optional[torch.Tensor]] = [None] * len(wanted)
        g_micro = torch.zeros_like(g_out) if want_x else None
        sends = []
        for m, inp, out in reversed(ctx.ticks):
            g = (g_out[m] if stage.last else
                 _recv_like(out, stage.neighbour(1), stage.group))
            takes_inp = not stage.first or want_x
            grads = torch.autograd.grad(
                out, ([inp] if takes_inp else []) + wanted, g,
                allow_unused=True)
            if takes_inp:
                g_inp, grads = grads[0], grads[1:]
                if stage.first:
                    g_micro[m] = g_inp
                else:
                    buf = g_inp.contiguous()
                    sends.append((buf, dist.isend(buf, stage.neighbour(-1),
                                                  group=stage.group)))
            for i, gi in enumerate(grads):
                if gi is not None:
                    sums[i] = gi if sums[i] is None else sums[i] + gi
        for _, work in sends:
            work.wait()
        ctx.ticks = None
        # each stage's block of the whole gradient, summed over the stages
        it = iter(sums)
        out_grads = []
        for leaf, shape in zip(local, ctx.leaf_shapes):
            if not leaf.requires_grad:
                out_grads.append(None)
                continue
            full = leaf.new_zeros(shape)
            block = next(it)
            if block is not None:
                full[stage.layers] = block
            dist.all_reduce(full, group=stage.group)
            out_grads.append(full)
        g_x = None
        if want_x:
            dist.all_reduce(g_micro, group=stage.group)
            g_x = g_micro.reshape(ctx.x_shape)
        return (g_x, None, *out_grads)


def gpipe(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor],
          stacked_params: Any, x: torch.Tensor, *, mesh, n_micro: int,
          axis_name: str = AXIS_STAGE) -> torch.Tensor:
    """Run ``x`` through every stacked layer, pipelined over
    ``axis_name``: the reference's ``gpipe``. ``layer_fn(one_layer,
    h) -> h`` applies one layer (``one_layer``: ``stacked_params`` with
    each leaf indexed at the layer; ``h`` keeps its shape and dtype);
    every leaf of ``stacked_params`` has the layer count as its leading
    dim, divisible by the stage count; ``x`` is ``[B, ...]`` with B
    divisible by ``n_micro``. Differentiable in ``x`` and the leaves;
    every rank of the mesh gets the whole output and the whole
    gradients."""
    s = axis_size(mesh, axis_name)
    leaves, spec = tree_flatten(stacked_params)
    n_layers = leaves[0].shape[0]
    if n_layers % s:
        raise ValueError(f"{n_layers} layers not divisible by {s} stages")
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} "
                         f"microbatches")
    stage = _Stage(mesh, axis_name, layer_fn, spec, n_micro, n_layers)
    out = _GPipe.apply(x, stage, *leaves)
    return out.reshape(x.shape[:1] + out.shape[2:])
