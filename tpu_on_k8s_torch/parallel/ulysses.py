"""Ulysses sequence parallelism: an all-to-all from sequence to heads. The
counterpart of ``tpu_on_k8s/parallel/ulysses.py``.

The other classic long-context layout beside the ring (``ring.py``): each
rank of a ``seq`` group of n holds a chunk of the sequence of q, k and v;
an all-to-all swaps the split from the sequence to the heads, every rank
runs the flash kernels over the whole sequence on its h/n heads, and a
second all-to-all swaps back. Two collectives a layer in place of n ring
steps. Both all-to-alls are differentiable: each one's backward is the
other (``_SeqToHeads``). ``all_to_all_single`` splits dim 0, so the heads
or the sequence chunks are moved to dim 0 and made contiguous before each
call.

The heads are the rank's own after tensor parallelism: on a ``model`` axis
a rank runs H/model query heads (or every head, where ``model`` does not
divide them: ``parallel/sharded.py::own_heads``), and that local count
must divide by n. The reference checks its per-device count the same way
(``ulysses.py:47-58``), and the message names it.

``ulysses_attention`` has the reference's layout (``[B, L, H, D]``, kv
pre-repeated) and semantics on whole tensors, as ``ring.ring_attention``:
every rank holds the whole q/k/v and gets the whole output.
``ulysses_attention_shard`` takes and returns the rank's own chunk: the
model's call (``attn_impl="ulysses"``). With no mesh or an axis of one
both return the plain attention, the reference's semantics. Where the
reference keeps plain attention for lengths no Pallas block divides
(``ulysses.py:76-83``), the port's kernels run any length, so every
length runs the flash kernels.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from tpu_on_k8s_torch.ops.flash_attention import flash_attention
from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_MODEL,
    AXIS_SEQ,
    MeshAxis,
    axis_size,
)
from tpu_on_k8s_torch.parallel.ring import (
    own_chunk,
    plain_attention,
    resolve_mesh,
    whole,
)


def seq_to_heads(x: torch.Tensor, seq: MeshAxis) -> torch.Tensor:
    """``[B, Lc, h, D]`` (this rank's chunk, every head) → ``[B, L, h/n, D]``
    (the whole sequence, this rank's head group), with no gradient."""
    b, lc, h, d = x.shape
    n = seq.size
    parts = x.reshape(b, lc, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    got = torch.empty_like(parts)
    dist.all_to_all_single(got, parts, group=seq.group)
    # got[i]: rank i's chunk of this rank's heads
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * lc, h // n, d)


def heads_to_seq(x: torch.Tensor, seq: MeshAxis) -> torch.Tensor:
    """``seq_to_heads`` undone: ``[B, L, h/n, D]`` → ``[B, Lc, h, D]``."""
    b, l, hn, d = x.shape
    n = seq.size
    parts = x.reshape(b, n, l // n, hn, d).permute(1, 0, 2, 3, 4).contiguous()
    got = torch.empty_like(parts)
    dist.all_to_all_single(got, parts, group=seq.group)
    # got[i]: head group i of this rank's chunk
    return got.permute(1, 2, 0, 3, 4).reshape(b, l // n, n * hn, d)


class _SeqToHeads(torch.autograd.Function):
    """``seq_to_heads`` (``to_heads``) or ``heads_to_seq``; the backward is
    the other."""

    @staticmethod
    def forward(ctx, x, seq, to_heads):
        ctx.seq, ctx.to_heads = seq, to_heads
        return (seq_to_heads if to_heads else heads_to_seq)(x, seq)

    @staticmethod
    def backward(ctx, g):
        back = heads_to_seq if ctx.to_heads else seq_to_heads
        return back(g, ctx.seq), None, None


def ulysses_body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, to_heads, to_seq) -> torch.Tensor:
    """A rank's Ulysses attention: its chunks ``[B, Lc, h, D]`` to its head
    group over the whole sequence (``to_heads``), the flash kernels there,
    and back (``to_seq``). The two exchanges are the seam a check on one
    card fills without a collective."""
    out = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                          causal=causal)
    return to_seq(out)


def _check_heads(heads: int, n: int, axis_name: str, mesh,
                 n_heads: Optional[int]) -> None:
    if heads % n:
        raise ValueError(
            f"ulysses needs per-device head count {heads} (n_heads "
            f"{heads if n_heads is None else n_heads} over "
            f"model={axis_size(mesh, AXIS_MODEL)}) divisible by "
            f"{axis_name}={n}")


def ulysses_attention_shard(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            axis_name: str = AXIS_SEQ, mesh=None,
                            n_heads: Optional[int] = None) -> torch.Tensor:
    """Ulysses attention on this rank's chunk ``[B, Lc, h, D]`` of q/k/v
    (its own h heads, kv pre-repeated) → its chunk of the output.
    ``n_heads``, the model's whole head count, only names it in the
    error. Plain attention with no mesh or an axis of one."""
    resolved = resolve_mesh(mesh)
    n = axis_size(resolved, axis_name)
    if n == 1:
        return plain_attention(q, k, v, causal)
    _check_heads(q.shape[2], n, axis_name, resolved, n_heads)
    seq = MeshAxis(resolved, axis_name)
    return ulysses_body(q, k, v, causal,
                        lambda t: _SeqToHeads.apply(t, seq, True),
                        lambda t: _SeqToHeads.apply(t, seq, False))


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, axis_name: str = AXIS_SEQ,
                      mesh=None) -> torch.Tensor:
    """Exact attention with a sequence-to-heads all-to-all over
    ``axis_name``, on whole ``[B, L, H, D]`` q/k/v that every rank holds
    (kv pre-repeated), the reference's ``ulysses_attention``: every rank
    gets the whole output and the whole gradient. Needs L and the head
    count divisible by the axis. Plain attention with no mesh or an axis
    of one."""
    resolved = resolve_mesh(mesh)
    n = axis_size(resolved, axis_name)
    if n == 1:
        return plain_attention(q, k, v, causal)
    if q.shape[1] % n:
        raise ValueError(f"ulysses needs seq len {q.shape[1]} divisible by "
                         f"{axis_name}={n}")
    _check_heads(q.shape[2], n, axis_name, resolved, None)
    seq = MeshAxis(resolved, axis_name)
    out = ulysses_attention_shard(*(own_chunk(t, seq) for t in (q, k, v)),
                                  causal, axis_name, resolved)
    return whole(out, seq)
