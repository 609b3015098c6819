"""Ring attention: exact attention with the sequence split over the mesh's
``seq`` axis. The counterpart of ``tpu_on_k8s/parallel/ring.py``.

Each rank of a ``seq`` group of n holds one chunk of Lc = L/n rows of q, k
and v (chunk i: rows ``[i·Lc, (i+1)·Lc)``, i the rank's place in the group,
``MeshAxis.rank``). Its q chunk stays; the K/V chunks travel round the
ring, one step at a time, by a P2P exchange (``rotate``). At each
step the flash kernel (``ops/flash_attention.py``) runs the resident q
against the chunk it holds, and the chunk results merge exactly by their
logsumexp, in fp32:

    s' = logaddexp(s, lse_i);  out' = e^{s - s'}·out + e^{lse_i - s'}·o_i

Under ``causal`` a chunk from a later rank (src > my) is skipped, the
diagonal chunk runs the causal kernel and an earlier chunk the non-causal
one: no masked-out product is computed. The skip is a host branch on
(my, src), the same on every recomputation (a full remat re-runs the ring
inside the backward pass).

The backward is written by hand (``_RingAttention``), the usual ring
backward: from the merged o and lse, with delta = Σ dO ⊙ o, each step runs
the dq and dk/dv kernels on the chunk it holds with the *merged* lse and
delta (so each chunk's probabilities are the whole row's), skipping the
chunks the forward skipped. dq sums in place; dK/dV accumulate in fp32
beside their chunk and travel with it, and arrive home after n rotations.
Each rank so keeps one chunk of saved state, which is why ring attention
exists. The reference differentiates its scan with JAX; the result is the
same function's gradient.

A body's exchanges go through a ``rotate`` seam: ``ring_forward`` and
``ring_backward`` are generators that yield what the rank sends at each
rotation and are sent what it receives. ``drive`` runs one with a rank's
``rotate`` (a P2P exchange over the ``seq`` group); ``ring_in_lockstep``
runs n of them on one device, each receiving what its predecessor sent,
which is how a check on one card drives the ring's bodies.

``ring_attention(q, k, v, causal, axis_name, mesh)`` has the reference's
layout, ``[B, L, H, D]`` with kv pre-repeated to H heads, and its
semantics on whole tensors: every rank holds the whole q/k/v (the
reference's global arrays) and gets the whole output; each rank runs its
own chunk and the output is gathered. ``ring_attention_shard`` takes and
returns the rank's own chunk: the model's call (``attn_impl="ring"``),
whose activations a ``Trainer`` already split over ``seq``. With no mesh,
or a ring of one, both return the plain attention
(``ops/flash_attention.py::xla_attention_bhld``): that is the reference's
own semantics (``ring.py:146-149``), not a fallback from a kernel. The
mesh is the argument, else the ambient ``ring_context``. The model's
attention is handed its mesh (``Attention.seq_mesh``, set by
``shard_model``), so a ``Trainer``'s steps read no context: a context
variable would not reach a full remat's recompute.

The reference needs a Pallas block that divides L/n (``auto_block``); the
port's kernels run any length, so no such limit is copied: L must only
divide by n.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Generator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tpu_on_k8s_torch.ops.flash_attention import (
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_with_lse_fwd,
    xla_attention_bhld,
)
from tpu_on_k8s_torch.parallel.mesh import AXIS_SEQ, MeshAxis, axis_size

_ring_mesh: contextvars.ContextVar = contextvars.ContextVar(
    "ring_mesh", default=None)


@contextlib.contextmanager
def ring_context(mesh):
    """Make ``mesh`` the ambient mesh of ``ring_attention`` and
    ``ulysses_attention`` calls that name none."""
    token = _ring_mesh.set(mesh)
    try:
        yield
    finally:
        _ring_mesh.reset(token)


def resolve_mesh(mesh=None):
    """``mesh``, else the ambient ``ring_context``'s (None: no mesh)."""
    return mesh if mesh is not None else _ring_mesh.get()


# ---- exchanges over the sequence axis -----------------------------------

def rotate(seq: MeshAxis, tensors: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    """Send ``tensors`` to the next rank of the ring ``seq`` and return
    what the previous one sent (same shapes and dtypes): one send and one
    receive of one packed buffer, in one ``batch_isend_irecv``, so no two
    messages between a pair can be matched the wrong way round."""
    flat = _pack(tensors)
    got = torch.empty_like(flat)
    nxt = seq.ranks[(seq.rank + 1) % seq.size]
    prev = seq.ranks[(seq.rank - 1) % seq.size]
    ops = [dist.P2POp(dist.isend, flat, nxt, seq.group),
           dist.P2POp(dist.irecv, got, prev, seq.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _unpack(got, tensors)


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The tensors' bytes, one after another, each from a 16-byte
    offset."""
    parts = []
    for t in tensors:
        raw = t.contiguous().view(-1).view(torch.uint8)
        parts.append(raw)
        if raw.numel() % 16:
            parts.append(raw.new_zeros(16 - raw.numel() % 16))
    return torch.cat(parts)


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, offset = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[offset:offset + n].view(t.dtype).view(t.shape))
        offset += -(-n // 16) * 16
    return out


class _Own(torch.autograd.Function):
    """This rank's chunk of a tensor every rank holds whole; the backward
    gathers every rank's chunk gradient into the whole gradient (each
    rank computed its own chunk's, of the same objective)."""

    @staticmethod
    def forward(ctx, x, seq, dim):
        ctx.seq, ctx.dim = seq, dim
        return seq.own(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.seq.all_gather(g, ctx.dim), None, None


class _Whole(torch.autograd.Function):
    """The whole tensor from every rank's chunk, held alike by every rank;
    the backward keeps this rank's rows of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, seq, dim):
        ctx.seq, ctx.dim = seq, dim
        return seq.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.seq.own(g, ctx.dim), None, None


def own_chunk(x: torch.Tensor, seq: MeshAxis, dim: int = 1) -> torch.Tensor:
    """``_Own``: this rank's chunk of a whole tensor, differentiable."""
    return _Own.apply(x, seq, dim)


def whole(x: torch.Tensor, seq: MeshAxis, dim: int = 1) -> torch.Tensor:
    """``_Whole``: the whole tensor from the ranks' chunks,
    differentiable."""
    return _Whole.apply(x, seq, dim)


# ---- the per-rank bodies -----------------------------------------------

Body = Generator[Sequence[torch.Tensor], Sequence[torch.Tensor], tuple]


def _runs(my: int, src: int, causal: bool) -> Tuple[bool, bool]:
    """(whether rank ``my`` runs the chunk from rank ``src``, and whether
    causal): a later chunk is skipped, the diagonal is causal."""
    if not causal:
        return True, False
    return src <= my, src == my


def ring_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 my: int, n: int, causal: bool) -> Body:
    """Rank ``my``'s forward over a ring of ``n``: q/k/v its chunks,
    heads-leading ``[B, H, Lc, D]``. Yields ``(k, v)`` at each of the
    n − 1 rotations and is sent the next chunk's; returns ``(o, lse)``,
    o ``[B, H, Lc, D]`` in q's dtype and lse ``[B, H, 1, Lc]`` fp32, the
    merged result over every chunk it ran. The first chunk (its own, which
    it always runs) starts the merge: the reference's merge from a zero
    ``out`` and ``s = -1e30`` gives it exactly."""
    out = s = None
    for idx in range(n):
        src = (my - idx) % n
        run, diag = _runs(my, src, causal)
        if run:
            o_i, lse_i = flash_with_lse_fwd(q, k, v, diag)
            if out is None:
                out, s = o_i.to(torch.float32, copy=True), lse_i
            else:
                s_new = torch.logaddexp(s, lse_i)
                out.mul_(torch.exp(s - s_new).transpose(-1, -2)).addcmul_(
                    o_i, torch.exp(lse_i - s_new).transpose(-1, -2))
                s = s_new
        if idx < n - 1:
            k, v = yield (k, v)
    return out.to(q.dtype), s


def ring_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                  my: int, n: int, causal: bool) -> Body:
    """Rank ``my``'s backward over a ring of ``n`` from its forward's o and
    merged lse and the cotangent ``do`` (all ``[B, H, Lc, D]``, lse
    ``[B, H, 1, Lc]``). Yields ``(k, v, dk, dv)`` at each rotation (the
    last only ``(dk, dv)``: n rotations bring each chunk's fp32 dK/dV
    accumulators home) and returns ``(dq, dk, dv)`` in the inputs'
    dtypes."""
    delta = (do.float() * o.float()).sum(-1)[:, :, None, :]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for idx in range(n):
        src = (my - idx) % n
        run, diag = _runs(my, src, causal)
        if run:
            dq += flash_bwd_dq(q, k, v, do, lse, delta, diag)
            dk_i, dv_i = flash_bwd_dkv(q, k, v, do, lse, delta, diag)
            dk += dk_i
            dv += dv_i
        if idx < n - 1:
            k, v, dk, dv = yield (k, v, dk, dv)
        else:
            dk, dv = yield (dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def drive(body: Body, rotate) -> tuple:
    """Run one rank's body, each of its rotations through ``rotate``
    (what it sends → what it receives); returns the body's result."""
    try:
        sent = next(body)
        while True:
            sent = body.send(rotate(sent))
    except StopIteration as done:
        return done.value


def ring_in_lockstep(bodies: Sequence[Body]) -> list:
    """Run a ring's n bodies on one device, rank r receiving at each
    rotation what rank r − 1 sent: the ring without a collective. Returns
    each rank's result, in order."""
    n = len(bodies)
    results: list = [None] * n
    live = list(bodies)
    sent: list = [None] * n
    for r, body in enumerate(live):
        try:
            sent[r] = next(body)
        except StopIteration as done:
            results[r], live[r] = done.value, None
    while any(b is not None for b in live):
        received = [sent[(r - 1) % n] for r in range(n)]
        for r, body in enumerate(live):
            if body is None:
                continue
            try:
                sent[r] = body.send(received[r])
            except StopIteration as done:
                results[r], live[r] = done.value, None
    return results


class _RingAttention(torch.autograd.Function):
    """The rank's chunk ``[B, Lc, H, D]`` of q/k/v → its chunk of the
    output, the forward and the hand-written backward of the whole ring
    (``ring_forward``, ``ring_backward``), each exchange a P2P rotation
    over ``seq``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, seq):
        qh = q.transpose(1, 2)
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
        o, lse = drive(ring_forward(qh, kh, vh, seq.rank, seq.size, causal),
                       functools.partial(rotate, seq))
        ctx.save_for_backward(qh, kh, vh, o, lse)
        ctx.causal, ctx.seq = causal, seq
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        qh, kh, vh, o, lse = ctx.saved_tensors
        seq = ctx.seq
        do = g.transpose(1, 2).contiguous()
        dq, dk, dv = drive(ring_backward(qh, kh, vh, o, lse, do, seq.rank,
                                         seq.size, ctx.causal),
                           functools.partial(rotate, seq))
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None)


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """The reference's ``xla_attention`` in the ``[B, L, H, D]`` layout:
    ``xla_attention_bhld`` on heads-leading views."""
    return xla_attention_bhld(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal).transpose(1, 2)


def ring_attention_shard(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, axis_name: str = AXIS_SEQ,
                         mesh=None) -> torch.Tensor:
    """Ring attention on this rank's chunk ``[B, Lc, H, D]`` of q/k/v
    (kv pre-repeated) → its chunk of the output. Plain attention with no
    mesh or a ring of one."""
    resolved = resolve_mesh(mesh)
    if axis_size(resolved, axis_name) == 1:
        return plain_attention(q, k, v, causal)
    return _RingAttention.apply(q, k, v, causal,
                                MeshAxis(resolved, axis_name))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, axis_name: str = AXIS_SEQ,
                   mesh=None) -> torch.Tensor:
    """Exact attention with the sequence split over ``axis_name``, on whole
    ``[B, L, H, D]`` q/k/v that every rank holds (kv pre-repeated), the
    reference's ``ring_attention``: each rank runs its chunk, and every
    rank gets the whole output (differentiable; every rank gets the whole
    gradient). Plain attention with no mesh or a ring of one; L must
    divide by the ring's size."""
    resolved = resolve_mesh(mesh)
    n = axis_size(resolved, axis_name)
    if n == 1:
        return plain_attention(q, k, v, causal)
    if q.shape[1] % n:
        raise ValueError(f"ring attention needs seq len {q.shape[1]} "
                         f"divisible by {axis_name}={n}")
    seq = MeshAxis(resolved, axis_name)
    out = _RingAttention.apply(*(own_chunk(t, seq) for t in (q, k, v)),
                               causal, seq)
    return whole(out, seq)
