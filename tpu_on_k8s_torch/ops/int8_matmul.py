"""Int8-forward matmul for training (the SwitchBack recipe): a hand-written
Hopper GEMM and its plain twin.

Counterpart of ``tpu_on_k8s/ops/int8_matmul.py``. The forward quantizes the
activation per row and the weight per output channel (absmax / 127, floored
at 1e-30, round half to even, clip to ±127), multiplies in int8 with an
exact int32 sum, and rescales ``acc · sx · sw`` in fp32 before one cast; the
backward computes ``dx = g·w`` and ``dw = gᵀ·x`` from the saved *unquantized*
x and w, in the promoted type of g and each, then casts to x's and w's
dtypes (the reference's ``_bwd``).

Layouts are the port's: ``w`` is the ``[out, in]`` weight of a ``Dense``
(``[N, K]``, the transpose of the reference's ``[K, N]`` kernel), so the
per-output-channel scales are row scales of ``w`` and the int8 weight is
K-contiguous, the B operand an int8 MMA reads. ``x`` is ``[..., K]``; the
result is ``[..., N]``.

- ``int8_matmul`` (``int8_impl="xla"``): the product of XLA's ``dot_general``
  — on a CUDA tensor ``torch._int_mm`` with the epilogue in PyTorch. The
  operands are zero-padded to the shapes ``_int_mm`` takes on the card
  (M > 16, K and N multiples of 8) and the product sliced back, so every
  shape runs, as ``dot_general`` takes every shape.
- ``int8_matmul_pallas`` (``int8_impl="pallas"``): on a CUDA tensor the
  product and its epilogue run in one hand-written kernel,
  ``csrc/int8_matmul.cu`` (the counterpart of ``_mm_kernel``): the int32
  accumulator never reaches device memory. The kernel masks ragged M, N and
  K itself, so it takes every shape; there is no fallback. ``bm``/``bn``/
  ``bk`` are TPU tiling knobs: accepted, no effect. The kernel runs behind
  the operator ``tpu_on_k8s_torch::int8_matmul`` (on CPU tensors, the plain
  twin), which remat policies and ``torch.utils.flop_counter`` see.

The gradient half (``_Int8Grad``: it saves the unquantized x and w) runs
before the product (``_Int8Product``), so a checkpoint's recompute that
needs only x and w stops before the quantization and the GEMM.

- ``int8_matmul_batched``: the MoE experts' products, ``x[e] @ w[e]`` for
  stacked ``[E, K, N]`` weights (the reference's layout), one expert after
  another through the same path and the same autograd pair, ``impl``
  choosing the route.

On CPU tensors both run ``int8_matmul_plain``, whose int32 product is exact
(an fp64 product of int8 values: every partial sum is an integer below
2⁵³). Both routes give the same bits as the plain version. Quantizing the
operands (``_quant_rows``) is plain PyTorch on every device, as the
reference leaves it to XLA outside its kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import (
    flop_registry,
    mm_flop,
    register_flop_formula,
)

from tpu_on_k8s_torch.device import refuse_dtensor

#: Launches of ``csrc/int8_matmul.cu`` since the count was last set to 0.
launches = 0

#: The largest K whose int32 sum cannot overflow: |acc| <= 127² · K < 2³¹.
MAX_K = (2 ** 31 - 1) // (127 * 127)

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: a collective over the ranks that hold the other blocks of K, in place
Reduce = Callable[[torch.Tensor], torch.Tensor]


@functools.lru_cache(maxsize=None)
def _one_twenty_seven(device: torch.device) -> torch.Tensor:
    return torch.full((), 127.0, device=device)


def div127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as a true division on every device, as the reference
    divides. A divisor that is a Python float (or any CPU scalar) takes
    CUDA's reciprocal route, ``t * fp32(1/127)``, one ulp off the quotient
    in ~4% of rows; a 0-dim divisor on ``t``'s own device divides."""
    return t / _one_twenty_seven(t.device)


def _quant_rows(x: torch.Tensor, reduce_max: Optional[Reduce] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K] → (int8 values [..., K], fp32 scales [..., 1]): one scale per
    row, the last dim reduced. The reference's ``_quant_rows``; for the
    port's ``[N, K]`` weight it is also ``_quant_cols`` (one scale per
    output channel). ``reduce_max`` takes each row's absmax to the max over
    the blocks of K that other ranks hold (a row-parallel product): the
    values and scales are then the whole row's, bit for bit."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    if reduce_max is not None:
        absmax = reduce_max(absmax)
    scale = div127(torch.clamp(absmax, min=1e-30))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                      sw: torch.Tensor, out_dtype: torch.dtype
                      ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: xq ``[M, K]`` int8, sx
    ``[M, 1]`` fp32, wq ``[N, K]`` int8, sw ``[N, 1]`` fp32 →
    ``((acc · sx) · sw)`` ``[M, N]`` in ``out_dtype``, acc the exact int32
    sum (computed in fp64, where it is exact)."""
    acc = torch.matmul(xq.double(), wq.double().t()).to(torch.int32)
    return (acc.float() * sx.reshape(-1, 1) * sw.reshape(1, -1)).to(out_dtype)


def _int_mm(xq, sx, wq, sw, out_dtype) -> torch.Tensor:
    """``int8_impl="xla"`` on the card: ``torch._int_mm``'s int32 product,
    then the epilogue in PyTorch (two passes over device memory).

    ``_int_mm`` on the card takes M > 16 and K, N multiples of 8 only, so xq
    is zero-padded to at least 17 rows and both operands to K and N
    multiples of 8; zeros add nothing to an int32 sum, and the product is
    sliced back to [M, N] before the epilogue: the bits are unchanged."""
    m, k = xq.shape
    n = wq.shape[0]
    kp = -(-k // 8) * 8
    if m < 17 or kp != k:
        xq = F.pad(xq, (0, kp - k, 0, max(17 - m, 0)))
    if n % 8 or kp != k:
        wq = F.pad(wq, (0, kp - k, 0, -n % 8))
    acc = torch._int_mm(xq, wq.t())[:m, :n]
    return (acc.float() * sx.reshape(-1, 1) * sw.reshape(1, -1)).to(out_dtype)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/int8_matmul.cu``, built on first use, with its C signature."""
    from tpu_on_k8s_torch.ops import _build

    lib = _build.load("int8_matmul")
    lib.int8_matmul.restype = _INT
    lib.int8_matmul.argtypes = [_PTR, _PTR, _PTR, _PTR, _PTR,  # xq sx wq sw out
                                _INT, _INT, _INT, _INT, _PTR]  # M N K out, stream
    lib.int8_matmul_error_string.restype = ctypes.c_char_p
    lib.int8_matmul_error_string.argtypes = [_INT]
    return lib


def int8_matmul_kernel(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                       sw: torch.Tensor, out_dtype: torch.dtype
                       ) -> torch.Tensor:
    """``int8_matmul_plain``'s function on the card: one launch of
    ``csrc/int8_matmul.cu``. Takes CUDA tensors only; raises on anything
    the kernel does not take."""
    global launches
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8 kernel takes xq [M, K] and wq [N, K], got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    m, k = xq.shape
    n = wq.shape[0]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8 kernel takes int8 operands, got {xq.dtype} "
                         f"and {wq.dtype}")
    if sx.numel() != m or sw.numel() != n or not (
            sx.dtype == sw.dtype == torch.float32):
        raise ValueError("int8 kernel takes fp32 scales, one per row of xq "
                         "and of wq")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"int8 kernel writes float32, bfloat16 or float16, "
                         f"not {out_dtype}")
    if k > MAX_K:
        raise ValueError(f"K = {k} > {MAX_K}: the int32 sum could overflow")
    if min(m, n, k) == 0 or m > 65535 * 128:
        raise ValueError(f"int8 kernel takes 0 < M <= {65535 * 128} and "
                         f"nonempty N, K; got M={m} N={n} K={k}")
    tensors = (xq, sx, wq, sw)
    if any(t.device.type != "cuda" or t.device != xq.device for t in tensors):
        raise ValueError("int8 kernel takes CUDA tensors on one device")
    xq, sx, wq, sw = (t.contiguous() for t in tensors)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    lib = _library()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream(xq.device).cuda_stream
        err = lib.int8_matmul(xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
                              sw.data_ptr(), out.data_ptr(), m, n, k,
                              _OUT_CODE[out_dtype], stream)
    if err:
        raise RuntimeError(f"int8_matmul launch failed: "
                           f"{lib.int8_matmul_error_string(err).decode()}")
    launches += 1
    return out


@torch.library.custom_op("tpu_on_k8s_torch::int8_matmul", mutates_args=())
def _kernel_op(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
               sw: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The ``int8_impl="pallas"`` product as an operator: one launch of
    ``int8_matmul_kernel`` on CUDA tensors, ``int8_matmul_plain`` on CPU
    tensors. The dispatcher sees the operator, so a selective checkpoint's
    policy can save or recompute its output and
    ``torch.utils.flop_counter`` counts it."""
    if xq.device.type == "cpu":
        return int8_matmul_plain(xq, sx, wq, sw, out_dtype)
    return int8_matmul_kernel(xq, sx, wq, sw, out_dtype)


@_kernel_op.register_fake
def _(xq, sx, wq, sw, out_dtype):
    return xq.new_empty((xq.shape[0], wq.shape[0]), dtype=out_dtype)


@register_flop_formula(torch.ops.tpu_on_k8s_torch.int8_matmul)
def _kernel_flops(xq_shape, sx_shape, wq_shape, *args, out_shape=None,
                  **kwargs) -> int:
    return 2 * xq_shape[0] * wq_shape[0] * xq_shape[1]


if torch.ops.aten._int_mm not in flop_registry:
    # the int8_impl="xla" route's product on the card: 2·M·N·K
    register_flop_formula(torch.ops.aten._int_mm, get_raw=True)(mm_flop)


def _forward(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
             impl: str, reduce_max: Optional[Reduce] = None,
             reduce_sum: Optional[Reduce] = None) -> torch.Tensor:
    """The product of x ``[..., K]`` and w ``[N, K]`` (or of each expert's
    x ``[E, ..., K]`` and w ``[E, N, K]``, one product after another),
    quantized (over the whole K with ``reduce_max``); with ``reduce_sum``
    (a row-parallel product: x and w hold one block of K) the fp32 partial
    products are summed over the ranks, then cast once."""
    batched = w.dim() == 3
    if w.dim() not in (2, 3) or x.shape[-1] != w.shape[-1] or (
            batched and x.shape[0] != w.shape[0]):
        raise ValueError(f"x [..., K] and w [N, K] (or x [E, ..., K] and w "
                         f"[E, N, K]) expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    lead, n = x.shape[:-1], w.shape[-2]
    xq, sx = _quant_rows(x.reshape(*w.shape[:-2], -1, x.shape[-1]),
                         reduce_max)
    wq, sw = _quant_rows(w, reduce_max)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8 matmul runs on cuda or cpu, not "
                         f"{x.device.type}")
    dtype = out_dtype if reduce_sum is None else torch.float32
    if impl == "pallas":
        product = _kernel_op
    elif x.device.type == "cpu":
        product = int8_matmul_plain
    else:
        product = _int_mm
    if batched:
        y = torch.stack([product(xq[i], sx[i], wq[i], sw[i], dtype)
                         for i in range(w.shape[0])])
    else:
        y = product(xq, sx, wq, sw, dtype)
    if reduce_sum is not None:
        y = reduce_sum(y).to(out_dtype)
    return y.reshape(*lead, n)


class _Int8Grad(torch.autograd.Function):
    """The gradient half of an int8 matmul: saves the unquantized x and w
    and returns a stand-in for the output (zeros of its shape, one element
    broadcast); its backward is the reference's ``_bwd`` (``_bwd_b`` for
    the experts' ``[E, N, K]`` weights, per expert), ``dx = g·w`` and
    ``dw = gᵀ·x`` in the promoted types. It runs, and saves, before the
    product does (``_Int8Product``), so a checkpoint's recompute that needs
    only x and w stops before the quantization and the GEMM, as the
    reference's XLA drops a product whose output the backward never reads
    (w_down's, under ``remat_policy="mlp"``)."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return x.new_zeros((), dtype=out_dtype).expand(*x.shape[:-1],
                                                       w.shape[-2])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        # rows of each product: all of x's, or each expert's
        lead = w.shape[:-2]
        g2 = g.reshape(*lead, -1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            ct = torch.promote_types(g.dtype, w.dtype)
            dx = torch.matmul(g2.to(ct), w.to(ct)).reshape(x.shape).to(
                x.dtype)
        if ctx.needs_input_grad[1]:
            ct = torch.promote_types(x.dtype, g.dtype)
            dw = torch.matmul(g2.to(ct).transpose(-1, -2),
                              x.reshape(*lead, -1, x.shape[-1]).to(ct)
                              ).to(w.dtype)
        return dx, dw, None


class _Int8Product(torch.autograd.Function):
    """The int8 forward of detached x and w; its output's gradient flows
    unchanged into ``_Int8Grad``'s stand-in."""

    @staticmethod
    def forward(ctx, stand_in, x, w, out_dtype, impl, reduce_max,
                reduce_sum):
        return _forward(x, w, out_dtype, impl, reduce_max, reduce_sum)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None, None, None


def _apply(x: torch.Tensor, w: torch.Tensor,
           out_dtype: Optional[torch.dtype], impl: str,
           reduce_max: Optional[Reduce], reduce_sum: Optional[Reduce]
           ) -> torch.Tensor:
    refuse_dtensor("int8_matmul", x, w)
    if (reduce_max is None) != (reduce_sum is None):
        raise ValueError("a row-parallel int8 product takes reduce_max and "
                         "reduce_sum together")
    out_dtype = out_dtype or x.dtype
    stand_in = _Int8Grad.apply(x, w, out_dtype)
    return _Int8Product.apply(stand_in, x.detach(), w.detach(), out_dtype,
                              impl, reduce_max, reduce_sum)


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None, *,
                reduce_max: Optional[Reduce] = None,
                reduce_sum: Optional[Reduce] = None) -> torch.Tensor:
    """``x @ wᵀ`` with an int8 forward and the exact backward: x ``[..., K]``,
    w ``[N, K]`` → ``[..., N]`` in ``out_dtype`` (default x's dtype; fp32 for
    the lm head's logits). The ``int8_impl="xla"`` route. A row-parallel
    caller, whose x and w hold one block of K, passes the collectives over
    the ranks that hold the others: ``reduce_max`` (in place, the max) for
    the absmax of x's rows and w's output channels, ``reduce_sum`` (in
    place, the sum) for the fp32 partial products; the backward stays the
    local blocks' (``_Int8Grad``)."""
    return _apply(x, w, out_dtype, "xla", reduce_max, reduce_sum)


def int8_matmul_pallas(x: torch.Tensor, w: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None,
                       bm: int = 512, bn: int = 1024,
                       bk: int = 512, *,
                       reduce_max: Optional[Reduce] = None,
                       reduce_sum: Optional[Reduce] = None) -> torch.Tensor:
    """``int8_matmul`` whose product and epilogue are one hand-written
    kernel on the card (``int8_impl="pallas"``). ``bm``/``bn``/``bk`` are
    the TPU kernel's tiles and have no effect."""
    del bm, bn, bk
    return _apply(x, w, out_dtype, "pallas", reduce_max, reduce_sum)


def int8_matmul_batched(x: torch.Tensor, w: torch.Tensor,
                        impl: str = "xla", *,
                        reduce_max: Optional[Reduce] = None,
                        reduce_sum: Optional[Reduce] = None) -> torch.Tensor:
    """Per-expert ``x[e] @ w[e]`` with an int8 forward and the exact
    backward: x ``[E, ..., K]`` (the dispatched expert inputs), w ``[E, K,
    N]`` (the stacked expert weights, the reference's layout) → ``[E, ...,
    N]`` in x's dtype. The reference's ``int8_matmul_batched``: x's rows
    quantized per row (``_quant_rows``), each expert's weight per output
    column (``_quant_rows`` of ``w[e]ᵀ``, the reference's ``_quant_cols``:
    K reduced), the exact int32 sum, ``(acc · sx) · sw`` cast to x's dtype.

    Each expert's product runs through the 2-D path: ``impl="pallas"``
    launches the hand-written kernel once per expert, ``"xla"`` takes
    ``torch._int_mm`` on the card. The reference runs XLA here whatever
    ``int8_impl`` says; both routes compute the same bits (the exact int32
    sum and the same epilogue), so ``impl`` chooses a speed, not a result.
    An expert's empty capacity rows are all zero: their absmax takes the
    1e-30 floor and their output is zero. A row-parallel caller (``w_down``
    with F split over ``model``) passes ``reduce_max`` and ``reduce_sum``
    as ``int8_matmul`` takes them: every expert is quantized over its whole
    K and its fp32 partial products are summed before one cast."""
    if w.dim() != 3:
        raise ValueError(f"w [E, K, N] expected, got {tuple(w.shape)}")
    return _apply(x, w.transpose(1, 2), x.dtype, impl, reduce_max,
                  reduce_sum)
