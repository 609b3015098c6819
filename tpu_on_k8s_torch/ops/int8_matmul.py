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
  — on a CUDA tensor ``torch._int_mm`` with the epilogue in PyTorch (a
  shape ``_int_mm`` refuses raises).
- ``int8_matmul_pallas`` (``int8_impl="pallas"``): on a CUDA tensor the
  product and its epilogue run in one hand-written kernel,
  ``csrc/int8_matmul.cu`` (the counterpart of ``_mm_kernel``): the int32
  accumulator never reaches device memory. The kernel masks ragged M, N and
  K itself, so it takes every shape; there is no fallback. ``bm``/``bn``/
  ``bk`` are TPU tiling knobs: accepted, no effect.

On CPU tensors both run ``int8_matmul_plain``, whose int32 product is exact
(an fp64 product of int8 values: every partial sum is an integer below
2⁵³). Both routes give the same bits as the plain version. Quantizing the
operands (``_quant_rows``) is plain PyTorch on every device, as the
reference leaves it to XLA outside its kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

#: Launches of ``csrc/int8_matmul.cu`` since the count was last set to 0.
launches = 0

#: The largest K whose int32 sum cannot overflow: |acc| <= 127² · K < 2³¹.
MAX_K = (2 ** 31 - 1) // (127 * 127)

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K] → (int8 values [..., K], fp32 scales [..., 1]): one scale per
    row, the last dim reduced. The reference's ``_quant_rows``; for the
    port's ``[N, K]`` weight it is also ``_quant_cols`` (one scale per
    output channel)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1, keepdim=True), min=1e-30) / 127.0
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
    then the epilogue in PyTorch (two passes over device memory)."""
    acc = torch._int_mm(xq, wq.t())
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


def _forward(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
             impl: str) -> torch.Tensor:
    if w.dim() != 2 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x [..., K] and w [N, K] expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    lead, n = x.shape[:-1], w.shape[0]
    xq, sx = _quant_rows(x.reshape(-1, x.shape[-1]))
    wq, sw = _quant_rows(w)
    if x.device.type == "cpu":
        y = int8_matmul_plain(xq, sx, wq, sw, out_dtype)
    elif x.device.type != "cuda":
        raise ValueError(f"int8 matmul runs on cuda or cpu, not "
                         f"{x.device.type}")
    elif impl == "pallas":
        y = int8_matmul_kernel(xq, sx, wq, sw, out_dtype)
    else:
        y = _int_mm(xq, sx, wq, sw, out_dtype)
    return y.reshape(*lead, n)


class _Int8Matmul(torch.autograd.Function):
    """Int8 forward; the backward from the saved unquantized x and w."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, impl):
        ctx.save_for_backward(x, w)
        return _forward(x, w, out_dtype or x.dtype, impl)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            ct = torch.promote_types(g.dtype, w.dtype)
            dx = torch.matmul(g.to(ct), w.to(ct)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            ct = torch.promote_types(x.dtype, g.dtype)
            g2 = g.reshape(-1, g.shape[-1]).to(ct)
            dw = torch.matmul(g2.t(), x.reshape(-1, x.shape[-1]).to(ct)
                              ).to(w.dtype)
        return dx, dw, None, None


def int8_matmul(x: torch.Tensor, w: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ wᵀ`` with an int8 forward and the exact backward: x ``[..., K]``,
    w ``[N, K]`` → ``[..., N]`` in ``out_dtype`` (default x's dtype; fp32 for
    the lm head's logits). The ``int8_impl="xla"`` route."""
    return _Int8Matmul.apply(x, w, out_dtype, "xla")


def int8_matmul_pallas(x: torch.Tensor, w: torch.Tensor,
                       out_dtype: Optional[torch.dtype] = None,
                       bm: int = 512, bn: int = 1024,
                       bk: int = 512) -> torch.Tensor:
    """``int8_matmul`` whose product and epilogue are one hand-written
    kernel on the card (``int8_impl="pallas"``). ``bm``/``bn``/``bk`` are
    the TPU kernel's tiles and have no effect."""
    del bm, bn, bk
    return _Int8Matmul.apply(x, w, out_dtype, "pallas")
