"""Row-wise int8 quantization with stochastic rounding, and its inverse:
hand-written Hopper kernels and their plain twins.

Counterpart of ``tpu_on_k8s/ops/quantization.py``. ``quantize_int8`` maps
``[R, C]`` floats to int8 values and one fp32 scale a row (absmax, floored
at 1e-30, times fp32(1/127)), rounding each ``x / scale`` down or up at random with the
probability of its fraction, so the rounding is unbiased;
``dequantize_int8`` is ``values · scale`` cast to a float dtype.
``quantize_pytree`` / ``dequantize_pytree`` do it for every matrix of a flat
dict of tensors (a state dict), keeping vectors and non-float tensors raw.

The random bits are the port's own: Philox4x32-10 keyed by ``seed``, one
word per element from the counter of its flat index (``_philox_bits``). The
reference's come from the TPU's generator, reseeded alike at every 256-row
block, so its bits cannot be matched; its rounding rule is kept exactly
(``bits >> 8`` to 24 bits, ``u = bits24 · 2⁻²⁴``, ``floor(s) + (u < s −
floor(s))``, clip ±127).

On a CUDA tensor each wrapper launches its kernel (``csrc/quantization.cu``)
or raises; on a CPU tensor it runs the plain twin
(``quantize_int8_plain``, ``dequantize_int8_plain``), which computes the same
bits. The reference's ``block_rows`` is a TPU tiling knob: accepted, no
effect.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, Tuple

import torch

from tpu_on_k8s_torch.device import refuse_dtensor

#: Launches of the quantize and dequantize kernels since each count was last
#: set to 0.
quant_launches = 0
dequant_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Philox4x32-10's multipliers and Weyl key increments.
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of the 64-bit product of the 32-bit
    constant ``a`` and the int64 tensor ``b`` of 32-bit values, without
    overflowing int64: ``a`` is split into 16-bit halves."""
    p_lo, p_hi = b * (a & 0xFFFF), b * (a >> 16)     # each below 2⁴⁸
    t = (p_lo >> 16) + p_hi              # a·b = (p_lo mod 2¹⁶) + t·2¹⁶
    return t >> 16, (p_lo & 0xFFFF) | ((t & 0xFFFF) << 16)


def _philox_bits(n: int, seed: int, device) -> torch.Tensor:
    """The kernel's random words for flat indices ``0..n-1`` as int64 in
    [0, 2³²): element f takes word ``f % 4`` of Philox4x32-10 at counter
    ``(f // 4 low, f // 4 high, 0, 0)``, key ``(seed low, seed high)``."""
    group = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    c0, c1 = group & _MASK32, group >> 32
    c2 = c3 = torch.zeros_like(group)
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return torch.stack((c0, c1, c2, c3), dim=1).reshape(-1)[:n]


#: fp32(1 / 127). The reference's row scale, as XLA evaluates it, is the
#: floored absmax times this reciprocal (its rewrite of a division by a
#: constant), one ulp off ``absmax / 127`` for ~4% of rows; the kernel and
#: the plain twin both multiply, so the scales match the reference's bits.
_INV127 = torch.tensor(127.0).reciprocal().item()


def _row_scales(x32: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x32.abs().amax(dim=-1, keepdim=True),
                       min=1e-30) * _INV127


def quantize_int8_plain(x: torch.Tensor, seed: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantize kernel's function in plain PyTorch, bit for bit: x
    ``[R, C]`` → (int8 ``[R, C]``, fp32 scales ``[R, 1]``)."""
    x32 = x.float()
    scale = _row_scales(x32)
    scaled = x32 / scale
    bits = _philox_bits(x.numel(), seed, x.device).view(x.shape)
    u = (bits >> 8).float() * (1.0 / (1 << 24))
    lo = torch.floor(scaled)
    rounded = lo + (u < scaled - lo).float()
    return torch.clamp(rounded, -127.0, 127.0).to(torch.int8), scale


def dequantize_int8_plain(values: torch.Tensor, scales: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The dequantize kernel's function in plain PyTorch."""
    return (values.float() * scales.reshape(-1, 1)).to(dtype)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/quantization.cu``, built on first use, with its C
    signatures."""
    from tpu_on_k8s_torch.ops import _build

    lib = _build.load("quantization")
    lib.quantize_int8.restype = _INT
    lib.quantize_int8.argtypes = [_PTR, _INT, _PTR, _PTR, _LL, _LL,
                                  ctypes.c_ulonglong, _PTR]
    lib.dequantize_int8.restype = _INT
    lib.dequantize_int8.argtypes = [_PTR, _PTR, _PTR, _INT, _LL, _LL, _PTR]
    lib.quantization_error_string.restype = ctypes.c_char_p
    lib.quantization_error_string.argtypes = [_INT]
    return lib


def _device_of(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"quantization runs on cuda or cpu, not "
                         f"{t.device.type}")
    return t.device.type


def _raise_on(err: int, name: str, lib) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.quantization_error_string(err).decode()}")


def quantize_int8(x: torch.Tensor, seed: int = 0, block_rows: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[R, C] float → (int8 values [R, C], fp32 scales [R, 1]), row-wise,
    stochastic rounding keyed by ``seed``."""
    global quant_launches
    del block_rows
    refuse_dtensor("quantize_int8", x)
    if x.dim() != 2 or not x.is_floating_point():
        raise ValueError(f"quantize_int8 takes a 2-D float tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if _device_of(x) == "cpu":
        return quantize_int8_plain(x, seed)
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"the quantize kernel reads float32, bfloat16 or "
                         f"float16, not {x.dtype}")
    r, c = x.shape
    x = x.contiguous()
    values = torch.empty((r, c), dtype=torch.int8, device=x.device)
    scales = torch.empty((r, 1), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantize_int8(x.data_ptr(), _DTYPE_CODE[x.dtype],
                                values.data_ptr(), scales.data_ptr(), r, c,
                                seed & 0xFFFFFFFFFFFFFFFF, stream)
    _raise_on(err, "quantize_int8", lib)
    quant_launches += 1
    return values, scales


def dequantize_int8(values: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.float32,
                    block_rows: int = 256) -> torch.Tensor:
    """Inverse of ``quantize_int8``: ``values · scales`` in ``dtype``."""
    global dequant_launches
    del block_rows
    refuse_dtensor("dequantize_int8", values, scales)
    if values.dim() != 2 or values.dtype != torch.int8:
        raise ValueError(f"dequantize_int8 takes 2-D int8 values, got "
                         f"{tuple(values.shape)} {values.dtype}")
    if scales.numel() != values.shape[0] or scales.dtype != torch.float32:
        raise ValueError("dequantize_int8 takes one fp32 scale per row")
    if scales.device != values.device:
        raise ValueError("values and scales must be on one device")
    if _device_of(values) == "cpu":
        return dequantize_int8_plain(values, scales, dtype)
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"the dequantize kernel writes float32, bfloat16 or "
                         f"float16, not {dtype}")
    r, c = values.shape
    values, scales = values.contiguous(), scales.contiguous()
    out = torch.empty((r, c), dtype=dtype, device=values.device)
    lib = _library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.dequantize_int8(values.data_ptr(), scales.data_ptr(),
                                  out.data_ptr(), _DTYPE_CODE[dtype], r, c,
                                  stream)
    _raise_on(err, "dequantize_int8", lib)
    dequant_launches += 1
    return out


def quantize_pytree(tree: Mapping[str, torch.Tensor], seed: int = 0
                    ) -> Dict[str, tuple]:
    """Row-quantize every float tensor of ≥ 2 dims in a flat dict (each
    flattened to rows of its last dim); vectors, scalars and non-float
    tensors stay raw. Returns name → ``("raw", tensor)`` or ``("q8",
    (values, scales, shape, dtype))``, undone by ``dequantize_pytree``."""
    out = {}
    for name, t in tree.items():
        if t.dim() < 2 or not t.is_floating_point():
            out[name] = ("raw", t)
            continue
        values, scales = quantize_int8(t.reshape(-1, t.shape[-1]), seed=seed)
        out[name] = ("q8", (values, scales, tuple(t.shape), t.dtype))
    return out


def dequantize_pytree(tree: Mapping[str, tuple]) -> Dict[str, torch.Tensor]:
    """Inverse of ``quantize_pytree``."""
    out = {}
    for name, (kind, payload) in tree.items():
        if kind == "raw":
            out[name] = payload
        else:
            values, scales, shape, dtype = payload
            out[name] = dequantize_int8(values, scales, dtype).reshape(shape)
    return out
