"""Flash attention forward: a hand-written Hopper kernel and its plain twin.

Counterpart of ``tpu_on_k8s/ops/flash_attention.py`` (forward only; the two
backward kernels come with training). ``flash_with_lse_fwd`` is the
counterpart of ``_fwd``: q ``[B, H, L, D]``, k/v ``[B, Hkv, L, D]`` with GQA
by index (q-head h reads kv-head ``h // (H // Hkv)``, no repeated K/V) →
``(o [B, H, L, D], lse [B, H, 1, L] fp32)``. ``flash_attention`` keeps the
reference's public layout, ``[B, L, H, D]``.

On a CUDA tensor the wrapper launches ``csrc/flash_fwd.cu`` (bf16 or fp32,
head dim 64 or 128) or raises; it never falls back. On a CPU tensor it runs
``flash_attention_plain``, the same function in plain PyTorch. The TPU
kernel's ``block_q``/``block_k`` and pad-to-``padded_len`` are TPU tiling and
do not carry over: the kernel owns its tiles and masks ragged lengths itself.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e30  # large-but-finite: keeps exp(masked - m) an exact underflow

#: Kernel launches since the count was last set to 0 (a check on the card
#: sets it to 0 before a run and reads it after).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check(q, k, v, valid_len: int, segments) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes 4-D q, k, v [B, H, L, D]")
    b, h, l, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (l, d):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if h % k.shape[1]:
        raise ValueError(f"GQA head mismatch: {h} q heads not divisible by "
                         f"{k.shape[1]} kv heads")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must be on one device")
    if not 0 <= valid_len <= l:
        raise ValueError(f"valid_len {valid_len} outside [0, {l}]")
    if segments is not None and (tuple(segments.shape) != (b, l)
                                 or segments.device != q.device):
        raise ValueError(f"segments must be [B, L] = {(b, l)} on q's device")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, valid_len: int = 0,
                          segments: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in one pass over all keys
    (no tiles): fp32 scores ``scale * q.k`` masked to ``NEG_INF``, softmax
    statistics in fp32, probabilities cast to the input type before the V
    product. Same layouts and outputs as ``flash_with_lse_fwd``."""
    _check(q, k, v, valid_len, segments)
    b, h, l, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, h // hkv, l, d).float()
    kf = k.float()[:, :, None]                       # [B, Hkv, 1, L, D]
    s = (d ** -0.5) * torch.matmul(qg, kf.transpose(-1, -2))
    pos = torch.arange(l, device=q.device)
    keep = torch.ones(l, l, dtype=torch.bool, device=q.device)
    if causal:
        keep = keep & (pos[None, :] <= pos[:, None])
    if valid_len:
        keep = keep & (pos[None, :] < valid_len)
    keep = keep.expand(b, 1, 1, l, l)
    if segments is not None:
        keep = keep & (segments[:, None, None, :, None]
                       == segments[:, None, None, None, :])
    s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float()[:, :, None])
    o = (acc / denom).to(q.dtype).reshape(b, h, l, d)
    lse = (m + torch.log(denom)).reshape(b, h, 1, l)
    return o, lse


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/flash_fwd.cu``, built on first use, with its C signatures."""
    from tpu_on_k8s_torch.ops import _build

    lib = _build.load("flash_fwd")
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd.argtypes = [
        ctypes.c_int, ctypes.c_int,                        # dtype, head_dim
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # q, k, v
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # seg, o, lse
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B H Hkv L
        ctypes.c_int, ctypes.c_int, ctypes.c_float,  # causal, valid, scale
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]  # strides, stream
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    lib.flash_fwd_error_string.argtypes = [ctypes.c_int]
    return lib


def _launch(q, k, v, causal: bool, valid_len: int, segments
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    b, h, l, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernel takes bfloat16 or float32, got "
                         f"{q.dtype}")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dim {_HEAD_DIMS}, got {d}")
    if h > 65535 or b > 65535:
        raise ValueError(f"grid too large: batch {b}, heads {h}")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous head dim")
        if t.data_ptr() % 16 or any(s % align for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned")
    if segments is not None:
        segments = segments.to(torch.int32).contiguous()
    o = torch.empty_like(q)          # keeps q's strides: [B,L,H,D] in/out
    lse = torch.empty((b, h, 1, l), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            segments.data_ptr() if segments is not None else None,
            o.data_ptr(), lse.data_ptr(), b, h, k.shape[1], l, int(causal),
            valid_len, d ** -0.5, strides, stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: "
                           f"{lib.flash_fwd_error_string(err).decode()}")
    launches += 1
    return o, lse


def flash_with_lse_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, valid_len: int = 0,
                       segments: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward with the per-row logsumexp.

    q ``[B, H, L, D]``, k/v ``[B, Hkv, L, D]`` (any strides with a
    contiguous head dim) → ``(o, lse)``: o in q's dtype and layout, lse fp32
    ``[B, H, 1, L]``. ``valid_len`` > 0 masks keys at positions ≥ it;
    ``segments [B, L]`` keeps only same-segment pairs."""
    _check(q, k, v, valid_len, segments)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, valid_len, segments)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device.type}")
    return _launch(q, k, v, causal, valid_len, segments)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention in the reference's public layout: q ``[B, L, H, D]``,
    k/v ``[B, L, Hkv, D]`` with ``H % Hkv == 0`` → ``[B, L, H, D]``. Any
    sequence length; no padding is made."""
    o, _ = flash_with_lse_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal, 0, segments)
    return o.transpose(1, 2)
