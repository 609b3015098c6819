"""Flash attention: hand-written Hopper kernels and their plain twins.

Counterpart of ``tpu_on_k8s/ops/flash_attention.py``. Layouts are the
reference's: q ``[B, H, L, D]``, k/v ``[B, Hkv, L, D]`` with GQA by index
(q-head h reads kv-head ``h // (H // Hkv)``, no repeated K/V), lse
``[B, H, 1, L]`` fp32.

- ``flash_with_lse_fwd`` is the counterpart of ``_fwd`` → ``(o, lse)``;
  its kernel is ``csrc/flash_fwd.cu``.
- ``flash_bwd`` is the counterpart of ``_bwd`` → ``(dq, dk, dv)``: delta =
  rowsum(dO ∘ O) in fp32, less the lse cotangent, in plain PyTorch as XLA
  computes it outside the TPU kernels, then the two kernels of
  ``csrc/flash_bwd.cu``, one for dq and one for dk/dv.
- ``flash_attention_bhld``, ``flash_with_lse`` and ``flash_attention`` (the
  reference's public ``[B, L, H, D]`` layout) are differentiable through
  ``_Flash``, a ``torch.autograd.Function`` that saves (q, k, v, o, lse) —
  the counterpart of the reference's custom VJPs ``_flash``, ``_flash_seg``
  and ``flash_with_lse``.
- ``xla_attention_bhld`` is the reference's ``attn_impl="xla"`` attention
  (``models/transformer.py``), plain PyTorch that autograd differentiates:
  the models' plain path and the ring's plain result.

Each kernel runs behind an operator (``torch.library.custom_op``:
``tpu_on_k8s_torch::flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``),
which is what the dispatcher, a selective checkpoint's policy (the remat
policies of ``models/transformer.py``) and ``torch.utils.flop_counter``
(with a FLOP formula for each) see of it. On a CUDA tensor each wrapper
launches its kernel (bf16 or fp32) or raises; it never falls back. The
kernels are built for head dims 64, 128 and 256; any other head dim up to
256 is zero-padded to the next of them before the launch and the outputs
sliced back (``with_kernel_head_dim``), with the scale of the true head
dim, as Mosaic pads the reference's head dim to its 128-lane tile. Zero
columns add nothing to q·k, to o, or to the gradients' sums, so the
padding is exact; a head dim above 256 raises. On a CPU
tensor it runs the plain twin (``flash_attention_plain``,
``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain``), the same function in
plain PyTorch. The TPU
kernels' ``block_q``/``block_k`` and pad-to-``padded_len`` are TPU tiling and
do not carry over: the kernels own their tiles and mask ragged lengths
themselves. A query row that no key is visible to (possible only with
``valid_len`` and segments together) has no defined output or gradient; the
kernels and twins may differ there, as the reference's padded rows do.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from tpu_on_k8s_torch.device import refuse_dtensor

NEG_INF = -1e30  # large-but-finite: keeps exp(masked - m) an exact underflow

#: Kernel launches since each count was last set to 0 (a check on the card
#: sets them to 0 before a run and reads them after): ``flash_fwd``, and the
#: two backward kernels ``flash_bwd_dq`` and ``flash_bwd_dkv``.
launches = 0
dq_launches = 0
dkv_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)


def kernel_head_dim(d: int) -> int:
    """The head dim the kernels run a head dim ``d`` at: 64, 128 or 256."""
    for width in _HEAD_DIMS:
        if d <= width:
            return width
    raise ValueError(f"flash kernel takes head dims up to {_HEAD_DIMS[-1]}, "
                     f"got {d}")


def with_kernel_head_dim(call, tensors, n_wide: int):
    """``call(*padded, scale=d ** -0.5)`` on ``tensors`` (q, k, v, and dO in
    the backward; head dim last) zero-padded from their head dim d to
    ``kernel_head_dim(d)``, with the first ``n_wide`` outputs sliced back
    to d. The scale is the true head dim's. Padding is exact: zero columns
    add nothing to q·k (so lse is unchanged) and come out of o, dq, dk and
    dv as zeros, which the slice drops."""
    d = tensors[0].shape[-1]
    width = kernel_head_dim(d)
    if width != d:
        tensors = [F.pad(t, (0, width - d)) for t in tensors]
    out = call(*tensors, scale=d ** -0.5)
    if width == d:
        return out
    if isinstance(out, torch.Tensor):
        return out[..., :d]
    return tuple(o[..., :d] if i < n_wide else o for i, o in enumerate(out))


def _check(q, k, v, valid_len: int, segments) -> None:
    refuse_dtensor("flash attention", q, k, v, segments)
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


def _keep_mask(b: int, l: int, causal: bool, valid_len: int, segments,
               device) -> torch.Tensor:
    """The kept (query, key) pairs, ``[B or 1, 1, 1, L, L]`` bool: the masks
    of the reference's ``_mask_scores``."""
    pos = torch.arange(l, device=device)
    keep = torch.ones(l, l, dtype=torch.bool, device=device)
    if causal:
        keep = keep & (pos[None, :] <= pos[:, None])
    if valid_len:
        keep = keep & (pos[None, :] < valid_len)
    keep = keep[None, None, None]
    if segments is not None:
        keep = keep & (segments[:, None, None, :, None]
                       == segments[:, None, None, None, :])
    return keep


def _acc(x: torch.Tensor) -> torch.Tensor:
    """x in the plain versions' accumulation type: fp32 for bf16 and fp32
    (the kernels' fp32 accumulators), fp64 for fp64 (a check's reference)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _grouped(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """``[B, H, ...]`` → ``[B, Hkv, rep, ...]``: the q-heads of a kv head."""
    return x.reshape(x.shape[0], hkv, x.shape[1] // hkv, *x.shape[2:])


def _scores(q, k, causal: bool, valid_len: int, segments,
            scale: Optional[float] = None) -> torch.Tensor:
    """fp32 scores ``scale * q.k`` masked to ``NEG_INF``,
    ``[B, Hkv, rep, L, L]`` (scale after the dot, as the kernels; default
    ``D ** -0.5``)."""
    b, _, l, d = q.shape
    if scale is None:
        scale = d ** -0.5
    s = scale * torch.matmul(_acc(_grouped(q, k.shape[1])),
                             _acc(k)[:, :, None].transpose(-1, -2))
    return torch.where(_keep_mask(b, l, causal, valid_len, segments,
                                  q.device), s, NEG_INF)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, valid_len: int = 0,
                          segments: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's function in plain PyTorch, in one pass over all
    keys (no tiles): fp32 scores masked to ``NEG_INF``, softmax statistics
    in fp32, probabilities cast to the input type before the V product.
    Same layouts and outputs as ``flash_with_lse_fwd``; ``scale`` defaults
    to ``D ** -0.5``."""
    _check(q, k, v, valid_len, segments)
    b, h, l, d = q.shape
    s = _scores(q, k, causal, valid_len, segments, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(_acc(p.to(v.dtype)), _acc(v)[:, :, None])
    o = (acc / denom).to(q.dtype).reshape(b, h, l, d)
    lse = (m + torch.log(denom)).reshape(b, h, 1, l)
    return o, lse


def xla_attention_bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True,
                       segments: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Plain attention on heads-leading ``[B, H, L, Dh]`` q/k/v (kv already
    repeated to H heads), the reference's ``attn_impl="xla"`` training path:
    fp32 scores scaled after the dot, masked to the fp32 minimum, softmax in
    fp32, probabilities cast to q's dtype before the V product.
    ``segments [B, L]`` keeps only same-segment pairs (packed windows)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    l = logits.shape[-1]
    mask = torch.ones(1, 1, l, l, dtype=torch.bool, device=q.device)
    if causal:
        mask = torch.tril(mask)
    if segments is not None:
        mask = mask & (segments[:, None, :, None]
                       == segments[:, None, None, :])
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def _probs_and_ds(q, k, v, do, lse, delta, causal, valid_len, segments,
                  scale=None):
    """p = exp(s − lse) and ds = p ∘ (dp − delta) · scale in fp32, with
    dp = dO·Vᵀ: ``[B, Hkv, rep, L, L]`` each, from the saved lse."""
    hkv = k.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    p = torch.exp(_scores(q, k, causal, valid_len, segments, scale)
                  - _grouped(lse, hkv).transpose(-1, -2))
    dp = torch.matmul(_acc(_grouped(do, hkv)),
                      _acc(v)[:, :, None].transpose(-1, -2))
    ds = p * (dp - _grouped(delta, hkv).transpose(-1, -2)) * scale
    return p, ds


def flash_bwd_dq_plain(q, k, v, do, lse, delta, causal: bool = True,
                       valid_len: int = 0,
                       segments: Optional[torch.Tensor] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The dq kernel's function in plain PyTorch: dq = ds·K with ds cast to
    the input type, fp32 sums. ``lse``/``delta`` ``[B, H, 1, L]`` fp32."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, valid_len,
                          segments, scale)
    dq = torch.matmul(_acc(ds.to(k.dtype)), _acc(k)[:, :, None])
    return dq.to(q.dtype).reshape(q.shape)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool = True,
                        valid_len: int = 0,
                        segments: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dk/dv kernel's function in plain PyTorch: per q-head dv = pᵀ·dO
    and dk = dsᵀ·Q (p and ds cast to the input type, fp32 sums), each cast
    to k's type, then the rep q-heads of a kv head summed in that type in
    order r = 0..rep−1, as ``_dkv_kernel`` accumulates its output block."""
    hkv = k.shape[1]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, valid_len,
                          segments, scale)
    dv_r = torch.matmul(_acc(p.to(do.dtype)).transpose(-1, -2),
                        _acc(_grouped(do, hkv))).to(v.dtype)
    dk_r = torch.matmul(_acc(ds.to(q.dtype)).transpose(-1, -2),
                        _acc(_grouped(q, hkv))).to(k.dtype)
    dk, dv = dk_r[:, :, 0], dv_r[:, :, 0]
    for r in range(1, dk_r.shape[2]):
        dk = dk + dk_r[:, :, r]
        dv = dv + dv_r[:, :, r]
    return dk, dv


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """``csrc/flash_fwd.cu``, built on first use, with its C signatures."""
    from tpu_on_k8s_torch.ops import _build

    lib = _build.load("flash_fwd")
    lib.flash_fwd.restype = _INT
    lib.flash_fwd.argtypes = [
        _INT, _INT,                    # dtype, head_dim
        _PTR, _PTR, _PTR,              # q, k, v
        _PTR, _PTR, _PTR,              # seg, o, lse
        _INT, _INT, _INT, _INT,        # B H Hkv L
        _INT, _INT, ctypes.c_float,    # causal, valid, scale
        ctypes.POINTER(ctypes.c_longlong), _PTR]  # strides, stream
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    lib.flash_fwd_error_string.argtypes = [_INT]
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    """``csrc/flash_bwd.cu``, built on first use, with its C signatures."""
    from tpu_on_k8s_torch.ops import _build

    lib = _build.load("flash_bwd")
    tail = [_INT, _INT, _INT, _INT,    # B H Hkv L
            _INT, _INT, ctypes.c_float,  # causal, valid, scale
            ctypes.POINTER(ctypes.c_longlong), _PTR]  # strides, stream
    # dtype, head_dim; q, k, v, dout, lse, delta, seg; then dq or dk, dv
    lib.flash_bwd_dq.restype = _INT
    lib.flash_bwd_dq.argtypes = [_INT, _INT] + [_PTR] * 8 + tail
    lib.flash_bwd_dkv.restype = _INT
    lib.flash_bwd_dkv.argtypes = [_INT, _INT] + [_PTR] * 9 + tail
    lib.flash_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_bwd_error_string.argtypes = [_INT]
    return lib


def _kernel_ok(t: torch.Tensor) -> bool:
    """Whether the kernels can read ``t`` in place: a contiguous head dim
    and 16-byte aligned rows."""
    align = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % align == 0 for s in t.stride()[:3]))


def _check_kernel_inputs(q, k, v) -> None:
    b, h = q.shape[:2]
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernel takes bfloat16 or float32, got "
                         f"{q.dtype}")
    if h > 65535 or b > 65535:
        raise ValueError(f"grid too large: batch {b}, heads {h}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_ok(t):
            raise ValueError(f"{name} needs a contiguous head dim and "
                             f"16-byte aligned rows")


def _segments_arg(segments):
    if segments is None:
        return None, None
    segments = segments.to(torch.int32).contiguous()
    return segments, segments.data_ptr()


def _launch(q, k, v, causal: bool, valid_len: int, segments, scale: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    b, h, l, d = q.shape
    _check_kernel_inputs(q, k, v)
    segments, seg_ptr = _segments_arg(segments)
    o = torch.empty_like(q)          # keeps q's strides: [B,L,H,D] in/out
    lse = torch.empty((b, h, 1, l), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            seg_ptr, o.data_ptr(), lse.data_ptr(), b, h, k.shape[1], l,
            int(causal), valid_len, scale, strides, stream)
    if err:
        raise RuntimeError(f"flash_fwd launch failed: "
                           f"{lib.flash_fwd_error_string(err).decode()}")
    launches += 1
    return o, lse


def _launch_bwd(name: str, q, k, v, do, lse, delta, causal: bool,
                valid_len: int, segments, scale: float, outs) -> None:
    """Launch ``flash_bwd_dq`` or ``flash_bwd_dkv`` writing ``outs``."""
    b, h, l, d = q.shape
    _check_kernel_inputs(q, k, v)
    if do.dtype != q.dtype:
        raise ValueError(f"dO is {do.dtype}, q is {q.dtype}")
    if not _kernel_ok(do):
        do = do.contiguous()    # autograd may hand an unaligned or strided dO
    lse, delta = lse.contiguous(), delta.contiguous()
    segments, seg_ptr = _segments_arg(segments)
    # strides of q, k, v, dO, dq, dk, dv; the kernel reads only its outputs'
    grads = {"flash_bwd_dq": (outs[0], None, None),
             "flash_bwd_dkv": (None, *outs)}[name]
    strides = (ctypes.c_longlong * 21)(*(
        s for t in (q, k, v, do, *grads)
        for s in (t.stride()[:3] if t is not None else (0, 0, 0))))
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, name)(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), seg_ptr,
            *(t.data_ptr() for t in outs), b, h, k.shape[1], l, int(causal),
            valid_len, scale, strides, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: "
                           f"{lib.flash_bwd_error_string(err).decode()}")


def _check_bwd(q, k, v, do, stat, valid_len, segments) -> None:
    _check(q, k, v, valid_len, segments)
    b, h, l, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    for name, t in stat.items():
        if t.shape != (b, h, 1, l) or t.dtype != _acc(q).dtype:
            raise ValueError(f"{name} must be [B, H, 1, L] = {(b, h, 1, l)} "
                             f"in {_acc(q).dtype}")


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = True, valid_len: int = 0,
                 segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dq from the forward's lse and ``delta`` (the counterpart of the
    reference's ``_dq_kernel`` call): ``csrc/flash_bwd.cu``'s dq kernel on
    CUDA tensors, ``flash_bwd_dq_plain`` on CPU tensors, through the
    operator ``tpu_on_k8s_torch::flash_bwd_dq``. dq has q's dtype and
    strides."""
    _check_bwd(q, k, v, do, {"lse": lse, "delta": delta}, valid_len,
               segments)
    return _dq_op(q, k, v, do, lse, delta, segments, causal, valid_len)


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = True, valid_len: int = 0,
                  segments: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the forward's lse and ``delta`` (the counterpart of the
    reference's ``_dkv_kernel`` call), the rep q-heads of a kv head summed:
    ``csrc/flash_bwd.cu``'s dk/dv kernel on CUDA tensors,
    ``flash_bwd_dkv_plain`` on CPU tensors, through the operator
    ``tpu_on_k8s_torch::flash_bwd_dkv``. dk/dv have k's and v's dtype and
    strides."""
    _check_bwd(q, k, v, do, {"lse": lse, "delta": delta}, valid_len,
               segments)
    return _dkv_op(q, k, v, do, lse, delta, segments, causal, valid_len)


def _require_cuda(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device.type}")


# The three kernels as operators (``torch.library.custom_op``): the
# dispatcher sees a call as the operator, not as the ctypes launch inside
# it, so a selective checkpoint's policy can save or recompute a kernel's
# outputs and ``torch.utils.flop_counter`` counts its products (formulas
# below). On CPU tensors each runs its plain twin.

@torch.library.custom_op("tpu_on_k8s_torch::flash_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            segments: Optional[torch.Tensor], causal: bool,
            valid_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, valid_len, segments)
    _require_cuda(q)
    return with_kernel_head_dim(
        lambda q, k, v, scale: _launch(q, k, v, causal, valid_len, segments,
                                       scale), (q, k, v), 1)


@_fwd_op.register_fake
def _(q, k, v, segments, causal, valid_len):
    b, h, l, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, 1, l), dtype=torch.float32)


@torch.library.custom_op("tpu_on_k8s_torch::flash_bwd_dq", mutates_args=())
def _dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
           segments: Optional[torch.Tensor], causal: bool,
           valid_len: int) -> torch.Tensor:
    global dq_launches
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, causal, valid_len,
                                  segments)
    _require_cuda(q)

    def launch(q, k, v, do, scale):
        dq = torch.empty_like(q)
        _launch_bwd("flash_bwd_dq", q, k, v, do, lse, delta, causal,
                    valid_len, segments, scale, (dq,))
        return dq

    dq = with_kernel_head_dim(launch, (q, k, v, do), 1)
    dq_launches += 1
    return dq


@_dq_op.register_fake
def _(q, k, v, do, lse, delta, segments, causal, valid_len):
    return torch.empty_like(q)


@torch.library.custom_op("tpu_on_k8s_torch::flash_bwd_dkv", mutates_args=())
def _dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
            segments: Optional[torch.Tensor], causal: bool,
            valid_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    global dkv_launches
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                   valid_len, segments)
    _require_cuda(q)

    def launch(q, k, v, do, scale):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        _launch_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, causal,
                    valid_len, segments, scale, (dk, dv))
        return dk, dv

    dk, dv = with_kernel_head_dim(launch, (q, k, v, do), 2)
    dkv_launches += 1
    return dk, dv


@_dkv_op.register_fake
def _(q, k, v, do, lse, delta, segments, causal, valid_len):
    return torch.empty_like(k), torch.empty_like(v)


def causal_pairs(l: int, causal: bool) -> int:
    """The (query, key) pairs that attention of length ``l`` keeps, causal
    or not: what the FLOP formulas count (``valid_len`` and segment masks
    are not subtracted)."""
    return l * (l + 1) // 2 if causal else l * l


# Each kernel's products over the kept pairs, 2·B·H·d FLOPs a pair and
# product with the true head dim d: the forward's 2 (QKᵀ, PV), dq's 3 (QKᵀ,
# dO Vᵀ, dS K) and dk/dv's 4 (QKᵀ, dO Vᵀ, Pᵀ dO, dSᵀ Q).

@register_flop_formula(torch.ops.tpu_on_k8s_torch.flash_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, segments, causal, valid_len, *,
               out_shape=None, **kwargs) -> int:
    b, h, l, d = q_shape
    return 4 * b * h * d * causal_pairs(l, causal)


@register_flop_formula(torch.ops.tpu_on_k8s_torch.flash_bwd_dq)
def _dq_flops(q_shape, k_shape, v_shape, do, lse, delta, segments, causal,
              valid_len, *, out_shape=None, **kwargs) -> int:
    b, h, l, d = q_shape
    return 6 * b * h * d * causal_pairs(l, causal)


@register_flop_formula(torch.ops.tpu_on_k8s_torch.flash_bwd_dkv)
def _dkv_flops(q_shape, k_shape, v_shape, do, lse, delta, segments, causal,
               valid_len, *, out_shape=None, **kwargs) -> int:
    b, h, l, d = q_shape
    return 8 * b * h * d * causal_pairs(l, causal)


def flash_with_lse_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, valid_len: int = 0,
                       segments: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward with the per-row logsumexp, through the operator
    ``tpu_on_k8s_torch::flash_fwd``.

    q ``[B, H, L, D]``, k/v ``[B, Hkv, L, D]`` (any strides with a
    contiguous head dim) → ``(o, lse)``: o in q's dtype and layout, lse fp32
    ``[B, H, 1, L]``. ``valid_len`` > 0 masks keys at positions ≥ it;
    ``segments [B, L]`` keeps only same-segment pairs."""
    _check(q, k, v, valid_len, segments)
    return _fwd_op(q, k, v, segments, causal, valid_len)


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True, valid_len: int = 0,
              segments: Optional[torch.Tensor] = None,
              g_lse: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of attention from the forward's o and lse: the counterpart
    of the reference's ``_bwd``. ``do`` is o's cotangent, ``g_lse`` (optional,
    ``[B, H, 1, L]``) lse's. Returns (dq, dk, dv) in the inputs' dtypes and
    shapes; the gradients of the rep q-heads of a kv head are summed into dk
    and dv."""
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    # per-row sum(dO ⊙ O); the lse cotangent folds in: ∂lse_r/∂s_rj = p_rj,
    # so ds = p ∘ (dp − (delta − g_lse)) and the kernels are unchanged
    delta = (_acc(do) * _acc(o)).sum(-1)[:, :, None, :]
    if g_lse is not None:
        delta = delta - _acc(g_lse)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, valid_len, segments)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, valid_len,
                           segments)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """(q, k, v) → (o, lse), differentiable in both outputs: the forward
    kernel, then the two backward kernels from the saved (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, valid_len, segments):
        o, lse = flash_with_lse_fwd(q, k, v, causal, valid_len, segments)
        ctx.save_for_backward(q, k, v, o, lse, segments)
        ctx.causal, ctx.valid_len = causal, valid_len
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse, segments = ctx.saved_tensors
        if g_o is None:
            g_o = torch.zeros_like(o)
        dq, dk, dv = flash_bwd(q, k, v, o, lse, g_o, ctx.causal,
                               ctx.valid_len, segments, g_lse)
        return dq, dk, dv, None, None, None


def flash_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, valid_len: int = 0,
                   segments: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_with_lse_fwd`` differentiable in both outputs (the lse
    cotangent folds into the backward's delta)."""
    return _Flash.apply(q, k, v, causal, valid_len, segments)


def flash_attention_bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, valid_len: int = 0,
                         segments: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Differentiable flash attention on heads-leading q ``[B, H, L, D]``
    and k/v ``[B, Hkv, L, D]`` → o ``[B, H, L, D]``: the training path's
    call."""
    return _Flash.apply(q, k, v, causal, valid_len, segments)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    segments: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Flash attention in the reference's public layout: q ``[B, L, H, D]``,
    k/v ``[B, L, Hkv, D]`` with ``H % Hkv == 0`` → ``[B, L, H, D]``.
    Differentiable; any sequence length; no padding is made."""
    o = flash_attention_bhld(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal, 0, segments)
    return o.transpose(1, 2)
