"""Llama-family decoder: the training forward and the KV-cache (serving)
mode.

Counterpart of ``tpu_on_k8s/models/transformer.py``: ``TransformerConfig``,
``RMSNorm``, half-split RoPE, ``Attention`` (heads-leading flash or plain
attention in training, the single-cursor KV cache in decode mode), the
SwiGLU ``MLP``, ``Block`` and ``Transformer`` with fp32 logits and an untied
head, and ``features`` for the chunked loss.

PyTorch idiom in place of Flax's: ``nn.Module``s whose parameters are plain
tensors, a Python loop over per-layer blocks in place of ``nn.scan`` over
stacked parameters, ``torch.utils.checkpoint`` in place of ``nn.remat``, and
KV caches preallocated by ``decode.init_cache`` and written in place. Dense
layers are ``Dense`` (an ``nn.Linear``: weight ``[out, in]``, the transpose
of a Flax ``kernel``) stored in ``cfg.param_dtype`` and cast to ``cfg.dtype``
at every use, as ``nn.Dense(dtype, param_dtype)`` computes. Training keeps
fp32 master weights; serving stores them already cast (``decode_model``), so
the cast is a no-op there.

The int8 recipes: ``mlp_int8``, ``attn_int8`` (training forward only; decode
keeps bf16 projections) and ``head_int8`` (fp32 logits) run their matmuls
through ``ops/int8_matmul.py`` (``Int8Dense``; ``int8_impl`` "xla" or
"pallas", the hand-written kernel), on the same ``weight`` a ``Dense`` holds.
``mlp_int8`` and ``head_int8`` act in decode mode too, as in the reference.
``serve_int8_weights`` (serving only) stores every projection as an int8
``weight_q [out, in]`` with a per-output-channel fp32 ``weight_scale``
(``W8Dense``) and the head as ``lm_head_q [D, V]`` with ``lm_head_scale
[V]``: the tree ``decode.quantize_weights_for_serving`` makes.

A config flag this port does not cover raises ``NotImplementedError``
naming it (``check_supported``; ``check_trainable`` for the training
forward); none is silently ignored. ``scan_unroll`` and
``attn_block_q``/``attn_block_k`` are TPU compile and tiling knobs with no
counterpart here: they are accepted and have no effect.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from torch.utils.checkpoint import checkpoint

from tpu_on_k8s_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bhld,
)
from tpu_on_k8s_torch.ops.int8_matmul import int8_matmul, int8_matmul_pallas


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, field for field, with ``torch.dtype``s."""

    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16        # compute dtype
    param_dtype: torch.dtype = torch.float32   # master weights (serving
                                               # stores them in ``dtype``)
    # Training knobs; ``decode_model`` turns remat off and attention to "xla"
    # as the reference's decode model does.
    remat: bool = True
    remat_policy: str = "full"
    attn_impl: str = "xla"
    attn_block_q: int = 0
    attn_block_k: int = 0
    scan_unroll: int = 1
    attn_native_gqa: bool = False
    fused_qkv: bool = False
    mlp_int8: bool = False
    int8_impl: str = "xla"
    mlp_fused_gateup: bool = False
    head_int8: bool = False
    attn_int8: bool = False     # decode keeps bf16 projections, as the
                                # reference does by design
    serve_int8_weights: bool = False
    cache_int8: bool = False
    pos_emb: str = "rope"
    norm: str = "rms"
    activation: str = "swiglu"
    use_bias: bool = False
    tie_embeddings: bool = False
    n_experts: int = 0
    experts_top_k: int = 2
    expert_capacity_factor: float = 1.25
    decode: bool = False
    decode_multislot: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    # ---- named sizes ---------------------------------------------------------
    @staticmethod
    def llama2_7b() -> "TransformerConfig":
        return TransformerConfig()  # defaults are the 7B shape

    @staticmethod
    def llama2_1b() -> "TransformerConfig":
        return TransformerConfig(d_model=2048, n_layers=16, n_heads=16,
                                 n_kv_heads=8, d_ff=5632)

    @staticmethod
    def tiny() -> "TransformerConfig":
        """Test/dry-run shape."""
        return TransformerConfig(vocab_size=256, d_model=64, n_layers=2,
                                 n_heads=4, n_kv_heads=2, d_ff=128,
                                 max_seq_len=128, remat=False)


#: (flag, holds when unsupported, the later slice that brings it)
_NOT_PORTED = (
    ("decode_multislot", lambda c: c.decode_multislot,
     "continuous-batching slot caches (models/serving.py)"),
    ("cache_int8", lambda c: c.cache_int8, "the int8 KV cache"),
    ("fused_qkv", lambda c: c.fused_qkv, "the fused wqkv projection"),
    ("n_experts", lambda c: c.n_experts > 0, "MoE (models/moe.py)"),
    ("pos_emb", lambda c: c.pos_emb != "rope", "GPT-2 family serving"),
    ("norm", lambda c: c.norm != "rms", "GPT-2 family serving"),
    ("activation", lambda c: c.activation != "swiglu",
     "GPT-2 family serving"),
    ("tie_embeddings", lambda c: c.tie_embeddings, "GPT-2 family serving"),
    ("use_bias", lambda c: c.use_bias, "GPT-2 family serving"),
    ("attn_impl", lambda c: c.attn_impl not in ("xla", "flash"),
     "ring/ulysses sequence parallelism"),
)


def _raise_first(cfg: TransformerConfig, table) -> None:
    for flag, unsupported, later in table:
        if unsupported(cfg):
            raise NotImplementedError(
                f"{flag}={getattr(cfg, flag)!r} is not ported to "
                f"tpu_on_k8s_torch yet ({later} is a later slice)")


def check_supported(cfg: TransformerConfig) -> None:
    """Raise ``ValueError`` for the layouts the reference rejects with int8
    weights, then ``NotImplementedError`` naming the first flag of ``cfg``
    that this port does not cover yet."""
    if cfg.serve_int8_weights and (cfg.fused_qkv or cfg.n_experts > 0):
        raise ValueError("serve_int8_weights does not cover fused_qkv or MoE "
                         "layouts")
    if cfg.use_bias and (cfg.mlp_int8 or cfg.attn_int8
                         or cfg.serve_int8_weights or cfg.fused_qkv):
        raise ValueError("use_bias is not supported with the int8 or "
                         "fused-qkv projection layouts")
    _raise_first(cfg, _NOT_PORTED)


#: What the training forward does not cover on top of ``_NOT_PORTED``.
_NOT_TRAINABLE = (
    ("remat_policy",
     lambda c: c.remat and c.remat_policy in ("dots", "dots_kernels"),
     "the dots/dots_kernels remat policies"),
)


def check_trainable(cfg: TransformerConfig) -> None:
    """``check_supported``, and the flags only the training forward reads."""
    check_supported(cfg)
    _raise_first(cfg, _NOT_TRAINABLE)


def _rope_tables(positions: torch.Tensor, half: int, theta: float):
    """cos/sin tables [B, L, half] in fp32."""
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=positions.device) / half))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding. x: [B, L, H, Dh]; positions: [B, L]."""
    cos, sin = _rope_tables(positions, x.shape[-1] // 2, theta)
    return _rope_rotate(x, cos[:, :, None, :], sin[:, :, None, :])


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


class RMSNorm(nn.Module):
    """Statistics in fp32, times the fp32 scale, then cast to ``dtype``."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(self.dtype)


class Positions(NamedTuple):
    """What every layer reads of a call's positions, computed once per
    forward: the positions ``[B, L]``, the RoPE tables ``[B, L, 1, Dh/2]``
    and whether the positions are the plain ``arange`` (one host sync per
    forward, not one per layer)."""

    ids: torch.Tensor
    cos: torch.Tensor
    sin: torch.Tensor
    is_arange: bool


@dataclasses.dataclass
class KVCache:
    """One layer's KV cache: ``[B, max_seq_len, Hkv, Dh]`` tensors allocated
    once and written in place, plus the shared append cursor (positions
    ``[0, index)`` hold keys/values)."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0


class Dense(nn.Linear):
    """A bias-free ``nn.Linear`` whose weight is stored in
    ``cfg.param_dtype`` and cast to ``cfg.dtype`` at every use."""

    def __init__(self, n_in: int, n_out: int, cfg: TransformerConfig):
        super().__init__(n_in, n_out, bias=False, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(self.compute_dtype))


def _int8_mm(impl: str):
    """The int8-forward matmul for ``cfg.int8_impl``, shared by every int8
    call site (MLP, attention projections, lm head)."""
    if impl == "pallas":
        return int8_matmul_pallas
    if impl != "xla":
        raise ValueError(f"unknown int8_impl {impl!r} (use 'xla'|'pallas')")
    return int8_matmul


class Int8Dense(Dense):
    """``Dense`` whose matmul runs the int8-forward path on the weight cast
    to ``cfg.dtype``; the parameter is the same, so the int8 recipes apply
    to a checkpoint as it is."""

    def __init__(self, n_in: int, n_out: int, cfg: TransformerConfig):
        super().__init__(n_in, n_out, cfg)
        self.impl = cfg.int8_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _int8_mm(self.impl)(x, self.weight.to(self.compute_dtype))


class W8Dense(nn.Module):
    """Serving-time W8A16 dense: an int8 ``weight_q [out, in]`` and an fp32
    ``weight_scale [out]`` per output channel. The product of x with the
    int8 values widened to ``cfg.dtype`` is rescaled in fp32 (a bf16 scale
    would add a systematic per-channel error), then cast: ``x @ (q·s)ᵀ ==
    (x @ qᵀ)·s`` for a per-channel scale."""

    def __init__(self, n_in: int, n_out: int, cfg: TransformerConfig):
        super().__init__()
        self.compute_dtype = cfg.dtype
        self.weight_q = nn.Parameter(torch.empty(n_out, n_in,
                                                 dtype=torch.int8),
                                     requires_grad=False)
        self.weight_scale = nn.Parameter(torch.empty(n_out,
                                                     dtype=torch.float32),
                                         requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight_q.to(self.compute_dtype))
        return (y.float() * self.weight_scale).to(self.compute_dtype)


def _dense_class(cfg: TransformerConfig, int8: bool):
    """The projection module of a layer: ``W8Dense`` for int8 serving
    weights, else ``Int8Dense`` where the int8 recipe covers the layer,
    else ``Dense``."""
    if cfg.serve_int8_weights:
        return W8Dense
    return Int8Dense if int8 else Dense


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        # decode keeps bf16 projections under attn_int8, as the reference
        dense = _dense_class(cfg, cfg.attn_int8 and not cfg.decode)
        self.wq = dense(cfg.d_model, cfg.n_heads * hd, cfg)
        self.wk = dense(cfg.d_model, cfg.n_kv_heads * hd, cfg)
        self.wv = dense(cfg.d_model, cfg.n_kv_heads * hd, cfg)
        self.wo = dense(cfg.n_heads * hd, cfg.d_model, cfg)

    def forward(self, x: torch.Tensor, pos: Positions,
                cache: Optional[KVCache] = None,
                segments: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, l, _ = x.shape
        q = self.wq(x).view(b, l, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).view(b, l, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).view(b, l, cfg.n_kv_heads, cfg.head_dim)
        q = _rope_rotate(q, pos.cos, pos.sin)
        k = _rope_rotate(k, pos.cos, pos.sin)
        if cache is not None:
            out = self._cached_attention(q, k, v, pos, cache)
        else:
            out = self._attention_bhld(q, k, v, segments)
        return self.wo(out.reshape(b, l, cfg.n_heads * cfg.head_dim))

    def _attention_bhld(self, q, k, v, segments) -> torch.Tensor:
        """The training path's attention, as the reference's
        ``_attention_bhld``: q/k/v ``[B, L, H, Dh]`` read as heads-leading
        views. ``attn_impl="flash"`` runs the differentiable flash kernels
        on Hkv-head k/v (``attn_native_gqa``) or on k/v repeated to H heads;
        ``"xla"`` repeats k/v and runs ``xla_attention_bhld``. Autograd sums
        the gradients of a repeat. Returns ``[B, L, H, Dh]``."""
        cfg = self.cfg
        rep = cfg.n_heads // cfg.n_kv_heads
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        if cfg.attn_impl == "flash":
            if not cfg.attn_native_gqa:
                k = k.repeat_interleave(rep, dim=1)
                v = v.repeat_interleave(rep, dim=1)
            out = flash_attention_bhld(q, k, v, True, 0, segments)
        else:
            out = xla_attention_bhld(q, k.repeat_interleave(rep, dim=1),
                                     v.repeat_interleave(rep, dim=1), True,
                                     segments)
        return out.transpose(1, 2)

    def _cached_attention(self, q, k, v, pos: Positions,
                          cache: KVCache) -> torch.Tensor:
        """Append this call's keys/values at the cache cursor (in place),
        then attend. A multi-token call into an empty cache whose positions
        are the plain ``arange`` (how ``generate`` starts) attends among its
        own L tokens through ``flash_attention`` with Hkv-head k/v; every
        other call attends over the whole cache."""
        l = q.shape[1]
        start = cache.index
        if start + l > cache.k.shape[1]:
            raise ValueError(f"cache overflow: {start} + {l} positions > "
                             f"cache length {cache.k.shape[1]}")
        cache.k[:, start:start + l] = k
        cache.v[:, start:start + l] = v
        cache.index = start + l
        if l > 1 and start == 0 and pos.is_arange:
            return flash_attention(q, k, v, causal=True)
        return self._over_cache(q, pos.ids, cache)

    def _over_cache(self, q: torch.Tensor, positions: torch.Tensor,
                    cache: KVCache) -> torch.Tensor:
        """Attend over the whole cache, masked to ≤ query position — right
        for any cursor. q is scaled in fp32 before the dot, masked scores
        are -1e30, and probabilities are cast to q's dtype before the V
        product, as in the reference's ``over_cache``. The ``rep`` query
        heads of a kv head are stacked as rows, so both products are plain
        batched matmuls over (B, Hkv): no repeated K/V is made."""
        b, l, h, hd = q.shape
        hkv = self.cfg.n_kv_heads
        rep = h // hkv
        qg = (q.float() * hd ** -0.5).view(b, l, hkv, rep, hd)
        qg = qg.permute(0, 2, 3, 1, 4).reshape(b, hkv, rep * l, hd)
        kc = cache.k.transpose(1, 2).to(torch.float32,
                                        memory_format=torch.contiguous_format)
        logits = torch.matmul(qg, kc.transpose(-1, -2))  # [B, Hkv, rep·l, max]
        k_pos = torch.arange(cache.k.shape[1], device=q.device)
        mask = k_pos <= positions.repeat(1, rep)[:, None, :, None]
        probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        out = torch.matmul(probs.to(q.dtype), cache.v.transpose(1, 2))
        return out.view(b, hkv, rep, l, hd).permute(0, 3, 1, 2, 4).reshape(
            b, l, h, hd)


class MLP(nn.Module):
    """SwiGLU; ``mlp_fused_gateup`` keeps one [2·d_ff, D] gate+up weight
    (gate first), the layout of the reference's ``w_gateup`` kernel."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.d_ff = cfg.d_ff
        self.fused = cfg.mlp_fused_gateup
        dense = _dense_class(cfg, cfg.mlp_int8)
        if self.fused:
            self.w_gateup = dense(cfg.d_model, 2 * cfg.d_ff, cfg)
        else:
            self.w_gate = dense(cfg.d_model, cfg.d_ff, cfg)
            self.w_up = dense(cfg.d_model, cfg.d_ff, cfg)
        self.w_down = dense(cfg.d_ff, cfg.d_model, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            gate, up = self.w_gateup(x).split(self.d_ff, dim=-1)
        else:
            gate, up = self.w_gate(x), self.w_up(x)
        return self.w_down(F.silu(gate) * up)


class Block(nn.Module):
    """Pre-norm block. With ``remat`` and ``remat_policy="mlp"`` the MLP is
    recomputed in the backward pass while the attention's residuals stay
    (the reference's MLP-only ``nn.remat``)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.remat_mlp = cfg.remat and cfg.remat_policy == "mlp"
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, pos: Positions,
                cache: Optional[KVCache] = None,
                segments: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x + self.attn(self.attn_norm(x), pos, cache, segments)
        y = self.mlp_norm(h)
        if self.remat_mlp and torch.is_grad_enabled():
            return h + checkpoint(self.mlp, y, use_reentrant=False)
        return h + self.mlp(y)


class Transformer(nn.Module):
    """Decoder-only LM. ``forward(tokens [B, L], positions, cache,
    last_only, segments)`` → fp32 logits ``[B, L, vocab]`` (``[B, 1,
    vocab]`` with ``last_only``); ``features`` → the final-norm hidden
    states and the head ``[D, V]`` in ``cfg.dtype`` for the chunked loss.

    With ``cfg.decode`` every call takes one ``KVCache`` per layer (build it
    with ``decode.decode_model``); otherwise no cache, and ``segments
    [B, L]`` restrict attention to packed documents. ``remat`` with any
    policy but "mlp" recomputes each whole block in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); "mlp" only the MLP."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.serve_int8_weights and not cfg.decode:
            raise ValueError("serve_int8_weights is a serving (decode) "
                             "recipe; training keeps bf16 weights")
        if cfg.decode:
            check_supported(cfg)
        else:
            check_trainable(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=cfg.param_dtype))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        if cfg.serve_int8_weights:
            self.lm_head_q = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab_size, dtype=torch.int8),
                requires_grad=False)
            self.lm_head_scale = nn.Parameter(
                torch.empty(cfg.vocab_size, dtype=torch.float32),
                requires_grad=False)
        else:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.d_model, cfg.vocab_size, dtype=cfg.param_dtype))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[List[KVCache]] = None,
                last_only: bool = False,
                segments: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        x = self._trunk(tokens, positions, cache, segments)
        if last_only:
            x = x[:, -1:]
        # fp32 logits from the cfg.dtype (or int8) head: products of bf16
        # and int8 values are exact in fp32, so this is the reference's
        # fp32-accumulated einsum.
        if cfg.serve_int8_weights:
            return (torch.matmul(x.float(), self.lm_head_q.float())
                    * self.lm_head_scale)
        head = self.lm_head.to(cfg.dtype)
        if cfg.head_int8:
            return _int8_mm(cfg.int8_impl)(x, head.t(), torch.float32)
        return torch.matmul(x.float(), head.float())

    def features(self, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 segments: Optional[torch.Tensor] = None):
        """(final-norm hidden states ``[B, L, D]``, head ``[D, V]``), both
        in ``cfg.dtype``: what ``chunked_cross_entropy`` takes. The int8
        serving head is the pair (``lm_head_q``, ``lm_head_scale``), as the
        reference returns it."""
        x = self._trunk(tokens, positions, None, segments)
        if self.cfg.serve_int8_weights:
            return x, (self.lm_head_q, self.lm_head_scale)
        return x, self.lm_head.to(self.cfg.dtype)

    def _trunk(self, tokens, positions, cache, segments):
        cfg = self.cfg
        if cfg.decode:
            if cache is None or len(cache) != len(self.blocks):
                raise ValueError("the serving model needs one KVCache per "
                                 "layer (decode.init_cache)")
            if segments is not None:
                raise ValueError("segment-masked attention is a "
                                 "packed-window training feature")
        elif cache is not None:
            raise ValueError("the training model (decode=False) takes no "
                             "cache")
        arange = torch.arange(tokens.shape[1], dtype=torch.int32,
                              device=tokens.device).expand_as(tokens)
        if positions is None:
            positions = arange
        cos, sin = _rope_tables(positions, cfg.head_dim // 2, cfg.rope_theta)
        pos = Positions(positions, cos[:, :, None, :], sin[:, :, None, :],
                        cfg.decode and tokens.shape[1] > 1
                        and torch.equal(positions.int(), arange))
        # an fp32 gather from the master table, then the cast
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        remat_block = (cfg.remat and cfg.remat_policy != "mlp"
                       and torch.is_grad_enabled())
        for i, block in enumerate(self.blocks):
            if remat_block:
                x = checkpoint(block, x, pos, None, segments,
                               use_reentrant=False)
            else:
                x = block(x, pos, cache[i] if cache is not None else None,
                          segments)
        return self.final_norm(x)
