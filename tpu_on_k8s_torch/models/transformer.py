"""Llama-family decoder in KV-cache (serving) mode.

Counterpart of ``tpu_on_k8s/models/transformer.py`` for the path that
``generate`` runs: ``TransformerConfig``, ``RMSNorm``, half-split RoPE, the
decode-mode ``Attention`` with its single-cursor KV cache, the SwiGLU
``MLP``, ``Block`` and ``Transformer`` with fp32 logits and an untied head.

PyTorch idiom in place of Flax's: ``nn.Module``s whose parameters are plain
tensors, a Python loop over per-layer blocks in place of ``nn.scan`` over
stacked parameters, and KV caches preallocated by ``decode.init_cache`` and
written in place. Dense layers are ``nn.Linear`` (weight ``[out, in]``, the
transpose of a Flax ``kernel``), stored and computed in ``cfg.dtype`` as
``nn.Dense(dtype=cfg.dtype)`` computes after casting its fp32 master weight.

A config flag this slice does not cover raises ``NotImplementedError``
naming it (``check_supported``); none is silently ignored.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_on_k8s_torch.ops.flash_attention import NEG_INF, flash_attention


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
    dtype: torch.dtype = torch.bfloat16        # compute and weight dtype
    param_dtype: torch.dtype = torch.float32   # the reference's master weights
    # Training knobs: the reference's decode model does not read them either
    # (``decode_model`` turns remat off and attention to "xla").
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
    ("serve_int8_weights", lambda c: c.serve_int8_weights,
     "W8A16 serving weights"),
    ("fused_qkv", lambda c: c.fused_qkv, "the fused wqkv projection"),
    ("n_experts", lambda c: c.n_experts > 0, "MoE (models/moe.py)"),
    ("pos_emb", lambda c: c.pos_emb != "rope", "GPT-2 family serving"),
    ("norm", lambda c: c.norm != "rms", "GPT-2 family serving"),
    ("activation", lambda c: c.activation != "swiglu",
     "GPT-2 family serving"),
    ("tie_embeddings", lambda c: c.tie_embeddings, "GPT-2 family serving"),
    ("use_bias", lambda c: c.use_bias, "GPT-2 family serving"),
    ("mlp_int8", lambda c: c.mlp_int8, "the int8 GEMM kernel"),
    ("head_int8", lambda c: c.head_int8, "the int8 GEMM kernel"),
    ("attn_impl", lambda c: c.attn_impl not in ("xla", "flash"),
     "ring/ulysses sequence parallelism"),
)


def check_supported(cfg: TransformerConfig) -> None:
    """Raise ``NotImplementedError`` naming the first flag of ``cfg`` that
    this port does not cover yet."""
    for flag, unsupported, later in _NOT_PORTED:
        if unsupported(cfg):
            raise NotImplementedError(
                f"{flag}={getattr(cfg, flag)!r} is not ported to "
                f"tpu_on_k8s_torch yet ({later} is a later slice)")


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


def _linear(n_in: int, n_out: int, cfg: TransformerConfig) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=cfg.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = _linear(cfg.d_model, cfg.n_heads * hd, cfg)
        self.wk = _linear(cfg.d_model, cfg.n_kv_heads * hd, cfg)
        self.wv = _linear(cfg.d_model, cfg.n_kv_heads * hd, cfg)
        self.wo = _linear(cfg.n_heads * hd, cfg.d_model, cfg)

    def forward(self, x: torch.Tensor, pos: Positions,
                cache: KVCache) -> torch.Tensor:
        cfg = self.cfg
        b, l, _ = x.shape
        q = self.wq(x).view(b, l, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).view(b, l, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).view(b, l, cfg.n_kv_heads, cfg.head_dim)
        q = _rope_rotate(q, pos.cos, pos.sin)
        k = _rope_rotate(k, pos.cos, pos.sin)
        out = self._cached_attention(q, k, v, pos, cache)
        return self.wo(out.reshape(b, l, cfg.n_heads * cfg.head_dim))

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
        if self.fused:
            self.w_gateup = _linear(cfg.d_model, 2 * cfg.d_ff, cfg)
        else:
            self.w_gate = _linear(cfg.d_model, cfg.d_ff, cfg)
            self.w_up = _linear(cfg.d_model, cfg.d_ff, cfg)
        self.w_down = _linear(cfg.d_ff, cfg.d_model, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fused:
            gate, up = self.w_gateup(x).split(self.d_ff, dim=-1)
        else:
            gate, up = self.w_gate(x), self.w_up(x)
        return self.w_down(F.silu(gate) * up)


class Block(nn.Module):
    """Pre-norm block."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.attn = Attention(cfg)
        self.mlp_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, pos: Positions,
                cache: KVCache) -> torch.Tensor:
        h = x + self.attn(self.attn_norm(x), pos, cache)
        return h + self.mlp(self.mlp_norm(h))


class Transformer(nn.Module):
    """Decoder-only LM in KV-cache mode: ``forward(tokens [B, L], positions,
    cache)`` → fp32 logits ``[B, L, vocab]`` (``[B, 1, vocab]`` with
    ``last_only``). Build it with ``decode.decode_model``; the training
    forward (no cache, ``decode=False``) is a later slice."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        check_supported(cfg)
        if not cfg.decode:
            raise NotImplementedError(
                "decode=False is not ported to tpu_on_k8s_torch yet (the "
                "training forward is a later slice); build the serving "
                "model with models.decode.decode_model")
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=cfg.dtype))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size,
                                                dtype=cfg.dtype))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[List[KVCache]] = None,
                last_only: bool = False) -> torch.Tensor:
        if cache is None or len(cache) != len(self.blocks):
            raise ValueError("the serving model needs one KVCache per layer "
                             "(decode.init_cache)")
        cfg = self.cfg
        arange = torch.arange(tokens.shape[1], dtype=torch.int32,
                              device=tokens.device).expand_as(tokens)
        if positions is None:
            positions = arange
        cos, sin = _rope_tables(positions, cfg.head_dim // 2, cfg.rope_theta)
        pos = Positions(positions, cos[:, :, None, :], sin[:, :, None, :],
                        tokens.shape[1] > 1
                        and torch.equal(positions.int(), arange))
        x = F.embedding(tokens, self.embed)
        for block, layer_cache in zip(self.blocks, cache):
            x = block(x, pos, layer_cache)
        x = self.final_norm(x)
        if last_only:
            x = x[:, -1:]
        # fp32 logits from the cfg.dtype head: products of bf16 values are
        # exact in fp32, so this is the reference's fp32-accumulated einsum.
        return torch.matmul(x.float(), self.lm_head.float())
