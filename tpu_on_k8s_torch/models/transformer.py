"""Llama- and GPT-2-family decoder: the training forward and the KV-cache
(serving) mode.

Counterpart of ``tpu_on_k8s/models/transformer.py``: ``TransformerConfig``,
``RMSNorm`` or ``LayerNorm`` (``norm``), half-split RoPE or a learned
position table (``pos_emb``), ``Attention`` (heads-leading flash or plain
attention in training, the single-cursor KV cache in decode mode), the
SwiGLU or tanh-GELU ``MLP`` (``activation``), biased projections
(``use_bias``), ``Block`` and ``Transformer`` with fp32 logits from an
untied head or the embedding table (``tie_embeddings``), and ``features``
for the chunked loss. ``decode_multislot`` (the
continuous-batching engine's step model, ``models/serving.py``) makes the
cache's batch rows independent slots, each appending at its own position.

PyTorch idiom in place of Flax's: ``nn.Module``s whose parameters are plain
tensors, a Python loop over per-layer blocks in place of ``nn.scan`` over
stacked parameters, ``torch.utils.checkpoint`` in place of ``nn.remat``
(selective, with a policy, where the reference's remat has one: "mlp",
"dots", "dots_kernels"; the hand-written kernels are operators the
policies see), and
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
``cache_int8`` (serving only) keeps the KV cache as int8 values with one
fp32 absmax scale per (token, kv head): ``quantize_kv`` at every append,
``dequantize_kv`` at every read over the cache.

``fused_qkv`` keeps one ``wqkv`` weight ``[(H + 2·Hkv)·Dh, D]`` (q, then k,
then v rows), the reference's ``attn/wqkv/kernel`` transposed, in training
and serving alike. Under a mesh (``parallel/sharded.py``) the projections
run tensor-parallel on local heads (H/model query heads a rank, or every
head gathered where ``model`` does not divide them: ``Attention.tp``), and
``embed``, ``lm_head`` and the tied head are vocab-sharded ``DTensor``s:
``_embed`` and ``_logits`` gather their products over the ``model`` axis;
the int8 recipes run on the ranks' local blocks (``_int8_on_blocks``).
A serving model (``sharded.shard_serving_model``) holds the same blocks as
plain local tensors: row-parallel projections and the vocab-parallel
embedding and head call their ``tp`` group's collectives. On a ``seq``
axis > 1 (training) each rank runs one chunk of every sequence at its
global positions, and ``attn_impl`` "ring" or "ulysses" runs attention
over the axis (``parallel/ring.py``, ``parallel/ulysses.py``; off such an
axis both are the plain attention, as the reference's), while "xla" and
"flash" gather the chunks whole (``Attention``).
``n_experts > 0`` swaps each block's MLP for ``models/moe.py``'s
``MoEMLP`` (``Block.moe``), whose load-balance losses ``forward`` and
``features`` return summed with ``with_aux=True``.
``flagship_partition_rules`` and ``serving_partition_rules`` are the
reference's rules on the port's names.

A config flag this port does not cover raises ``NotImplementedError``
naming it (``check_supported``); none is silently ignored. ``scan_unroll``
and ``attn_block_q``/``attn_block_k`` are TPU compile and tiling knobs with
no counterpart here: they are accepted and have no effect.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from tpu_on_k8s_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bhld,
    xla_attention_bhld,
)
from tpu_on_k8s_torch.models import moe
from tpu_on_k8s_torch.ops.int8_matmul import int8_matmul, int8_matmul_pallas
from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    MeshAxis,
)
from tpu_on_k8s_torch.parallel.partition import PartitionRule
from tpu_on_k8s_torch.parallel.ring import plain_attention, ring_attention_shard
from tpu_on_k8s_torch.parallel.ulysses import ulysses_attention_shard


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
    def gpt2_small() -> "TransformerConfig":
        """The 124M GPT-2 shape, bias-free as the reference defines it
        (``convert.config_from_hf_gpt2`` sets ``use_bias``)."""
        return TransformerConfig(vocab_size=50257, d_model=768, n_layers=12,
                                 n_heads=12, n_kv_heads=12, d_ff=3072,
                                 max_seq_len=1024, pos_emb="learned",
                                 norm="ln", activation="gelu",
                                 tie_embeddings=True)

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


#: (flag, holds when unsupported, the later slice that brings it); empty
#: while every flag of the reference's config is ported
_NOT_PORTED = ()
#: the training attentions: the heads-leading single-sequence paths, and
#: the sequence-parallel ones over a ``seq`` mesh axis (``parallel/ring.py``,
#: ``parallel/ulysses.py``)
ATTN_IMPLS = ("xla", "flash", "ring", "ulysses")


def _raise_first(cfg: TransformerConfig, table) -> None:
    for flag, unsupported, later in table:
        if unsupported(cfg):
            raise NotImplementedError(
                f"{flag}={getattr(cfg, flag)!r} is not ported to "
                f"tpu_on_k8s_torch yet ({later} is a later slice)")


def check_supported(cfg: TransformerConfig) -> None:
    """Raise ``ValueError`` for the layouts the reference rejects with int8
    weights and for an unknown ``attn_impl``, then
    ``NotImplementedError`` naming the first flag of ``cfg`` that this
    port does not cover yet."""
    if cfg.serve_int8_weights and (cfg.fused_qkv or cfg.n_experts > 0):
        raise ValueError("serve_int8_weights does not cover fused_qkv or MoE "
                         "layouts")
    if cfg.use_bias and (cfg.mlp_int8 or cfg.attn_int8
                         or cfg.serve_int8_weights or cfg.fused_qkv):
        raise ValueError("use_bias is not supported with the int8 or "
                         "fused-qkv projection layouts")
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    _raise_first(cfg, _NOT_PORTED)


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


class LayerNorm(nn.Module):
    """Flax's ``nn.LayerNorm`` as the reference builds it: the statistics in
    fp32 with the fast variance ``E[x²] − E[x]²`` clipped at 0 (flax's
    ``use_fast_variance`` default; ``F.layer_norm`` computes it another
    way), then ``(x − mean) · (rsqrt(var + eps) · scale) + bias`` in fp32,
    cast to ``dtype``. Scale and bias are fp32."""

    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp(x32.square().mean(dim=-1, keepdim=True)
                          - mean.square(), min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale.float()
        return ((x32 - mean) * mul + self.bias.float()).to(self.dtype)


def make_norm(cfg: TransformerConfig) -> nn.Module:
    if cfg.norm == "ln":
        return LayerNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
    return RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)


class Positions(NamedTuple):
    """What every layer reads of a call's positions, computed once per
    forward: the positions ``[B, L]``, the RoPE tables ``[B, L, 1, Dh/2]``
    (None for learned positions, which the embedding adds) and whether the
    positions are the plain ``arange`` (one host sync per forward, not one
    per layer; never for a multislot call, whose rows sit at unrelated
    positions) and whether the call is multislot (the root's
    ``decode_multislot``: a serving engine's step model shares its blocks
    with its prefill model, ``serving.multislot_twin``)."""

    ids: torch.Tensor
    cos: Optional[torch.Tensor]
    sin: Optional[torch.Tensor]
    is_arange: bool
    multislot: bool = False


#: The cache quantizer's scale factor: the reference writes ``max|x| /
#: 127.0``, which XLA evaluates under ``jit`` (every serving path) as a
#: product with the fp32 reciprocal. The fp32 constant makes the product
#: the same on every device and route.
_INV127 = float(np.float32(1.0 / 127.0))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., Dh]`` keys or values → (int8 ``[..., Dh]``, fp32 scales
    ``[...]``), the reference's cache quantizer in its order: the fp32
    absmax times fp32(1/127) is the scale ``s``; the values are divided
    (a true division) by ``max(s, 1e-9)``, rounded half to even and cast.
    The stored scale is ``s`` itself, so a zero row keeps scale 0. Not the
    ``ops/quantization.py`` kernels: those round stochastically and floor
    the absmax at 1e-30."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1) * _INV127
    q = torch.round(x32 / torch.clamp(s, min=1e-9)[..., None])
    return q.to(torch.int8), s


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """int8 ``[..., Dh]`` times fp32 scales ``[...]`` in fp32, then cast to
    ``dtype``: on a bf16 model the read rounds through bf16, as the
    reference's does before its fp32 scores."""
    return (q.float() * scale[..., None]).to(dtype)


@dataclasses.dataclass
class KVCache:
    """One layer's KV cache: ``[B, max_seq_len, Hkv, Dh]`` tensors allocated
    once and written in place, plus the shared append cursor (positions
    ``[0, index)`` hold keys/values). A ``decode_multislot`` model neither
    reads nor moves the cursor: each row appends at its own positions.

    An int8 cache (``cfg.cache_int8``) holds int8 ``k``/``v`` and fp32
    ``k_scale``/``v_scale`` ``[B, max_seq_len, Hkv]``: appends quantize
    once (``quantize_kv``), reads dequantize (``dequantize_kv``)."""

    k: torch.Tensor
    v: torch.Tensor
    index: int = 0
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def int8(self) -> bool:
        return self.k_scale is not None

    def writes(self, k: torch.Tensor, v: torch.Tensor):
        """The (destination, value) pairs that append keys and values
        ``[B, l, Hkv, Dh]``: as they are, or quantized into the int8
        values and the scales, in the reference's leaf order."""
        if not self.int8:
            return ((self.k, k), (self.v, v))
        (k8, ks), (v8, vs) = quantize_kv(k), quantize_kv(v)
        return ((self.k, k8), (self.k_scale, ks), (self.v, v8),
                (self.v_scale, vs))

    def read(self, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole cache's K and V as attention reads them: the stored
        tensors, or the int8 ones dequantized to ``dtype``."""
        if not self.int8:
            return self.k, self.v
        return (dequantize_kv(self.k, self.k_scale, dtype),
                dequantize_kv(self.v, self.v_scale, dtype))


class Dense(nn.Linear):
    """An ``nn.Linear`` whose weight (and bias, with ``cfg.use_bias``) is
    stored in ``cfg.param_dtype`` and cast to ``cfg.dtype`` at every use.
    The bias is added after the product, in ``cfg.dtype``, as Flax's
    ``Dense`` adds it (the product rounds once, the sum once), and the
    product stays a plain ``mm`` whose first operand is the input, which
    the remat policies read. A row-parallel projection, a serving one
    (``parallel/sharded.shard_serving_model``) on its rank's input columns
    or a training one on ``DTensor``s, sums the partial products over the
    ``model`` axis before the bias."""

    #: the tensor-parallel group a row-parallel serving projection sums
    #: its partial products over (None: the whole product is here)
    tp = None
    #: on a ``model`` axis: 0 column parallel (the rank's output rows), 1
    #: row parallel (its input columns), None whole (``_in_width``)
    role = None

    def __init__(self, n_in: int, n_out: int, cfg: TransformerConfig):
        super().__init__(n_in, n_out, bias=cfg.use_bias,
                         dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(self.compute_dtype))
        if self.tp is not None:
            y = self.tp.reduce(y)
        elif self.role == 1 and isinstance(y, DTensor):
            # a row-parallel product's partial sums, summed over the model
            # axis before the bias, which is then added once
            y = y.redistribute(y.device_mesh, [Replicate()])
        if self.bias is not None:
            y = y + self.bias.to(self.compute_dtype)
        return y


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
    to a checkpoint as it is. On a ``model`` axis the kernel sees local
    blocks: a column-parallel product (the rank's output rows) is the
    unsharded product's columns; a row-parallel one (``tp`` set, or a
    ``DTensor`` weight split on its input columns) quantizes with the
    absmax all-reduced (max) over the axis and sums its fp32 partial
    products before one cast (``_int8_on_blocks``)."""

    def __init__(self, n_in: int, n_out: int, cfg: TransformerConfig):
        super().__init__(n_in, n_out, cfg)
        self.impl = cfg.int8_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mm = _int8_mm(self.impl)
        w = self.weight.to(self.compute_dtype)
        if isinstance(w, DTensor):
            return _int8_on_blocks(mm, x, w)
        return mm(x, w, **_row_sums(self.tp))


def _row_sums(tp) -> dict:
    """The collectives a row-parallel int8 product over the ``model`` axis
    ``tp`` passes the kernel's wrapper (none for a whole product)."""
    if tp is None:
        return {}
    return dict(reduce_max=tp.reduce_max, reduce_sum=tp.reduce)


def _int8_on_blocks(mm, x: DTensor, w: DTensor,
                    out_dtype: Optional[torch.dtype] = None) -> DTensor:
    """An int8 product of ``DTensor``s on the ``model`` axis, as the
    kernel's wrappers take it: on this rank's blocks. A weight split on
    its output rows (column parallel; ``x`` replicated) makes the rank's
    output columns, and ``x``'s gradient is summed over the axis (a
    ``Partial`` gradient); one split on its input columns (row parallel;
    ``x`` split alike) quantizes over the whole K (``reduce_max``) and sums
    the fp32 partial products before the cast: the whole output on every
    rank."""
    mesh = w.device_mesh
    if w.placements[0].is_shard(0):
        y = mm(x.to_local(grad_placements=[Partial()]), w.to_local(),
               out_dtype)
        return DTensor.from_local(y, mesh, [Shard(y.dim() - 1)],
                                  run_check=False)
    from tpu_on_k8s_torch.parallel.sharded import TensorParallel
    y = mm(x.to_local(), w.to_local(), out_dtype,
           **_row_sums(TensorParallel(mesh)))
    return DTensor.from_local(y, mesh, [Replicate()], run_check=False)


def _in_width(proj: nn.Module, n: int) -> int:
    """The width of the input a projection takes on a rank of a ``model``
    axis of ``n``: its input columns when row parallel, else all."""
    return proj.in_features // n if proj.role == 1 else proj.in_features


class W8Dense(nn.Module):
    """Serving-time W8A16 dense: an int8 ``weight_q [out, in]`` and an fp32
    ``weight_scale [out]`` per output channel. The product of x with the
    int8 values widened to ``cfg.dtype`` is rescaled in fp32 (a bf16 scale
    would add a systematic per-channel error), then cast: ``x @ (q·s)ᵀ ==
    (x @ qᵀ)·s`` for a per-channel scale. Row-parallel (``tp`` set, as
    ``Dense``), the rescaled fp32 partial products are summed over the
    group before the cast; the scale is whole on every rank."""

    tp = None
    role = None

    def __init__(self, n_in: int, n_out: int, cfg: TransformerConfig):
        super().__init__()
        self.compute_dtype = cfg.dtype
        self.in_features, self.out_features = n_in, n_out
        self.weight_q = nn.Parameter(torch.empty(n_out, n_in,
                                                 dtype=torch.int8),
                                     requires_grad=False)
        self.weight_scale = nn.Parameter(torch.empty(n_out,
                                                     dtype=torch.float32),
                                         requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight_q.to(self.compute_dtype)).float()
        y = y * self.weight_scale
        if self.tp is not None:
            y = self.tp.reduce(y)
        return y.to(self.compute_dtype)


def _dense_class(cfg: TransformerConfig, int8: bool):
    """The projection module of a layer: ``W8Dense`` for int8 serving
    weights, else ``Int8Dense`` where the int8 recipe covers the layer,
    else ``Dense``."""
    if cfg.serve_int8_weights:
        return W8Dense
    return Int8Dense if int8 else Dense


class Attention(nn.Module):
    """Self-attention over the ``model`` axis ``tp`` when a layout sets it
    (``shard_heads``): the rank runs its own query heads (``own_q``) or all
    of them, against its own kv heads (``own_kv``) or all of them; a head
    count the axis does not divide comes gathered whole
    (``TensorParallel.fit``). Where the rank runs its own query heads
    against every kv head, ``kv_index`` names the kv head each reads.

    On a ``seq`` axis > 1 (``seq_mesh``, which a layout sets: the rank
    holds one chunk of the sequence, at its global positions)
    ``attn_impl`` "ring" and "ulysses" run ``parallel/ring.py``'s and
    ``parallel/ulysses.py``'s attention on the rank's chunk and heads,
    after the reference's non-heads-leading path: k/v repeated to the
    query heads, the projections bf16 even under ``attn_int8``; "xla" and
    "flash", where the reference lets XLA reshard, gather q/k/v (and the
    segments) whole over ``seq``, run the causal attention whole on every
    rank of it and keep the rank's rows. Off a ``seq`` axis ring and
    ulysses are the plain attention, as the reference's."""

    #: the ``model`` axis of a laid-out model (None: every head here)
    tp = None
    #: the mesh whose ``seq`` axis splits the sequence (None: the whole
    #: sequence is here)
    seq_mesh = None
    own_q = own_kv = True
    #: a column-parallel ``wqkv`` holds q_r | k_r | v_r (a serving
    #: layout's compact rows) rather than a block of the q | k | v rows
    #: (the reference's order: its product is gathered whole)
    compact = False
    kv_index = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        # decode and the sequence-parallel paths keep bf16 projections
        # under attn_int8, as the reference's
        dense = _dense_class(cfg, cfg.attn_int8 and not cfg.decode
                             and cfg.attn_impl in ("xla", "flash"))
        if cfg.fused_qkv:
            self.wqkv = dense(cfg.d_model,
                              (cfg.n_heads + 2 * cfg.n_kv_heads) * hd, cfg)
        else:
            self.wq = dense(cfg.d_model, cfg.n_heads * hd, cfg)
            self.wk = dense(cfg.d_model, cfg.n_kv_heads * hd, cfg)
            self.wv = dense(cfg.d_model, cfg.n_kv_heads * hd, cfg)
        self.wo = dense(cfg.n_heads * hd, cfg.d_model, cfg)

    def shard_heads(self, tp, own_q: bool, own_kv: bool,
                    compact: bool = False) -> None:
        """Run on the ``model`` axis ``tp`` (``parallel/sharded.py``)."""
        cfg = self.cfg
        self.tp, self.own_q, self.own_kv = tp, own_q, own_kv
        self.compact = compact
        self._kv_index = {}
        if own_q and not own_kv:
            h = cfg.n_heads // tp.size
            rep = cfg.n_heads // cfg.n_kv_heads
            self.kv_index = tuple((tp.rank * h + i) // rep for i in range(h))

    def _kv(self, t: torch.Tensor) -> torch.Tensor:
        """Keys or values ``[B, L, Hkv, Dh]`` as the rank's query heads read
        them: one kv head per query head where ``kv_index`` names them."""
        if self.kv_index is None:
            return t
        idx = self._kv_index.get(t.device)
        if idx is None:
            idx = self._kv_index[t.device] = torch.tensor(
                self.kv_index, device=t.device)
        return t.index_select(2, idx)

    def _project(self, x: torch.Tensor):
        """q ``[B, L, h, Dh]``, k, v ``[B, L, hkv, Dh]``: the rank's heads
        (all of them off a mesh). The fused weight is one product, cut on
        the head axis as the reference's ``_FusedQKVProj``."""
        cfg = self.cfg
        b, l, _ = x.shape
        hd = cfg.head_dim
        tp = self.tp
        widths = (cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd)
        if tp is None and cfg.fused_qkv:
            qkv = self.wqkv(x).view(b, l, -1, hd)
            h, hk = cfg.n_heads, cfg.n_kv_heads
            return qkv[:, :, :h], qkv[:, :, h:h + hk], qkv[:, :, h + hk:]
        if tp is None:
            return (self.wq(x).view(b, l, -1, hd),
                    self.wk(x).view(b, l, -1, hd),
                    self.wv(x).view(b, l, -1, hd))
        n = tp.size
        if cfg.fused_qkv:
            y = self.wqkv(tp.fit(x, _in_width(self.wqkv, n)))
            if y.shape[-1] != sum(widths) and not self.compact:
                y = tp.gather(y)
            m = sum(widths) // y.shape[-1]
            q, k, v = y.split([w // m for w in widths], dim=-1)
        else:
            q, k, v = (p(tp.fit(x, _in_width(p, n)))
                       for p in (self.wq, self.wk, self.wv))
        q = tp.fit(q, widths[0] // n if self.own_q else widths[0])
        k = tp.fit(k, widths[1] // n if self.own_kv else widths[1])
        v = tp.fit(v, widths[2] // n if self.own_kv else widths[2])
        return q.view(b, l, -1, hd), k.view(b, l, -1, hd), v.view(b, l, -1, hd)

    def forward(self, x: torch.Tensor, pos: Positions,
                cache: Optional[KVCache] = None,
                segments: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, l, _ = x.shape
        q, k, v = self._project(x)
        if pos.cos is not None:
            q = _rope_rotate(q, pos.cos, pos.sin)
            k = _rope_rotate(k, pos.cos, pos.sin)
        if cache is not None:
            out = self._cached_attention(q, k, v, pos, cache)
        elif self.cfg.attn_impl in ("ring", "ulysses"):
            if segments is not None:
                raise ValueError("segment-masked attention is a packed-window "
                                 "TRAINING feature (xla/flash paths only)")
            out = self._sequence_attention(q, self._kv(k), self._kv(v))
        elif self.seq_mesh is not None:
            out = self._gathered_attention(q, self._kv(k), self._kv(v),
                                           segments)
        else:
            out = self._attention_bhld(q, self._kv(k), self._kv(v), segments)
        out = out.reshape(b, l, -1)
        tp = self.tp
        if tp is None:
            return self.wo(out)
        y = self.wo(tp.fit(out, _in_width(self.wo, tp.size)))
        return tp.fit(y, x.shape[-1])

    def _attention_bhld(self, q, k, v, segments) -> torch.Tensor:
        """The training path's attention, as the reference's
        ``_attention_bhld``: q/k/v ``[B, L, H, Dh]`` read as heads-leading
        views. ``attn_impl="flash"`` runs the differentiable flash kernels
        on Hkv-head k/v (``attn_native_gqa``) or on k/v repeated to H heads;
        ``"xla"`` repeats k/v and runs ``xla_attention_bhld``. Autograd sums
        the gradients of a repeat. Returns ``[B, L, H, Dh]``."""
        cfg = self.cfg
        rep = q.shape[2] // k.shape[2]
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

    def _sequence_attention(self, q, k, v) -> torch.Tensor:
        """``attn_impl`` "ring" or "ulysses" on ``[B, L, h, Dh]`` q and
        ``[B, L, hkv, Dh]`` k/v: k/v repeated to the query heads (as the
        reference's ``jnp.repeat``, laid out heads-leading as the plain
        path lays them, so a ring of one is that path), then the rank's
        chunk through ``ring_attention_shard`` or
        ``ulysses_attention_shard`` over ``seq_mesh``; off a ``seq`` axis
        the plain attention."""
        rep = q.shape[2] // k.shape[2]
        k, v = (t.transpose(1, 2).repeat_interleave(rep, dim=1).transpose(1, 2)
                for t in (k, v))
        if self.seq_mesh is None:
            return plain_attention(q, k, v, True)
        if self.cfg.attn_impl == "ring":
            return ring_attention_shard(q, k, v, True, mesh=self.seq_mesh)
        return ulysses_attention_shard(q, k, v, True, mesh=self.seq_mesh,
                                       n_heads=self.cfg.n_heads)

    def _gathered_attention(self, q, k, v, segments) -> torch.Tensor:
        """``attn_impl`` "xla" or "flash" on a ``seq`` axis: q/k/v and the
        segments gathered whole over it, the attention run whole, and the
        rank's rows kept (the gradients summed back to the rank that holds
        each chunk: ``sharded.gather``)."""
        from tpu_on_k8s_torch.parallel.sharded import gather

        seq = MeshAxis(self.seq_mesh, AXIS_SEQ)
        q, k, v = (gather(t, seq, 1) for t in (q, k, v))
        if segments is not None:
            segments = seq.all_gather(segments, 1)
        return seq.own(self._attention_bhld(q, k, v, segments), 1)

    def _cached_attention(self, q, k, v, pos: Positions,
                          cache: KVCache) -> torch.Tensor:
        """Append this call's keys/values at the cache cursor (in place),
        then attend. A multi-token call into an empty cache whose positions
        are the plain ``arange`` (how ``generate`` starts) attends among its
        own L tokens through ``flash_attention`` with Hkv-head k/v; every
        other call attends over the whole cache. A multislot call
        (``pos.multislot``: the root's ``decode_multislot``) appends at
        each row's own positions and always attends over the cache, as the
        reference does."""
        if pos.multislot:
            _append_per_row(k, v, pos.ids, cache)
            return self._over_cache(q, pos.ids, cache)
        l = q.shape[1]
        start = cache.index
        if start + l > cache.k.shape[1]:
            raise ValueError(f"cache overflow: {start} + {l} positions > "
                             f"cache length {cache.k.shape[1]}")
        for dst, new in cache.writes(k, v):
            dst[:, start:start + l] = new
        cache.index = start + l
        if l > 1 and start == 0 and pos.is_arange:
            return flash_attention(q, self._kv(k), self._kv(v), causal=True)
        return self._over_cache(q, pos.ids, cache)

    def _over_cache(self, q: torch.Tensor, positions: torch.Tensor,
                    cache: KVCache) -> torch.Tensor:
        """Attend over the whole cache, masked to ≤ query position — right
        for any cursor. q is scaled in fp32 before the dot, masked scores
        are -1e30, and probabilities are cast to q's dtype before the V
        product, as in the reference's ``over_cache``. The ``rep`` query
        heads of a kv head are stacked as rows, so both products are plain
        batched matmuls over (B, Hkv): no repeated K/V is made. An int8
        cache is read dequantized to ``cfg.dtype`` (``KVCache.read``)."""
        b, l, h, hd = q.shape
        kc, vc = (self._kv(t) for t in cache.read(self.cfg.dtype))
        hkv = kc.shape[2]
        rep = h // hkv
        qg = (q.float() * hd ** -0.5).view(b, l, hkv, rep, hd)
        qg = qg.permute(0, 2, 3, 1, 4).reshape(b, hkv, rep * l, hd)
        kc = kc.transpose(1, 2).to(torch.float32,
                                   memory_format=torch.contiguous_format)
        logits = torch.matmul(qg, kc.transpose(-1, -2))  # [B, Hkv, rep·l, max]
        k_pos = torch.arange(cache.k.shape[1], device=q.device)
        mask = k_pos <= positions.repeat(1, rep)[:, None, :, None]
        probs = torch.softmax(torch.where(mask, logits, NEG_INF), dim=-1)
        out = torch.matmul(probs.to(q.dtype), vc.transpose(1, 2))
        return out.view(b, hkv, rep, l, hd).permute(0, 3, 1, 2, 4).reshape(
            b, l, h, hd)


def _replicated_like(x: torch.Tensor, ref: DTensor) -> DTensor:
    """``x``, which every rank of ``ref``'s mesh holds alike, as a
    replicated ``DTensor`` there: its gradient is summed over the mesh."""
    return DTensor.from_local(x, ref.device_mesh,
                              [Replicate()] * ref.device_mesh.ndim,
                              run_check=False)


def _embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The embedding gather. A vocab-sharded table (a ``DTensor`` over the
    ``model`` axis) gathers its rows where they live and sums the
    partial rows over the axis (each row lives on one rank, the others add
    zeros): the full rows, exact."""
    if isinstance(table, DTensor):
        return F.embedding(_replicated_like(tokens, table),
                           table).full_tensor()
    return F.embedding(tokens, table)


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """fp32 logits ``x @ head`` for a head ``[D, V]``. A vocab-sharded head
    makes its V/model columns on each rank and gathers them over the
    ``model`` axis, so the loss reads the whole row as off a mesh; x's
    gradient is summed over the axis."""
    if isinstance(head, DTensor):
        return torch.matmul(_replicated_like(x, head).float(),
                            head.float()).full_tensor()
    return torch.matmul(x.float(), head.float())


def _rows_of(x: torch.Tensor, head: torch.Tensor, rows) -> torch.Tensor:
    """``x``'s columns that meet a head ``[D, V]`` of this rank's hidden rows
    (``rows``: the head's ``model`` axis; None: the head is whole)."""
    return x if rows is None else rows.fit(x, head.shape[0])


def _append_per_row(k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor, cache: KVCache) -> None:
    """The multislot append: row b's keys/values ``[B, l, Hkv, Dh]`` land at
    ``positions[b]`` ``[B, l]`` of its own cache row, in place;
    ``cache.index`` is not touched. A position at or past the cache length
    (the free-slot sentinel ``max_len``, a horizon's steps past a request's
    end, a verify chunk's columns past column 0 on an undrafted row) writes
    nothing, as the reference's ``mode="drop"``: its write is aimed at the
    last position and carries the bytes there (an int8 cache's scales
    too). Columns are written one at a time, in order: the rows of one
    column are distinct, so no index repeats within a write, and a dropped
    write carries what an earlier column just wrote there. All on the
    device, with no host sync."""
    b, l = positions.shape
    length = cache.k.shape[1]
    keep = positions < length
    idx = positions.clamp(max=length - 1).long()
    rows = torch.arange(b, device=positions.device)
    writes = cache.writes(k, v)
    for j in range(l):
        for dst, new in writes:
            kept = keep[:, j].view(b, *(1,) * (new.dim() - 2))
            dst[rows, idx[:, j]] = torch.where(kept, new[:, j],
                                               dst[:, length - 1])


class MLP(nn.Module):
    """SwiGLU; ``mlp_fused_gateup`` keeps one [2·d_ff, D] gate+up weight
    (gate first), the layout of the reference's ``w_gateup`` kernel.
    ``activation="gelu"`` is the GPT-2 MLP: ``w_down(gelu(w_up(x)))`` with
    the tanh form of GELU, flax's ``nn.gelu`` default. On the ``model``
    axis ``tp`` (``shard``) the hidden activation is fitted to what
    ``w_down`` takes (the rank's block, or gathered whole), and a
    column-parallel ``w_gateup`` in the reference's row order is gathered
    whole first (``compact``: it holds gate_r | up_r)."""

    tp = None
    compact = False

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.d_ff = cfg.d_ff
        self.gelu = cfg.activation == "gelu"
        self.fused = cfg.mlp_fused_gateup and not self.gelu
        dense = _dense_class(cfg, cfg.mlp_int8)
        if self.gelu:
            self.w_up = dense(cfg.d_model, cfg.d_ff, cfg)
        elif self.fused:
            self.w_gateup = dense(cfg.d_model, 2 * cfg.d_ff, cfg)
        else:
            self.w_gate = dense(cfg.d_model, cfg.d_ff, cfg)
            self.w_up = dense(cfg.d_model, cfg.d_ff, cfg)
        self.w_down = dense(cfg.d_ff, cfg.d_model, cfg)

    def shard(self, tp, compact: bool = False) -> None:
        """Run on the ``model`` axis ``tp`` (``parallel/sharded.py``)."""
        self.tp, self.compact = tp, compact

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None:
            if self.gelu:
                return self.w_down(F.gelu(self.w_up(x), approximate="tanh"))
            if self.fused:
                gate, up = self.w_gateup(x).split(self.d_ff, dim=-1)
            else:
                gate, up = self.w_gate(x), self.w_up(x)
            return self.w_down(F.silu(gate) * up)
        n = tp.size
        width = _in_width(self.w_down, n)

        def project(p):
            return p(tp.fit(x, _in_width(p, n)))

        if self.gelu:
            h = F.gelu(tp.fit(project(self.w_up), width), approximate="tanh")
        else:
            if self.fused:
                y = project(self.w_gateup)
                if y.shape[-1] != 2 * self.d_ff and not self.compact:
                    y = tp.gather(y)
                gate, up = y.chunk(2, dim=-1)
            else:
                gate, up = project(self.w_gate), project(self.w_up)
            h = F.silu(tp.fit(gate, width)) * tp.fit(up, width)
        return tp.fit(self.w_down(h), x.shape[-1])


#: The products with no batch dimension, the reference's
#: ``dots_with_no_batch_dims_saveable`` dots: the dense ``mm`` (and
#: ``addmm``) and the ``int8_impl="xla"`` route's ``_int_mm``. Batched
#: products (``bmm``: the plain attention's) are not among them.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten._int_mm.default)
#: The hand-written kernels a training forward runs, as operators: the
#: flash forward (o and lse) and the int8 GEMM, the reference's
#: ``pallas_call``s.
_KERNELS = (torch.ops.tpu_on_k8s_torch.flash_fwd.default,
            torch.ops.tpu_on_k8s_torch.int8_matmul.default)


def _mlp_remat_policy(width: int):
    """The policy of the MLP's selective checkpoint (``remat_policy="mlp"``):
    save the outputs of the dots that read the MLP's input (gate and up, the
    fused gate+up, or GELU's up: their first operand is ``width`` wide),
    recompute everything else, as the reference's MLP ``nn.remat`` with
    ``dots_with_no_batch_dims_saveable`` keeps its dot outputs. The
    backward then re-runs only the activation, the product and the bias
    adds (and the int8 quantization and epilogue), never a dot: a bias is
    added after its product (``Dense``), so an ``addmm`` whose first
    operand is the bias never reaches the policy. The int8 kernel is no
    dot, so its gate and
    up products run again, as a ``pallas_call`` does there. ``w_down``'s
    output is not read by the backward: its product (a dense ``mm``, or
    ``int8_matmul``'s ``_Int8Product``) runs after the last tensor the
    recompute needs is saved, so the recompute stops before it."""
    def policy(ctx, op, *args, **kwargs):
        if (op in _DOTS and args[0].shape[-1] == width
                and not moe.in_batched_products()):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _dots_remat_policy(kernels: bool):
    """The policy of a block's selective checkpoint under
    ``remat_policy="dots"`` (``kernels=False``: the outputs of every
    product with no batch dimension are saved, the hand-written kernels'
    recomputed) or ``"dots_kernels"`` (the kernels' outputs saved too: the
    flash forward's o and lse and the int8 GEMM's output), the reference's
    ``dots_with_no_batch_dims_saveable`` and ``_dots_and_kernels_saveable``.
    Everything else is recomputed, the MoE's products batched over its
    experts too (``moe.batched_products``: an expert's int8 product runs as
    a 2-D operator, but the reference's batched product has a batch
    dim)."""
    saved = _DOTS + _KERNELS if kernels else _DOTS

    def policy(ctx, op, *args, **kwargs):
        if op in saved and not moe.in_batched_products():
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def _block_remat_context(cfg: TransformerConfig):
    """The ``context_fn`` of a whole block's checkpoint: the selective
    policy for ``remat_policy`` "dots" and "dots_kernels", none for any
    other ("full": everything recomputed, as the reference's ``nn.remat``
    without a policy)."""
    if cfg.remat_policy in ("dots", "dots_kernels"):
        return functools.partial(
            create_selective_checkpoint_contexts,
            _dots_remat_policy(cfg.remat_policy == "dots_kernels"))
    return noop_context_fn


class Block(nn.Module):
    """Pre-norm block. With ``remat`` and ``remat_policy="mlp"`` the MLP is
    checkpointed selectively in the backward pass while the attention's
    residuals stay (the reference's MLP-only ``nn.remat`` with
    ``dots_with_no_batch_dims_saveable``): the outputs of the gate and up
    products are kept, the rest of the MLP is recomputed. With
    ``n_experts > 0`` the MLP is ``moe.MoEMLP`` (``self.moe``), checkpointed
    alike under "mlp": of its products only the router's has no batch dim
    and is kept.

    ``forward(x, pos, cache, segments)`` returns the block's output; with
    ``with_aux=True`` the pair (output, the MoE's load-balance loss, None
    for a dense block)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.remat_mlp = cfg.remat and cfg.remat_policy == "mlp"
        self.remat_context = functools.partial(
            create_selective_checkpoint_contexts,
            _mlp_remat_policy(cfg.d_model))
        self.attn_norm = make_norm(cfg)
        self.attn = Attention(cfg)
        self.mlp_norm = make_norm(cfg)
        if cfg.n_experts > 0:
            self.moe = moe.MoEMLP(cfg)
        else:
            self.mlp = MLP(cfg)

    def forward(self, x: torch.Tensor, pos: Positions,
                cache: Optional[KVCache] = None,
                segments: Optional[torch.Tensor] = None,
                with_aux: bool = False):
        h = x + self.attn(self.attn_norm(x), pos, cache, segments)
        y = self.mlp_norm(h)
        mlp = self.moe if hasattr(self, "moe") else self.mlp
        if self.remat_mlp and torch.is_grad_enabled():
            y = checkpoint(mlp, y, use_reentrant=False,
                           context_fn=self.remat_context)
        else:
            y = mlp(y)
        y, aux = y if isinstance(y, tuple) else (y, None)
        return (h + y, aux) if with_aux else h + y


class Transformer(nn.Module):
    """Decoder-only LM. ``forward(tokens [B, L], positions, cache,
    segments, at)`` → fp32 logits ``[B, L, vocab]``, or ``[B, 1, vocab]``
    with ``at [B]``: each row's logits at its own position only (a prompt's
    last token, or a padded prompt's last real one);
    ``features`` → the final-norm hidden states and the head ``[D, V]`` in
    ``cfg.dtype`` for the chunked loss; ``extend_cache`` → the cache's
    appends alone, without the head. With ``tie_embeddings`` the head is
    ``embed`` cast to ``cfg.dtype`` and transposed (full precision also
    under ``serve_int8_weights``), so ``embed``'s gradient sums the
    gather's and the head's. With ``pos_emb="learned"`` the table
    ``pos_embed [max_seq_len, D]`` is gathered at each call's positions
    and added to the token embeddings in fp32, before the cast. A serving
    model laid out by ``parallel/sharded.shard_serving_model`` may hold
    its rank's vocab rows of ``embed`` and columns of the head, gathered
    over ``embed_tp`` and ``head_tp`` (plain tensors and explicit
    collectives).

    With ``cfg.decode`` every call takes one ``KVCache`` per layer (build it
    with ``decode.decode_model``); otherwise no cache, and ``segments
    [B, L]`` restrict attention to packed documents. ``remat`` checkpoints
    each whole block (``torch.utils.checkpoint``, non-reentrant) under
    ``remat_policy`` "full" (all of it recomputed in the backward pass),
    "dots" (the outputs of products with no batch dimension saved) and
    "dots_kernels" (the hand-written kernels' outputs saved too); "mlp"
    checkpoints only the MLP (``Block``).

    ``with_aux=True`` (``forward`` and ``features``) also returns the MoE
    blocks' load-balance losses summed in block order (the reference's sum
    over the ``losses`` collection), an fp32 0-d tensor: 0 for a dense
    model."""

    #: the vocab-parallel groups of a serving model's embedding and head
    #: (``parallel/sharded.shard_serving_model``; None: held whole), and
    #: the group a head split on its hidden dim sums its partial logits
    #: over
    embed_tp = None
    head_tp = None
    head_row_tp = None

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        if cfg.serve_int8_weights and not cfg.decode:
            raise ValueError("serve_int8_weights is a serving (decode) "
                             "recipe; training keeps bf16 weights")
        check_supported(cfg)
        self.cfg = cfg
        self.remat_context = _block_remat_context(cfg)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=cfg.param_dtype))
        if cfg.pos_emb == "learned":
            self.pos_embed = nn.Parameter(torch.empty(
                cfg.max_seq_len, cfg.d_model, dtype=cfg.param_dtype))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layers))
        self.final_norm = make_norm(cfg)
        if cfg.tie_embeddings:
            pass                # the head is the embedding table
        elif cfg.serve_int8_weights:
            self.lm_head_q = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab_size, dtype=torch.int8),
                requires_grad=False)
            self.lm_head_scale = nn.Parameter(
                torch.empty(cfg.vocab_size, dtype=torch.float32),
                requires_grad=False)
        else:
            self.lm_head = nn.Parameter(torch.empty(
                cfg.d_model, cfg.vocab_size, dtype=cfg.param_dtype))

    def tensor_parallel(self, tp_mesh) -> None:
        """What ``shard_model`` does over a ``model`` axis > 1:
        ``parallel/sharded.tensor_parallel``."""
        from tpu_on_k8s_torch.parallel.sharded import tensor_parallel
        tensor_parallel(self, tp_mesh)

    def split_sequence(self, mesh) -> None:
        """What ``shard_model`` does over a ``seq`` axis > 1: every block's
        attention runs on the rank's chunk of the sequence over ``mesh``'s
        ``seq`` axis (``Attention.seq_mesh``), and every MoE block routes
        over the whole sequence (``moe.MoEMLP.seq``)."""
        for block in self.blocks:
            block.attn.seq_mesh = mesh
            if hasattr(block, "moe"):
                block.moe.seq = MeshAxis(mesh, AXIS_SEQ)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[List[KVCache]] = None,
                segments: Optional[torch.Tensor] = None,
                at: Optional[torch.Tensor] = None, with_aux: bool = False):
        cfg = self.cfg
        x, aux = self._trunk(tokens, positions, cache, segments)
        if at is not None:
            x = x[torch.arange(x.shape[0], device=x.device), at][:, None]
        # fp32 logits from the cfg.dtype (or int8) head: products of bf16
        # and int8 values are exact in fp32, so this is the reference's
        # fp32-accumulated einsum.
        rows = self.head_row_tp
        if cfg.serve_int8_weights and not cfg.tie_embeddings:
            head = self.lm_head_q
            logits = torch.matmul(_rows_of(x, head, rows).float(),
                                  head.float())
            if rows is not None:
                logits = rows.reduce(logits)
            logits = logits * self.lm_head_scale
        elif cfg.head_int8:
            head, mm = self._head(), _int8_mm(cfg.int8_impl)
            if isinstance(head, DTensor):
                logits = _int8_on_blocks(mm, _replicated_like(x, head),
                                         head.t(), torch.float32
                                         ).full_tensor()
            else:
                logits = mm(_rows_of(x, head, rows), head.t(), torch.float32,
                            **_row_sums(rows))
        else:
            head = self._head()
            logits = _logits(_rows_of(x, head, rows), head)
            if rows is not None:
                logits = rows.reduce(logits)
        # a vocab-parallel serving head made this rank's V/model columns
        if self.head_tp is not None:
            logits = self.head_tp.gather(logits)
        return (logits, _aux_value(aux, x)) if with_aux else logits

    def extend_cache(self, tokens: torch.Tensor, positions: torch.Tensor,
                     cache: List[KVCache]) -> None:
        """Append ``tokens``' keys/values to ``cache`` as ``forward`` does,
        without the head: a speculative draft's prefill and its last feed,
        whose logits nobody reads."""
        self._trunk(tokens, positions, cache, None)

    def features(self, tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 segments: Optional[torch.Tensor] = None,
                 with_aux: bool = False):
        """(final-norm hidden states ``[B, L, D]``, head ``[D, V]``), both
        in ``cfg.dtype``: what ``chunked_cross_entropy`` takes. The int8
        serving head is the pair (``lm_head_q``, ``lm_head_scale``), as the
        reference returns it. ``with_aux=True`` adds the load-balance loss
        as a third element."""
        x, aux = self._trunk(tokens, positions, None, segments)
        if self.cfg.serve_int8_weights and not self.cfg.tie_embeddings:
            head = (self.lm_head_q, self.lm_head_scale)
        else:
            head = self._head()
        return (x, head, _aux_value(aux, x)) if with_aux else (x, head)

    def _head(self) -> torch.Tensor:
        """The head ``[D, V]`` in ``cfg.dtype``: the tied embedding table,
        transposed, or ``lm_head``."""
        if self.cfg.tie_embeddings:
            return self.embed.to(self.cfg.dtype).t()
        return self.lm_head.to(self.cfg.dtype)

    def _trunk(self, tokens, positions, cache, segments):
        cfg = self.cfg
        if cfg.decode:
            if cache is None or len(cache) != len(self.blocks):
                raise ValueError("the serving model needs one KVCache per "
                                 "layer (decode.init_cache)")
            if segments is not None:
                raise ValueError("segment-masked attention is a "
                                 "packed-window training feature")
            if cache[0].int8 != cfg.cache_int8:
                raise ValueError(
                    f"an {'int8' if cache[0].int8 else 'unquantized'} cache "
                    f"does not match cache_int8={cfg.cache_int8} "
                    f"(decode.init_cache)")
        elif cache is not None:
            raise ValueError("the training model (decode=False) takes no "
                             "cache")
        learned = cfg.pos_emb == "learned"
        if learned and not cfg.decode and tokens.shape[1] > cfg.max_seq_len:
            raise ValueError(f"sequence {tokens.shape[1]} exceeds the learned "
                             f"position table ({cfg.max_seq_len})")
        arange = torch.arange(tokens.shape[1], dtype=torch.int32,
                              device=tokens.device).expand_as(tokens)
        if positions is None:
            positions = arange
        is_arange = (cfg.decode and not cfg.decode_multislot
                     and tokens.shape[1] > 1
                     and torch.equal(positions.int(), arange))
        multislot = cfg.decode_multislot
        if learned:
            pos = Positions(positions, None, None, is_arange, multislot)
        else:
            cos, sin = _rope_tables(positions, cfg.head_dim // 2,
                                    cfg.rope_theta)
            pos = Positions(positions, cos[:, :, None, :], sin[:, :, None, :],
                            is_arange, multislot)
        # an fp32 gather from the master table, then the cast
        x = (_embed(tokens, self.embed) if self.embed_tp is None
             else self.embed_tp.embed(tokens, self.embed))
        if learned:
            # A multislot step's free slots sit at the sentinel max_len (a
            # horizon's or a verify chunk's later columns past it): their
            # rows gather the last position, their appends write nothing
            # and their logits are discarded. The reference's gather fills
            # such rows with NaN; out of range, a CUDA gather would trap.
            ids = (positions.clamp(max=cfg.max_seq_len - 1)
                   if cfg.decode_multislot else positions)
            x = x.float() + F.embedding(ids.long(), self.pos_embed).float()
        x = x.to(cfg.dtype)
        remat_block = (cfg.remat and cfg.remat_policy != "mlp"
                       and torch.is_grad_enabled())
        aux = None
        for i, block in enumerate(self.blocks):
            if remat_block:
                x, a = checkpoint(block, x, pos, None, segments,
                                  use_reentrant=False,
                                  context_fn=self.remat_context,
                                  with_aux=True)
            else:
                x, a = block(x, pos, cache[i] if cache is not None else None,
                             segments, with_aux=True)
            if a is not None:
                aux = a if aux is None else aux + a
        return self.final_norm(x), aux


def _aux_value(aux: Optional[torch.Tensor], x: torch.Tensor
               ) -> torch.Tensor:
    """The blocks' summed load-balance loss, or an fp32 0 where no block
    is an MoE block."""
    return x.new_zeros((), dtype=torch.float32) if aux is None else aux


def flagship_partition_rules() -> List[PartitionRule]:
    """The reference's Megatron-layout rules on the port's names. A port
    weight is ``[out, in]``, the transpose of a reference ``kernel [L, in,
    out]`` without the layer axis, so each projection's spec is the
    reference's reversed: column-parallel ``wq``/``wk``/``wv``/``wqkv`` and
    ``w_gate``/``w_up``/``w_gateup`` put ``model`` on the output rows (dim
    0) and ``fsdp`` on the input (dim 1); row-parallel ``wo`` and
    ``w_down`` the other way round. ``embed [V, D]`` keeps (model, fsdp),
    ``lm_head [D, V]`` (fsdp, model), ``pos_embed`` (None, fsdp); norms and
    everything else are replicated. The MoE's stacked ``moe.router [D,
    E]``, ``moe.w_gate``/``moe.w_up [E, D, F]`` and ``moe.w_down [E, F,
    D]`` keep the reference's layouts, so their rules are the reference's
    with the layer axis dropped: experts over ``expert``, then Megatron
    within each expert."""
    return [
        # attention: qkv column-parallel, output row-parallel
        PartitionRule(r"attn\.w[qkv]\.weight", (AXIS_MODEL, AXIS_FSDP)),
        PartitionRule(r"attn\.wqkv\.weight", (AXIS_MODEL, AXIS_FSDP)),
        PartitionRule(r"attn\.wo\.weight", (AXIS_FSDP, AXIS_MODEL)),
        # mlp: gate/up column-parallel, down row-parallel
        PartitionRule(r"mlp\.w_(gate|up|gateup)\.weight",
                      (AXIS_MODEL, AXIS_FSDP)),
        PartitionRule(r"mlp\.w_down\.weight", (AXIS_FSDP, AXIS_MODEL)),
        # MoE: experts over the expert axis, then megatron within each expert
        PartitionRule(r"moe\.router", (AXIS_FSDP, None)),
        PartitionRule(r"moe\.w_(gate|up)$", (AXIS_EXPERT, AXIS_FSDP,
                                              AXIS_MODEL)),
        PartitionRule(r"moe\.w_down$", (AXIS_EXPERT, AXIS_MODEL, AXIS_FSDP)),
        # embeddings: vocab-parallel over model, hidden over fsdp
        PartitionRule(r"(^|/)embed$", (AXIS_MODEL, AXIS_FSDP)),
        PartitionRule(r"pos_embed", (None, AXIS_FSDP)),
        PartitionRule(r"lm_head", (AXIS_FSDP, AXIS_MODEL)),
        # norms and everything else: replicated (listed for clarity)
        PartitionRule(r"norm\.scale", ()),
    ]


def serving_partition_rules(int8: bool = False) -> List[PartitionRule]:
    """The serving rule set: the flagship layout, extended for the W8A16
    tree when ``int8``. A quantized projection's ``weight_q`` rides its
    weight's rule (``re.search``); its per-output-channel ``weight_scale
    [out]`` is sharded like the weight's output dim (``model`` for
    column-parallel projections, ``fsdp`` for row-parallel ones), so the
    scale rules come first; ``lm_head_scale [V]`` shards with the vocab."""
    rules: List[PartitionRule] = []
    if int8:
        rules += [
            PartitionRule(r"attn\.w[qkv]\.weight_scale", (AXIS_MODEL,)),
            PartitionRule(r"attn\.wqkv\.weight_scale", (AXIS_MODEL,)),
            PartitionRule(r"mlp\.w_(gate|up|gateup)\.weight_scale",
                          (AXIS_MODEL,)),
            PartitionRule(r"attn\.wo\.weight_scale", (AXIS_FSDP,)),
            PartitionRule(r"mlp\.w_down\.weight_scale", (AXIS_FSDP,)),
            PartitionRule(r"lm_head_scale", (AXIS_MODEL,)),
        ]
    return rules + flagship_partition_rules()
