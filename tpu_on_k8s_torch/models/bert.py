"""BERT-family bidirectional encoder with an MLM head: the counterpart of
``tpu_on_k8s/models/bert.py``.

``BertConfig`` (``base``, ``tiny``), ``EncoderBlock``, ``Bert``,
``bert_partition_rules`` and ``mlm_loss``. Post-LN blocks; every
projection has a bias (the port's ``Dense``: stored in ``param_dtype``,
computed in ``dtype``, the bias added after the product); the exact (erf)
GELU; flax's ``LayerNorm`` (``models/transformer.py``) at ``norm_eps``;
token, position and type embeddings summed in fp32; the tied MLM head
``mlm_transform`` → GELU → ``mlm_norm``, then fp32 logits ``x · embedᵀ``
(``_logits``: bf16 products exact in fp32) plus ``mlm_bias``. ``remat``
checkpoints each block. A Python loop over per-layer blocks takes the
place of the reference's ``nn.scan``: the parameters are
``blocks.{i}.wq.weight [out, in]`` and so on (``params.from_jax_bert_params``
carries a reference tree across).

``attn_impl`` is ``"xla"`` (``xla_attention_bhld``: fp32 scores masked to
the fp32 minimum) or ``"flash"`` (``ops/flash_attention.py``'s
``flash_attention``, non-causal, whose forward and backward run the port's
CUDA kernels); any other value raises. A padding mask ``[B, L]`` (1 = a
real token) becomes segments as the reference builds them: real tokens 0,
the pad at position i ``-(i + 1)``, so each pad sees only itself and no
real token sees a pad.

On a mesh ``parallel/sharded.py``'s ``shard_model`` runs FSDP2 over data ×
fsdp, per block and at the root, on the dims the rules give ``fsdp``.
Over a ``model`` axis > 1 (``Bert.tensor_parallel``, the decoder's
machinery: ``sharded.parallelize_projections`` and ``vocab_parallel``)
``wq``/``wk``/``wv`` and ``w_fc`` are column parallel (their biases split
with their rows), ``wo`` and ``w_proj`` row parallel (their biases added
once, after the sum over ``model``); a rank runs its H/model heads, or,
where ``model`` does not divide the heads, every head on q/k/v gathered
whole, ``wo`` then taking its input columns of the whole output.
``mlm_transform`` is column parallel, its output gathered whole before the
GELU and ``mlm_norm``; ``embed`` is split on its vocab rows for the lookup
and the tied head (``models/transformer.py``'s ``_embed`` and
``_logits``), ``mlm_bias`` added to the gathered logits.

Over a ``seq`` axis > 1 (``split_sequence``) a rank runs one chunk of
every row (``seq_chunk``), at its global positions: each block's
attention gathers q/k/v and the segments whole over ``seq``, runs
non-causal attention whole and keeps the rank's rows, the gradients
summed back to the rank that holds each chunk (``sharded.gather``). The
reference has no ring or Ulysses attention for the encoder.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpu_on_k8s_torch.models.transformer import (
    Dense,
    LayerNorm,
    _embed,
    _in_width,
    _logits,
)
from tpu_on_k8s_torch.ops.flash_attention import (
    flash_attention,
    xla_attention_bhld,
)
from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    MeshAxis,
)
from tpu_on_k8s_torch.parallel.partition import PartitionRule

ATTN_IMPLS = ("xla", "flash")


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The reference's config, field for field, with ``torch.dtype``s."""

    vocab_size: int = 30522
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    type_vocab_size: int = 2
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = False
    attn_impl: str = "xla"

    #: every projection has a bias (what the port's ``Dense`` reads)
    use_bias = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                          d_ff=128, max_seq_len=128)


def padding_segments(attention_mask: torch.Tensor,
                     start: int = 0) -> torch.Tensor:
    """A padding mask ``[B, L]`` (1 = real token) as segments ``[B, L]``
    int32: real tokens share segment 0, the pad at position i gets
    ``-(i + 1)``; ``start``: the position of the mask's first column (a
    chunk of the sequence)."""
    idx = torch.arange(start, start + attention_mask.shape[1],
                       dtype=torch.int32,
                       device=attention_mask.device)[None, :]
    return torch.where(attention_mask.bool(), torch.zeros_like(idx),
                       -(idx + 1)).to(torch.int32)


def _attention(impl: str, q, k, v, segments) -> torch.Tensor:
    """Non-causal attention on ``[B, L, H, Dh]`` q, k, v."""
    if impl == "flash":
        return flash_attention(q, k, v, causal=False, segments=segments)
    out = xla_attention_bhld(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), False, segments)
    return out.transpose(1, 2)


class EncoderBlock(nn.Module):
    """Post-LN transformer encoder block (the BERT arrangement). On the
    ``model`` axis ``tp`` (``Bert.tensor_parallel``) it runs its own heads
    (``own_heads``) or every head gathered whole; with ``seq`` (a
    ``MeshAxis``, ``Bert.split_sequence``) its attention runs over the
    whole sequence gathered from the ranks' chunks."""

    #: the ``model`` axis of a laid-out encoder (None: every head here)
    tp = None
    own_heads = True

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.wq, self.wk, self.wv, self.wo = (Dense(d, d, cfg)
                                              for _ in range(4))
        self.attn_norm = LayerNorm(d, cfg.norm_eps, cfg.dtype)
        self.w_fc = Dense(d, cfg.d_ff, cfg)
        self.w_proj = Dense(cfg.d_ff, d, cfg)
        self.mlp_norm = LayerNorm(d, cfg.norm_eps, cfg.dtype)

    def forward(self, x: torch.Tensor,
                segments: Optional[torch.Tensor] = None,
                seq: Optional[MeshAxis] = None) -> torch.Tensor:
        """``seq``: the rank holds one chunk of the sequence over this
        axis (None: the whole sequence is here)."""
        cfg = self.cfg
        b, l, _ = x.shape
        tp = self.tp
        q, k, v = (w(x) for w in (self.wq, self.wk, self.wv))
        if tp is not None and not self.own_heads:
            q, k, v = (tp.gather(t) for t in (q, k, v))
        q, k, v = (t.view(b, l, -1, cfg.head_dim) for t in (q, k, v))
        if seq is None:
            attn = _attention(cfg.attn_impl, q, k, v, segments)
        else:
            attn = _gathered_attention(cfg.attn_impl, q, k, v, segments, seq)
        attn = attn.reshape(b, l, -1)
        if tp is not None:
            attn = tp.fit(attn, _in_width(self.wo, tp.size))
        x = self.attn_norm(x + self.wo(attn))
        # BERT's published activation is the exact (erf) gelu
        h = self.w_proj(F.gelu(self.w_fc(x)))
        return self.mlp_norm(x + h)


def _gathered_attention(impl: str, q, k, v, segments,
                        seq: MeshAxis) -> torch.Tensor:
    """The attention of a rank's chunk of the sequence: q/k/v (and the
    segments) gathered whole over ``seq``, non-causal attention on the whole
    sequence, the rank's rows kept (the gradients summed back to the rank
    that holds each chunk)."""
    from tpu_on_k8s_torch.parallel.sharded import gather

    q, k, v = (gather(t, seq, 1) for t in (q, k, v))
    if segments is not None:
        segments = seq.all_gather(segments, 1)
    return seq.own(_attention(impl, q, k, v, segments), 1)


class Bert(nn.Module):
    """``forward(tokens [B, L], type_ids [B, L]?, attention_mask [B, L]?)``
    → ``[B, L, vocab]`` fp32 MLM logits."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        if cfg.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {cfg.attn_impl!r} for "
                             f"Bert (use one of {ATTN_IMPLS})")
        self.cfg = cfg
        pdt = cfg.param_dtype
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=pdt))
        self.pos_embed = nn.Parameter(torch.empty(cfg.max_seq_len,
                                                  cfg.d_model, dtype=pdt))
        self.type_embed = nn.Parameter(torch.empty(cfg.type_vocab_size,
                                                   cfg.d_model, dtype=pdt))
        self.embed_norm = LayerNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.blocks = nn.ModuleList(EncoderBlock(cfg)
                                    for _ in range(cfg.n_layers))
        self.mlm_transform = Dense(cfg.d_model, cfg.d_model, cfg)
        self.mlm_norm = LayerNorm(cfg.d_model, cfg.norm_eps, cfg.dtype)
        self.mlm_bias = nn.Parameter(torch.empty(cfg.vocab_size, dtype=pdt))

    #: the ``seq`` axis whose ranks each hold a chunk of every row (None:
    #: rows are whole)
    seq = None

    def tensor_parallel(self, tp_mesh) -> None:
        """What ``shard_model`` does over a ``model`` axis > 1, in place
        (see the module docstring): the decoder's machinery on the
        encoder's projections and tables."""
        from tpu_on_k8s_torch.parallel.sharded import (
            TensorParallel,
            parallelize_projections,
            vocab_parallel,
        )
        tp = TensorParallel(tp_mesh)
        own = self.cfg.n_heads % tp.size == 0
        for block in self.blocks:
            parallelize_projections(block, tp_mesh, {
                name: proj for name, proj in block.named_children()
                if isinstance(proj, Dense)})
            block.tp, block.own_heads = tp, own
        # every rank reads the whole transform, so its gather's backward
        # keeps the rank's block of the (equal) gradients: no sum
        parallelize_projections(self, tp_mesh,
                                {"mlm_transform": self.mlm_transform},
                                gathered=True)
        vocab_parallel(self, tp_mesh)

    def split_sequence(self, mesh) -> None:
        """What ``shard_model`` does over a ``seq`` axis > 1: a call runs
        the rank's chunk of every row (``forward``'s ``seq_chunk``)."""
        self.seq = MeshAxis(mesh, AXIS_SEQ)

    def forward(self, tokens: torch.Tensor,
                type_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                seq_chunk: bool = True) -> torch.Tensor:
        """On a ``seq`` axis (``split_sequence``) the inputs are the
        rank's chunk of every row, chunk i of ``seq`` (i the rank's place on
        the axis), where ``seq_chunk``; with ``seq_chunk=False`` they are
        the whole rows, which every rank of the axis then runs alike."""
        cfg = self.cfg
        seq = self.seq if seq_chunk else None
        l = tokens.shape[1]
        start, whole = (0, l) if seq is None else (seq.rank * l, seq.size * l)
        if whole > cfg.max_seq_len:
            raise ValueError(f"sequence {whole} exceeds the position table "
                             f"({cfg.max_seq_len})")
        if type_ids is None:
            type_ids = torch.zeros_like(tokens)
        x = (_embed(tokens.long(), self.embed)
             + self.pos_embed[None, start:start + l]
             + F.embedding(type_ids.long(), self.type_embed))
        x = self.embed_norm(x)
        segments = (None if attention_mask is None
                    else padding_segments(attention_mask, start))
        for block in self.blocks:
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, segments, seq, use_reentrant=False)
            else:
                x = block(x, segments, seq)
        # MLM head: transform (dense + erf-gelu) + LN + the tied embedding
        x = self.mlm_norm(F.gelu(self.mlm_transform(x)))
        return _logits(x, self.embed.to(cfg.dtype).t()) + self.mlm_bias


def bert_partition_rules() -> List[PartitionRule]:
    """The reference's Megatron layout on the port's names: a weight
    ``[out, in]`` is the reference's ``kernel [L, in, out]`` transposed,
    without the layer axis, so each spec is the reference's reversed:
    ``wq``/``wk``/``wv`` and ``w_fc`` (model, fsdp), ``wo`` and ``w_proj``
    (fsdp, model), ``mlm_transform`` (model, fsdp); ``embed`` (model,
    fsdp), the position and type tables (None, fsdp); norms and biases
    replicated."""
    return [
        PartitionRule(r"\.w[qkv]\.weight", (AXIS_MODEL, AXIS_FSDP)),
        PartitionRule(r"\.wo\.weight", (AXIS_FSDP, AXIS_MODEL)),
        PartitionRule(r"\.w_fc\.weight", (AXIS_MODEL, AXIS_FSDP)),
        PartitionRule(r"\.w_proj\.weight", (AXIS_FSDP, AXIS_MODEL)),
        PartitionRule(r"(^|/)embed$", (AXIS_MODEL, AXIS_FSDP)),
        PartitionRule(r"pos_embed|type_embed", (None, AXIS_FSDP)),
        PartitionRule(r"mlm_transform\.weight", (AXIS_MODEL, AXIS_FSDP)),
        PartitionRule(r"norm|bias", ()),
    ]


def mlm_nll_sum(logits: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked-LM CE summed over the positions where ``mask`` is 1:
    ``mlm_loss``'s numerator."""
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    return (nll * mask).sum()


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Masked-LM CE: mean over positions where ``mask`` is 1."""
    return (mlm_nll_sum(logits, targets, mask)
            / torch.clamp(mask.sum(), min=1.0))


def init_params(cfg: BertConfig, generator: torch.Generator
                ) -> Dict[str, torch.Tensor]:
    """Random parameters as the reference initialises them: normal(0,
    0.02) for the embedding tables and the blocks' projections,
    ``lecun_normal`` for ``mlm_transform`` (flax's default), ones for norm
    scales, zeros for biases and ``mlm_bias``. Drawn in fp32 on
    ``generator``'s device in registration order; ``params.load_module(
    Bert(cfg), ...)`` stores each in the dtype the model declares."""
    from tpu_on_k8s_torch.models.vision import lecun_normal

    dev = generator.device
    with torch.device("meta"):
        shapes = {n: p.shape for n, p in Bert(cfg).named_parameters()}
    out = {}
    for name, shape in shapes.items():
        if "norm" in name:
            out[name] = (torch.ones if name.endswith("scale")
                         else torch.zeros)(shape, device=dev)
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=dev)
        elif name.startswith("mlm_transform"):
            out[name] = lecun_normal(shape, generator)
        else:
            out[name] = torch.empty(shape, device=dev).normal_(
                0.0, 0.02, generator=generator)
    return out
