"""Autoregressive generation with a KV cache (the serving path).

Counterpart of ``tpu_on_k8s/models/decode.py::generate``. Prefill runs the
whole prompt through the decode-mode model in one call (the cache fills at
positions [0, len), attention among the prompt runs the flash kernel); each
step then attends over the cache with a single-token query. The reference's
``lax.scan`` under ``jit`` becomes a Python loop run eagerly.
``quantize_weights_for_serving`` makes the W8A16 tree that a
``serve_int8_weights`` config serves. ``cache_shapes``, ``init_cache`` and
``_set_cursor`` also serve the continuous-batching engine
(``models/serving.py``); with ``cache_int8`` every one of them carries the
int8 cache's scale leaves.

``speculative_generate`` is the reference's greedy speculative decoding at
batch 1: a draft model (``truncated_draft`` makes one from the target's
first layers) proposes ``k`` tokens a round, the target verifies them in one
``k+1``-token forward over its cache, and the longest agreeing prefix plus
the target's own next token are emitted. Its three jitted programs
(prefill, draft, verify) become three eager phases; rejecting draft K/V is
a cursor rollback (``_set_cursor``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.models.params import load_model
from tpu_on_k8s_torch.models.sampling import SamplingParams, sample
from tpu_on_k8s_torch.models.transformer import (
    KVCache,
    Transformer,
    TransformerConfig,
    check_supported,
)
from tpu_on_k8s_torch.ops.int8_matmul import div127

#: The position-bucket granule (and the reference's paged-KV page size), in
#: tokens: every cache length ``generate`` allocates is a multiple of it.
PAGE_TOKENS = 128

#: Module names whose ``weight`` ``quantize_weights_for_serving`` converts.
_W8_TARGETS = frozenset({"wq", "wk", "wv", "wo",
                         "w_gate", "w_up", "w_down", "w_gateup"})

#: A quantizer of one weight: ``[F, D]`` rows = output channels → (int8
#: values ``[F, D]``, fp32 scales ``[F]``).
Quantizer = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _absmax_rows(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic absmax round-to-nearest per output channel, as the
    reference's: scale = max|w| / 127 floored at 1e-9 (after the division,
    unlike the ops' 1e-30 floor before it), round half to even, clip."""
    w32 = w.float()
    s = torch.clamp(div127(w32.abs().amax(dim=-1)), min=1e-9)
    q = torch.clamp(torch.round(w32 / s[:, None]), -127, 127)
    return q.to(torch.int8), s


def quantize_weights_for_serving(params: Dict[str, torch.Tensor],
                                 quantize: Optional[Quantizer] = None
                                 ) -> Dict[str, torch.Tensor]:
    """W8A16 weights for ``cfg.serve_int8_weights`` serving: each
    ``{wq,wk,wv,wo,w_gate,w_up,w_down,w_gateup}.weight [F, D]`` becomes an
    int8 ``weight_q [F, D]`` and a per-output-channel fp32 ``weight_scale
    [F]``; ``lm_head [D, V]`` becomes ``lm_head_q [D, V]`` and
    ``lm_head_scale [V]``. Embeddings and norms stay as they are. The
    serving modules rescale the product, so the only error is the int8
    rounding of the weights.

    ``quantize`` swaps the rounding scheme: it maps one weight whose rows
    are output channels, ``[F, D]``, to (int8 ``[F, D]``, fp32 ``[F]``) —
    the reference's hook on its ``[D, F]`` kernels, transposed to the
    port's layout. Default: deterministic absmax round-to-nearest;
    ``convert.quantize_serving_tree`` passes the stochastic-rounding
    kernel (``ops/quantization.py``) through here."""
    quantize = quantize or _absmax_rows
    out = {}
    for name, t in params.items():
        module, _, leaf = name.rpartition(".")
        if leaf == "weight" and module.rpartition(".")[2] in _W8_TARGETS:
            out[f"{module}.weight_q"], out[f"{module}.weight_scale"] = (
                quantize(t))
        elif name == "lm_head":
            q, s = quantize(t.t())          # rows = vocab entries
            out["lm_head_q"], out["lm_head_scale"] = q.t().contiguous(), s
        else:
            out[name] = t
    return out


def truncated_draft(cfg: TransformerConfig, params: Dict[str, torch.Tensor],
                    n_layers: int
                    ) -> Tuple[TransformerConfig, Dict[str, torch.Tensor]]:
    """A layer-truncated self-draft for speculative decoding: the target's
    first ``n_layers`` blocks (``blocks.{i}.*``, ``i < n_layers``) and every
    tensor outside the blocks (embeddings, final norm, head; the int8 head
    of a W8A16 tree). The draft holds the target's tensors themselves, not
    copies, so a model built from it on the target's device and dtype
    aliases the target's weights."""
    if not 1 <= n_layers < cfg.n_layers:
        raise ValueError(f"draft layers must be in [1, {cfg.n_layers}), "
                         f"got {n_layers}")

    def kept(name: str) -> bool:
        head, _, rest = name.partition(".")
        return head != "blocks" or int(rest.partition(".")[0]) < n_layers

    return (dataclasses.replace(cfg, n_layers=n_layers),
            {name: t for name, t in params.items() if kept(name)})


def decode_model(cfg: TransformerConfig, params: Dict[str, torch.Tensor],
                 device: str | torch.device = "cuda") -> Transformer:
    """The architecture in KV-cache mode, holding ``params`` (a state dict,
    see ``models/params.py``). Weights are stored in ``cfg.dtype`` — what
    the reference casts its fp32 masters to at every call — and norm scales
    in fp32; tensors already in that dtype on ``device`` are used as they
    are, not copied."""
    check_supported(cfg)
    cfg = dataclasses.replace(cfg, decode=True, remat=False, attn_impl="xla",
                              param_dtype=cfg.dtype)
    model = load_model(cfg, params, device)
    return model.eval().requires_grad_(False)


#: A cache's leaves: name → (shape, dtype) of the layer-stacked tensor.
CacheShapes = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def cache_shapes(model: Transformer, batch: int,
                 length: Optional[int] = None) -> CacheShapes:
    """Every leaf of a cache, stacked over the layers, in the reference's
    flatten order: ``k`` and ``v`` ``[n_layers, batch, length, Hkv, Dh]``
    in ``cfg.dtype``; with ``cache_int8``, ``k``, ``k_scale``, ``v``,
    ``v_scale``: int8 values and fp32 scales ``[n_layers, batch, length,
    Hkv]``. ``length`` defaults to the model's ``max_seq_len``."""
    cfg = model.cfg
    shape = (cfg.n_layers, batch, length or cfg.max_seq_len,
             cfg.n_kv_heads, cfg.head_dim)
    if not cfg.cache_int8:
        return {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
    return {"k": (shape, torch.int8), "k_scale": (shape[:-1], torch.float32),
            "v": (shape, torch.int8), "v_scale": (shape[:-1], torch.float32)}


def layer_caches(leaves: Dict[str, torch.Tensor]) -> List[KVCache]:
    """The per-layer ``KVCache`` views of stacked ``[n_layers, B, ...]``
    leaves (``cache_shapes``' names): a write through a layer's cache
    lands in the stack."""
    return [KVCache(**{name: t[i] for name, t in leaves.items()})
            for i in range(leaves["k"].shape[0])]


def zeros_like_shapes(shapes: CacheShapes,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """Zeroed tensors of ``cache_shapes``' leaves, on ``device``."""
    return {name: torch.zeros(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in shapes.items()}


def init_cache(model: Transformer, batch: int,
               length: Optional[int] = None) -> List[KVCache]:
    """Zeroed per-layer caches for a generation batch, on the model's
    device: views of one stacked tensor per leaf (``cache_shapes``)."""
    return layer_caches(zeros_like_shapes(cache_shapes(model, batch, length),
                                          model.embed.device))


def _set_cursor(cache: List[KVCache], value: int) -> List[KVCache]:
    """Set every layer's append cursor to ``value``, in place (the cursor is
    a host int): a suffix prefill appends after a prefix this way. Stale
    K/V past the cursor is harmless: a query attends only to positions at
    or below its own, and the next append overwrites it first."""
    for layer in cache:
        layer.index = value
    return cache


def _bucket_len(total: int, max_seq_len: int) -> int:
    """Smallest ``PAGE_TOKENS``-multiple cache length covering ``total``
    positions, capped at the model's max: decode reads the whole cache every
    step, so the cache is sized to the request, not to ``max_seq_len``."""
    return min(max_seq_len,
               max(PAGE_TOKENS, -(-total // PAGE_TOKENS) * PAGE_TOKENS))


def _bucketed(cfg: TransformerConfig, total: int) -> TransformerConfig:
    """``cfg`` with ``max_seq_len`` cut to ``total``'s bucket: RoPE
    positions are absolute, so a shorter cache changes nothing but the
    attention span. A learned position table is sized by ``max_seq_len``,
    so such a model keeps the full-length cache, as the reference's."""
    if cfg.pos_emb != "rope":
        return cfg
    return dataclasses.replace(
        cfg, max_seq_len=_bucket_len(total, cfg.max_seq_len))


def generate(cfg: TransformerConfig, params: Dict[str, torch.Tensor],
             prompt: torch.Tensor, max_new_tokens: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, top_k: int = 0,
             top_p: float = 0.0,
             device: str | torch.device = "cuda") -> torch.Tensor:
    """Greedy (temperature=0) or sampled continuation of ``prompt`` [B, Lp]
    — optional top-k / nucleus filtering (``models/sampling.py``), random
    draws from ``generator`` (default: seed 0 on ``device``).

    Returns int32 [B, max_new_tokens]. Total length must fit
    ``cfg.max_seq_len``; the cache is allocated at the request's bucketed
    length (``_bucketed``; a learned-position model's at its full
    length)."""
    dev = resolve_device(device)
    b, lp = prompt.shape
    if lp + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt {lp} + new {max_new_tokens} exceeds max_seq_len "
            f"{cfg.max_seq_len}")
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    sp = SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p)
    model = decode_model(_bucketed(cfg, lp + max_new_tokens), params, dev)
    prompt = prompt.to(device=dev, dtype=torch.int32)
    if max_new_tokens == 0:
        return prompt.new_zeros((b, 0))
    cache = init_cache(model, b)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        positions = torch.arange(lp, dtype=torch.int32,
                                 device=dev).expand(b, lp)
        logits = model(prompt, positions, cache,
                       at=torch.full((b,), lp - 1, device=dev))
        tok = sample(logits[:, -1], generator, sp)
        out = [tok]
        # the reference's scan makes one more step whose token it drops;
        # this loop stops at the last token it keeps
        for pos in range(lp, lp + max_new_tokens - 1):
            positions = torch.full((b, 1), pos, dtype=torch.int32,
                                   device=dev)
            logits = model(tok[:, None], positions, cache)
            tok = sample(logits[:, -1], generator, sp)
            out.append(tok)
    return torch.stack(out, dim=1)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def speculative_generate(cfg: TransformerConfig,
                         params: Dict[str, torch.Tensor],
                         draft_cfg: TransformerConfig,
                         draft_params: Dict[str, torch.Tensor],
                         prompt: torch.Tensor, max_new_tokens: int,
                         k: int = 4, device: str | torch.device = "cuda"
                         ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Greedy speculative decoding at batch 1: each round the draft feeds
    ``k+1`` tokens (the last emitted one, then its own ``k`` proposals, so
    that its cache also holds the last proposal), the target verifies
    ``[last, d_1..d_k]`` in one forward over its cache, and the longest
    prefix of proposals the target agrees with is emitted, then the
    target's token after it (a correction, or a bonus when all ``k``
    agree). The tokens equal ``generate``'s greedy tokens up to the
    rounding of a ``k+1``-row forward against one-row steps.

    Both caches are allocated at ``_bucketed(lp + new + k + 1)``; each
    phase first rolls its cache's cursor back to the last emitted token's
    position (``_set_cursor``), which rejects the unaccepted K/V. Both
    prefills start from an empty cache at ``arange`` positions, so they run
    the flash forward kernel. Returns ``(tokens int32 [1, new], stats)``
    with the reference's stats: rounds, proposed, accepted,
    acceptance_rate, target_forwards and tokens_per_target_forward."""
    dev = resolve_device(device)
    b, lp = prompt.shape
    if b != 1:
        raise ValueError("speculative_generate is batch-1 (per-row accept "
                         "counts diverge); batch requests use generate()")
    if k < 1:
        raise ValueError(f"speculation window k must be >= 1, got {k}")
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    max_total = lp + max_new_tokens + k + 1
    if max_total > cfg.max_seq_len or max_total > draft_cfg.max_seq_len:
        raise ValueError(
            f"prompt {lp} + new {max_new_tokens} + speculation window "
            f"{k + 1} exceeds max_seq_len")

    target = decode_model(_bucketed(cfg, max_total), params, dev)
    draft = decode_model(_bucketed(draft_cfg, max_total), draft_params, dev)
    prompt = prompt.to(device=dev, dtype=torch.int32)
    t_cache, d_cache = init_cache(target, 1), init_cache(draft, 1)
    with torch.inference_mode():
        positions = torch.arange(lp, dtype=torch.int32, device=dev)[None]
        last = torch.full((1,), lp - 1, device=dev)
        t_last = _greedy(target(prompt, positions, t_cache, at=last)[:, -1])
        draft.extend_cache(prompt, positions, d_cache)
        emitted = [int(t_last[0])]
        p = lp                 # position of t_last (emitted, not yet fed)
        rounds = accepted_total = 0
        steps = torch.arange(k + 1, dtype=torch.int32, device=dev)[None]
        while len(emitted) < max_new_tokens:
            # draft: k+1 feeds; the last only caches d_k (no head)
            _set_cursor(d_cache, p)
            tok, proposals = t_last, []
            for i in range(k):
                tok = _greedy(draft(tok[:, None], p + steps[:, i:i + 1],
                                    d_cache)[:, -1])
                proposals.append(tok)
            draft.extend_cache(tok[:, None], p + steps[:, k:], d_cache)
            # verify: greedy[i] is the target's token after chunk[:i+1]
            _set_cursor(t_cache, p)
            chunk = torch.cat([t_last, *proposals])[None]        # [1, k+1]
            greedy = _greedy(target(chunk, p + steps, t_cache))[0]
            props, target_toks = torch.cat(    # one transfer a round
                [chunk[0, 1:], greedy]).cpu().split([k, k + 1])
            props, target_toks = props.tolist(), target_toks.tolist()
            j = 0
            while j < k and props[j] == target_toks[j]:
                j += 1
            emitted.extend(props[:j])
            emitted.append(target_toks[j])   # correction (or bonus at j=k)
            rounds += 1
            accepted_total += j
            p += j + 1                       # position of the new t_last
            t_last = greedy[j:j + 1]
    kept = emitted[:max_new_tokens]
    tokens = torch.tensor(kept, dtype=torch.int32, device=dev)[None]
    stats = {"rounds": rounds, "proposed": rounds * k,
             "accepted": accepted_total,
             "acceptance_rate": (accepted_total / (rounds * k)
                                 if rounds else 0.0),
             "target_forwards": rounds + 1,
             "tokens_per_target_forward": len(kept) / (rounds + 1)}
    return tokens, stats
