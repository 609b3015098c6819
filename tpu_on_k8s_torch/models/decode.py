"""Autoregressive generation with a KV cache (the serving path).

Counterpart of ``tpu_on_k8s/models/decode.py::generate``. Prefill runs the
whole prompt through the decode-mode model in one call (the cache fills at
positions [0, len), attention among the prompt runs the flash kernel); each
step then attends over the cache with a single-token query. The reference's
``lax.scan`` under ``jit`` becomes a Python loop run eagerly.
``quantize_weights_for_serving`` makes the W8A16 tree that a
``serve_int8_weights`` config serves.
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
    s = torch.clamp(w32.abs().amax(dim=-1) / 127.0, min=1e-9)
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


def init_cache(model: Transformer, batch: int) -> List[KVCache]:
    """Zeroed per-layer caches for a generation batch, on the model's
    device: ``[batch, max_seq_len, Hkv, Dh]`` in ``cfg.dtype``."""
    cfg = model.cfg
    shape = (batch, cfg.max_seq_len, cfg.n_kv_heads, cfg.head_dim)
    dev = model.embed.device
    return [KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                    torch.zeros(shape, dtype=cfg.dtype, device=dev))
            for _ in range(cfg.n_layers)]


def _bucket_len(total: int, max_seq_len: int) -> int:
    """Smallest ``PAGE_TOKENS``-multiple cache length covering ``total``
    positions, capped at the model's max: decode reads the whole cache every
    step, so the cache is sized to the request, not to ``max_seq_len``."""
    return min(max_seq_len,
               max(PAGE_TOKENS, -(-total // PAGE_TOKENS) * PAGE_TOKENS))


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
    length (``_bucket_len``)."""
    dev = resolve_device(device)
    b, lp = prompt.shape
    if lp + max_new_tokens > cfg.max_seq_len:
        raise ValueError(
            f"prompt {lp} + new {max_new_tokens} exceeds max_seq_len "
            f"{cfg.max_seq_len}")
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    sp = SamplingParams(temperature=temperature, top_k=top_k, top_p=top_p)
    # RoPE positions are absolute, so a shorter cache changes nothing but
    # the attention span.
    cfg = dataclasses.replace(
        cfg, max_seq_len=_bucket_len(lp + max_new_tokens, cfg.max_seq_len))
    model = decode_model(cfg, params, dev)
    prompt = prompt.to(device=dev, dtype=torch.int32)
    if max_new_tokens == 0:
        return prompt.new_zeros((b, 0))
    cache = init_cache(model, b)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        positions = torch.arange(lp, dtype=torch.int32,
                                 device=dev).expand(b, lp)
        logits = model(prompt, positions, cache, last_only=True)
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
