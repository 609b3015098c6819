"""Conversions of parameter trees: the W8A16 serving variant.

Counterpart of ``tpu_on_k8s/models/convert.py::quantize_serving_tree``. The
reference's checkpoint converters (orbax, Hugging Face) belong to a later
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from tpu_on_k8s_torch.models.decode import quantize_weights_for_serving
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.ops.quantization import quantize_int8


def quantize_serving_tree(cfg: TransformerConfig,
                          params: Dict[str, torch.Tensor], *,
                          stochastic: bool = False, seed: int = 0
                          ) -> Tuple[TransformerConfig,
                                     Dict[str, torch.Tensor]]:
    """The W8A16 serving variant of a bf16/fp32 state dict: ``(cfg with
    serve_int8_weights=True, quantized params)``, which ``decode.generate``
    serves as it is.

    Default rounding is the deterministic per-output-channel absmax
    round-to-nearest (``decode.quantize_weights_for_serving``).
    ``stochastic=True`` rounds through the stochastic-rounding kernel
    (``ops/quantization.py``, one launch per weight, keyed by ``seed``):
    unbiased, so the rounding noise averages across a channel instead of
    biasing it."""
    if cfg.serve_int8_weights:
        raise ValueError("param tree is already int8-serving")
    if cfg.fused_qkv or cfg.n_experts or cfg.use_bias:
        raise ValueError("int8 serving covers the unfused, bias-free, dense "
                         "layouts only (migrate the checkpoint layout first)")
    out_cfg = dataclasses.replace(cfg, serve_int8_weights=True)
    quantizer = None
    if stochastic:
        def quantizer(w: torch.Tensor):
            # the port's weights are [out, in]: the row-wise kernel gives
            # one scale per output channel directly
            values, scales = quantize_int8(w.contiguous(), seed=seed)
            return values, scales[:, 0]

    return out_cfg, quantize_weights_for_serving(params, quantizer)
