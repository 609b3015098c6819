"""The model's parameters: a flat state dict of tensors.

Names are those of ``Transformer.state_dict()``: ``embed [V, D]``,
``blocks.{i}.attn_norm.scale``, ``blocks.{i}.attn.w{q,k,v,o}.weight``,
``blocks.{i}.mlp_norm.scale``, ``blocks.{i}.mlp.w_{gate,up,down}.weight``
(or ``w_gateup``), ``final_norm.scale`` and ``lm_head [D, V]``. A ``weight``
is ``[out, in]``, the transpose of the reference's Flax ``kernel``.

``from_jax_params`` carries a reference parameter tree across (the
scan-stacked layout: every ``blocks/...`` leaf has a leading layer axis);
``init_params`` draws fresh ones as Flax initialises them, on the device,
from a seeded generator. Serving stores matrices in ``cfg.dtype`` (the
default); training keeps fp32 masters (``dtype=torch.float32``).
``load_model`` builds the model around a state dict.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.models.transformer import Transformer, TransformerConfig


def param_shapes(cfg: TransformerConfig) -> Dict[str, torch.Size]:
    """Name → shape of every parameter, in the model's registration order
    (built on the meta device: nothing is allocated)."""
    with torch.device("meta"):
        model = Transformer(dataclasses.replace(cfg, decode=True))
    return {name: p.shape for name, p in model.named_parameters()}


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Random parameters as Flax initialises them: normal(0, 0.02) for
    embeddings and matrices, ones for norm scales. Drawn in fp32 on
    ``device`` from ``generator`` (which must live there), one tensor after
    another in registration order, then stored in ``dtype`` (default
    ``cfg.dtype``; norm scales stay fp32)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(".scale"):
            params[name] = torch.ones(shape, dtype=torch.float32, device=dev)
        else:
            w = torch.empty(shape, dtype=torch.float32, device=dev)
            params[name] = w.normal_(0.0, 0.02, generator=generator).to(dtype)
    return params


_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("w_gate", "w_up", "w_down", "w_gateup")


def load_model(cfg: TransformerConfig, params: Mapping[str, torch.Tensor],
               device: str | torch.device = "cuda") -> Transformer:
    """``Transformer(cfg)`` on ``device`` holding ``params``. Each tensor
    already in the dtype the model stores it in (``cfg.param_dtype``; fp32
    for norm scales) and on ``device`` becomes the parameter itself, not a
    copy, so an optimizer's in-place update is seen through ``params``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Transformer(cfg)
    state = {}
    for name, ref in model.state_dict().items():
        if name not in params:
            raise KeyError(f"params lack {name!r}")
        state[name] = params[name].to(device=dev, dtype=ref.dtype)
    model.load_state_dict(state, strict=True, assign=True)
    return model


def _as_numpy(leaf) -> np.ndarray:
    arr = np.asarray(leaf)
    if arr.dtype not in (np.float16, np.float32, np.float64):
        arr = arr.astype(np.float32)     # e.g. bfloat16: exact in fp32
    return np.array(arr, order="C")      # a writable copy torch can own


def from_jax_params(tree: Mapping, dtype: Optional[torch.dtype] = None,
                    device: str | torch.device = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (nested dict of arrays, paths
    ``blocks/attn/w{q,k,v,o}/kernel [L, D_in, D_out]``,
    ``blocks/{attn,mlp}_norm/scale [L, D]``,
    ``blocks/mlp/w_{gate,up,down}/kernel`` or ``w_gateup``,
    ``embed [V, D]``, ``final_norm/scale [D]``, ``lm_head [D, V]``) as the
    port's state dict on ``device``. Matrices are stored in ``dtype``
    (default: the tree's own); norm scales stay fp32. A tree of a layout
    this slice does not serve raises ``NotImplementedError``."""
    dev = resolve_device(device)

    def mat(a) -> torch.Tensor:
        t = torch.from_numpy(_as_numpy(a))
        return t.to(device=dev, dtype=dtype or t.dtype)

    def scale(a) -> torch.Tensor:
        return torch.from_numpy(_as_numpy(a)).to(device=dev,
                                                 dtype=torch.float32)

    if set(tree) != {"blocks", "embed", "final_norm", "lm_head"}:
        raise NotImplementedError(
            f"parameter tree with top-level keys {sorted(tree)}: only the "
            f"untied rope/rms Llama layout is ported")
    blocks = tree["blocks"]
    attn, mlp = blocks["attn"], blocks["mlp"]
    if (set(blocks) != {"attn", "attn_norm", "mlp", "mlp_norm"}
            or set(attn) != set(_ATTN) or not set(mlp) <= set(_MLP)
            or any(set(attn[w]) != {"kernel"} for w in attn)
            or any(set(mlp[w]) != {"kernel"} for w in mlp)):
        raise NotImplementedError(
            "parameter tree layout not ported (fused qkv, biases, MoE, "
            "int8 or GPT-2 family)")
    n_layers = np.shape(blocks["attn_norm"]["scale"])[0]
    params = {"embed": mat(tree["embed"])}
    for i in range(n_layers):
        p = f"blocks.{i}."
        params[p + "attn_norm.scale"] = scale(blocks["attn_norm"]["scale"][i])
        for w in _ATTN:
            params[p + f"attn.{w}.weight"] = mat(_as_numpy(
                attn[w]["kernel"][i]).T)
        params[p + "mlp_norm.scale"] = scale(blocks["mlp_norm"]["scale"][i])
        for w in mlp:
            params[p + f"mlp.{w}.weight"] = mat(_as_numpy(
                mlp[w]["kernel"][i]).T)
    params["final_norm.scale"] = scale(tree["final_norm"]["scale"])
    params["lm_head"] = mat(tree["lm_head"])
    return params
