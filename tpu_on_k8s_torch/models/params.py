"""The model's parameters: a flat state dict of tensors.

Names are those of ``Transformer.state_dict()``: ``embed [V, D]``,
``blocks.{i}.attn_norm.scale``, ``blocks.{i}.attn.w{q,k,v,o}.weight``,
``blocks.{i}.mlp_norm.scale``, ``blocks.{i}.mlp.w_{gate,up,down}.weight``
(or ``w_gateup``), ``final_norm.scale`` and ``lm_head [D, V]``. The GPT-2
family adds ``pos_embed [max_seq_len, D]`` (learned positions), a ``bias``
beside each LayerNorm ``scale`` and, with ``use_bias``, beside each
projection's ``weight``; its MLP is ``w_up`` and ``w_down``, and a tied
model has no ``lm_head``. An MoE model (``n_experts > 0``) holds
``blocks.{i}.moe.router [D, E]`` (fp32 always) and the stacked experts
``blocks.{i}.moe.w_{gate,up} [E, D, F]`` and ``moe.w_down [E, F, D]`` (the
reference's layouts) in place of ``blocks.{i}.mlp``. A ``weight``
is ``[out, in]``, the transpose of the reference's Flax ``kernel``. The
W8A16 serving layout (``serve_int8_weights``) holds each projection as an
int8 ``weight_q [out, in]`` and an fp32 ``weight_scale [out]``, and the head
as ``lm_head_q [D, V]`` int8 and ``lm_head_scale [V]``.

``from_jax_params`` carries a reference parameter tree across (the
scan-stacked layout: every ``blocks/...`` leaf has a leading layer axis),
``from_jax_train_state`` a reference training state (parameters, Adam
moments, count and step: a JAX run stopped at step k continues here),
``handoff_from_numpy`` a reference engine's KV handoff;
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


def keeps_fp32(name: str) -> bool:
    """Whether the model stores parameter ``name`` in fp32 whatever its
    dtypes: a norm's scale and bias, an int8 weight's scale, the MoE
    router."""
    return (name.endswith("scale") or name.endswith("moe.router")
            or name.rpartition(".")[0].endswith("norm"))


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: str | torch.device = "cuda",
                dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Random parameters as Flax initialises them: normal(0, 0.02) for
    embeddings, position tables and matrices, ones for norm scales, zeros
    for biases. Drawn in fp32 on ``device`` from ``generator`` (which must
    live there), one tensor after another in registration order, then
    stored in ``dtype`` (default ``cfg.dtype``; norm scales and biases stay
    fp32, and so does the MoE router). The int8 serving layout's ``*_q`` / ``*_scale`` are zeros and
    ones, the reference's placeholders (``quantize_weights_for_serving``
    makes real ones)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    params = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(".scale") or name.endswith("_scale"):
            params[name] = torch.ones(shape, dtype=torch.float32, device=dev)
        elif name.endswith(".bias"):
            params[name] = torch.zeros(
                shape, dtype=torch.float32 if keeps_fp32(name) else dtype,
                device=dev)
        elif name.endswith("_q"):
            params[name] = torch.zeros(shape, dtype=torch.int8, device=dev)
        else:
            w = torch.empty(shape, dtype=torch.float32, device=dev)
            params[name] = w.normal_(0.0, 0.02, generator=generator).to(
                torch.float32 if keeps_fp32(name) else dtype)
    return params


_ATTN = ("wq", "wk", "wv", "wqkv", "wo")
#: the attention projections a reference tree may hold: unfused or fused
_ATTN_LAYOUTS = ({"wq", "wk", "wv", "wo"}, {"wqkv", "wo"})
_MLP = ("w_gate", "w_up", "w_down", "w_gateup")
#: the stacked MoE leaves (``models/moe.py``), kept in the reference's
#: layouts; a GELU MoE has no ``w_gate``
_MOE = ("router", "w_gate", "w_up", "w_down")
_MOE_LAYOUTS = ({"router", "w_gate", "w_up", "w_down"},
                {"router", "w_up", "w_down"})


def load_model(cfg: TransformerConfig, params: Mapping[str, torch.Tensor],
               device: str | torch.device = "cuda") -> Transformer:
    """``Transformer(cfg)`` on ``device`` holding ``params``. Each tensor
    already in the dtype the model stores it in (``cfg.param_dtype``; fp32
    for norm and int8 scales, int8 for int8 weights) and on ``device``
    becomes the parameter itself, not a copy, so an optimizer's in-place
    update is seen through ``params``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = Transformer(cfg)
    state = {}
    for name, ref in model.state_dict().items():
        if name not in params:
            raise KeyError(f"params lack {name!r}")
        if (params[name].dtype == torch.int8) != (ref.dtype == torch.int8):
            raise ValueError(f"{name!r} is {params[name].dtype}; the model "
                             f"holds it as {ref.dtype}")
        state[name] = params[name].to(device=dev, dtype=ref.dtype)
    model.load_state_dict(state, strict=True, assign=True)
    return model


def _as_numpy(leaf) -> np.ndarray:
    arr = np.asarray(leaf)
    if arr.dtype not in (np.float16, np.float32, np.float64, np.int8):
        arr = arr.astype(np.float32)     # e.g. bfloat16: exact in fp32
    return np.array(arr, order="C")      # a writable copy torch can own


#: the leaf sets a reference projection and a reference norm may hold
_DENSE_LEAVES = ({"kernel"}, {"kernel", "bias"}, {"kernel_q", "kernel_scale"})
_NORM_LEAVES = ({"scale"}, {"scale", "bias"})


def from_jax_params(tree: Mapping, dtype: Optional[torch.dtype] = None,
                    device: str | torch.device = "cuda"
                    ) -> Dict[str, torch.Tensor]:
    """The reference's parameter tree (nested dict of arrays, paths
    ``blocks/attn/w{q,k,v,o}/kernel [L, D_in, D_out]``,
    ``blocks/{attn,mlp}_norm/scale [L, D]``,
    ``blocks/mlp/w_{gate,up,down}/kernel`` or ``w_gateup``,
    ``embed [V, D]``, ``final_norm/scale [D]``, ``lm_head [D, V]``; the
    GPT-2 family's ``pos_embed [max_seq_len, D]``, ``bias`` leaves beside
    norm scales and projection kernels, and no ``lm_head`` when tied) as
    the port's state dict on ``device``. Matrices, position tables and
    projection biases are stored in ``dtype`` (default: the tree's own);
    norm scales and biases stay fp32. The W8A16 tree of
    ``quantize_weights_for_serving`` (``kernel_q [L, D_in, D_out]`` int8 and
    ``kernel_scale [L, D_out]``; ``lm_head_q [D, V]``, ``lm_head_scale
    [V]``) keeps its int8 values and fp32 scales. A fused ``attn/wqkv``
    tree becomes ``attn.wqkv.weight``. An MoE tree's ``blocks/moe/router
    [L, D, E]`` (fp32 whatever ``dtype`` says), ``w_gate``/``w_up [L, E, D,
    F]`` and ``w_down [L, E, F, D]`` become ``blocks.{i}.moe.*`` as they
    are (no transpose). A tree of another layout raises
    ``NotImplementedError``.
    Adam's moment trees have the same layout, so they cross the same
    way."""
    dev = resolve_device(device)

    def mat(a) -> torch.Tensor:
        t = torch.from_numpy(_as_numpy(a))
        if t.dtype == torch.int8:
            return t.to(dev)
        return t.to(device=dev, dtype=dtype or t.dtype)

    def scale(a) -> torch.Tensor:
        return torch.from_numpy(_as_numpy(a)).to(device=dev,
                                                 dtype=torch.float32)

    def dense(module, i) -> Dict[str, torch.Tensor]:
        if "kernel" in module:
            out = {"weight": mat(_as_numpy(module["kernel"][i]).T)}
            if "bias" in module:
                out["bias"] = mat(module["bias"][i])
            return out
        return {"weight_q": mat(_as_numpy(module["kernel_q"][i]).T),
                "weight_scale": scale(module["kernel_scale"][i])}

    def norm(module, i=None) -> Dict[str, torch.Tensor]:
        return {leaf: scale(a if i is None else a[i])
                for leaf, a in module.items()}

    base = {"blocks", "embed", "final_norm"}
    optional = {"pos_embed", "lm_head", "lm_head_q", "lm_head_scale"}
    blocks = tree.get("blocks", {})
    attn, mlp = blocks.get("attn", {}), blocks.get("mlp", {})
    ffn = "moe" if "moe" in blocks else "mlp"
    if (not base <= set(tree) or not set(tree) <= base | optional
            or set(blocks) != {"attn", "attn_norm", ffn, "mlp_norm"}
            or ffn == "moe" and set(blocks["moe"]) not in _MOE_LAYOUTS
            or set(attn) not in _ATTN_LAYOUTS or not set(mlp) <= set(_MLP)
            or any(set(m) not in _DENSE_LEAVES
                   for m in (*attn.values(), *mlp.values()))
            or any(set(blocks[n]) not in _NORM_LEAVES
                   for n in ("attn_norm", "mlp_norm"))
            or set(tree["final_norm"]) not in _NORM_LEAVES):
        raise NotImplementedError(
            f"parameter tree layout not ported: "
            f"top-level keys {sorted(tree)}, blocks "
            f"{ {k: sorted(v) for k, v in blocks.items()} }")
    n_layers = np.shape(blocks["attn_norm"]["scale"])[0]
    params = {"embed": mat(tree["embed"])}
    if "pos_embed" in tree:
        params["pos_embed"] = mat(tree["pos_embed"])
    groups = (("attn_norm", ()), ("attn", _ATTN), ("mlp_norm", ()),
              ("mlp", _MLP))
    for i in range(n_layers):
        p = f"blocks.{i}."
        for group, names in groups[:3] if ffn == "moe" else groups:
            leaves = norm(blocks[group], i) if not names else {
                f"{w}.{leaf}": t for w in names if w in blocks[group]
                for leaf, t in dense(blocks[group][w], i).items()}
            for leaf, t in leaves.items():
                params[p + f"{group}.{leaf}"] = t
        for w in _MOE if ffn == "moe" else ():
            if w in blocks["moe"]:
                a = blocks["moe"][w][i]
                params[p + f"moe.{w}"] = scale(a) if w == "router" else mat(a)
    for leaf, t in norm(tree["final_norm"]).items():
        params[f"final_norm.{leaf}"] = t
    if "lm_head_q" in tree:
        params["lm_head_q"] = mat(tree["lm_head_q"])
        params["lm_head_scale"] = scale(tree["lm_head_scale"])
    elif "lm_head" in tree:
        params["lm_head"] = mat(tree["lm_head"])
    return params


def _adam_state(opt_state):
    """The optax Adam state (the one leaf-holder with ``mu``, ``nu`` and
    ``count``) inside a reference optimizer state of nested tuples."""
    if all(hasattr(opt_state, f) for f in ("mu", "nu", "count")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def from_jax_train_state(cfg: TransformerConfig, state,
                         device: str | torch.device = "cuda",
                         **optimizer_kwargs):
    """A reference ``TrainState`` (its leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, state)``: ``step``, ``params`` and an optax
    ``opt_state`` holding Adam's ``mu``, ``nu`` and ``count``, in fp32 or
    bf16) as the port's ``TrainState`` on ``device``: the model of ``cfg``
    holding the fp32 masters, ``default_optimizer(**optimizer_kwargs)``
    (the reference run's hyperparameters and moment dtypes) with both
    moments and the count, and the step. The next port step is the
    reference's next step."""
    from tpu_on_k8s_torch.train.trainer import TrainState
    from tpu_on_k8s_torch.train.optimizer import default_optimizer

    dev = resolve_device(device)
    adam = _adam_state(state.opt_state)
    if adam is None:
        raise ValueError("the optimizer state holds no Adam state (mu, nu, "
                         "count)")
    model = load_model(cfg, from_jax_params(state.params, torch.float32,
                                            dev), dev)
    optimizer = default_optimizer(model.parameters(), **optimizer_kwargs)
    optimizer.init_state()
    with torch.no_grad():
        for key, tree in (("mu", adam.mu), ("nu", adam.nu)):
            moments = from_jax_params(tree, torch.float32, dev)
            for name, p in model.named_parameters():
                # exact: a bf16 moment was widened to fp32 on the way in
                optimizer.state[p][key].copy_(moments[name])
    optimizer.count = int(np.asarray(adam.count))
    return TrainState(model, optimizer, int(np.asarray(state.step)))


def _host_tensor(leaf) -> torch.Tensor:
    """A numpy array as a host tensor of the same dtype and bytes. numpy's
    bfloat16 (an extension dtype) has no torch counterpart in
    ``from_numpy``, so its raw 16-bit words are carried and reinterpreted."""
    arr = np.array(leaf, order="C")      # a writable copy torch can own
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


#: The cache layouts a reference handoff may carry: ``{k, v}``, and the
#: int8 cache's ``{k, k_scale, v, v_scale}``.
_HANDOFF_LAYOUTS = ({"k", "v"}, {"k", "k_scale", "v", "v_scale"})


def handoff_from_numpy(cache: Mapping, *, pos: int, first_token: int,
                       emitted, base: int = 0,
                       prefix_hash: Optional[str] = None,
                       checksum: str = ""):
    """A reference engine's KV handoff (``cache`` its numpy pytree
    ``{"blocks": {"attn": {"k", "v"}}}``, each leaf ``[n_layers, 1, pb,
    Hkv, Dh]``, or the int8 cache's ``{"k", "k_scale", "v", "v_scale"}``
    with scales ``[n_layers, 1, pb, Hkv]``, and the handoff's metadata
    fields) as the port's ``KVHandoff``, on the host. The bytes, the leaf
    order and the metadata are carried unchanged, so ``checksum`` (the
    reference's seal) still verifies. A tree of another layout (unstacked
    layers, a partial set of leaves) raises ``NotImplementedError``."""
    from tpu_on_k8s_torch.models.serving import KVHandoff

    if set(cache) != {"blocks"} or set(cache["blocks"]) != {"attn"} or set(
            cache["blocks"]["attn"]) not in _HANDOFF_LAYOUTS:
        raise NotImplementedError(
            "handoff payload layout not ported: only the layer-stacked "
            "{'blocks': {'attn': {'k', 'v'}}} cache and the int8 cache's "
            "{'k', 'k_scale', 'v', 'v_scale'}")
    attn = cache["blocks"]["attn"]
    return KVHandoff(
        cache={name: _host_tensor(attn[name]) for name in sorted(attn)},
        pos=int(pos), first_token=int(first_token),
        emitted=tuple(int(t) for t in emitted), base=int(base),
        prefix_hash=prefix_hash, checksum=checksum)


def load_module(model: torch.nn.Module, state: Mapping[str, torch.Tensor],
                device: str | torch.device = "cuda") -> torch.nn.Module:
    """``model`` (built anywhere, the meta device included) holding
    ``state``, a full state dict of its parameters and buffers, on
    ``device``, each tensor in the dtype the model declares for it. A
    tensor already so placed becomes the parameter or buffer itself."""
    dev = resolve_device(device)
    own = model.state_dict()
    if set(own) != set(state):
        raise KeyError(f"state keys differ: missing "
                       f"{sorted(set(own) - set(state))[:4]}, unexpected "
                       f"{sorted(set(state) - set(own))[:4]}")
    model.load_state_dict({name: state[name].to(device=dev, dtype=t.dtype)
                           for name, t in own.items()},
                          strict=True, assign=True)
    return model


def from_jax_variables(variables: Mapping,
                       device: str | torch.device = "cuda"
                       ) -> Dict[str, torch.Tensor]:
    """A reference vision model's variables (``{"params": ...,
    "batch_stats": ...}``, nested dicts of arrays, as ``model.init``
    returns them) as the port's state dict (``models/vision.py``) on
    ``device``: ``a/b/kernel`` becomes ``a.b.weight``, an HWIO conv
    kernel transposed to ``[out, in, kh, kw]`` and a Dense kernel to
    ``[out, in]``; scales, biases and the ``batch_stats``' ``mean`` and
    ``var`` keep their names and fp32."""
    from tpu_on_k8s_torch.parallel.partition import flatten_tree

    dev = resolve_device(device)
    out = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in flatten_tree(dict(variables.get(collection, {}))):
            a = _as_numpy(leaf)
            module, _, name = path.rpartition("/")
            if name == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                name = "weight"
            out[f"{module.replace('/', '.')}.{name}"] = torch.from_numpy(
                np.ascontiguousarray(a)).to(device=dev, dtype=torch.float32)
    return out


#: the reference encoder block's projections and norms (``models/bert.py``)
_BERT_DENSE = ("wq", "wk", "wv", "wo", "w_fc", "w_proj")
_BERT_NORMS = ("attn_norm", "mlp_norm")


def from_jax_bert_params(tree: Mapping,
                         device: str | torch.device = "cuda"
                         ) -> Dict[str, torch.Tensor]:
    """The reference BERT's parameter tree (scan-stacked ``blocks/{wq, wk,
    wv, wo, w_fc, w_proj}/{kernel [L, in, out], bias [L, out]}`` and
    ``blocks/{attn,mlp}_norm/{scale, bias} [L, D]``; ``embed``,
    ``pos_embed``, ``type_embed``, ``embed_norm``, ``mlm_transform``,
    ``mlm_norm``, ``mlm_bias``) as the port's state dict
    (``models/bert.py``) in fp32 on ``device``: per layer
    ``blocks.{i}.wq.weight [out, in]`` and so on; ``load_module`` stores
    each in the dtype the model declares. Adam's moment trees have the
    same layout, so they cross the same way."""
    dev = resolve_device(device)

    def fp32(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(_as_numpy(a))).to(
            device=dev, dtype=torch.float32)

    blocks = tree["blocks"]
    if set(blocks) != {*_BERT_DENSE, *_BERT_NORMS}:
        raise NotImplementedError(f"not a BERT block tree: "
                                  f"{sorted(blocks)}")
    params = {name: fp32(tree[name])
              for name in ("embed", "pos_embed", "type_embed")}
    params["embed_norm.scale"] = fp32(tree["embed_norm"]["scale"])
    params["embed_norm.bias"] = fp32(tree["embed_norm"]["bias"])
    for i in range(np.shape(blocks["attn_norm"]["scale"])[0]):
        for w in _BERT_DENSE:
            params[f"blocks.{i}.{w}.weight"] = fp32(
                _as_numpy(blocks[w]["kernel"][i]).T)
            params[f"blocks.{i}.{w}.bias"] = fp32(blocks[w]["bias"][i])
        for n in _BERT_NORMS:
            for leaf in ("scale", "bias"):
                params[f"blocks.{i}.{n}.{leaf}"] = fp32(blocks[n][leaf][i])
    params["mlm_transform.weight"] = fp32(
        _as_numpy(tree["mlm_transform"]["kernel"]).T)
    params["mlm_transform.bias"] = fp32(tree["mlm_transform"]["bias"])
    params["mlm_norm.scale"] = fp32(tree["mlm_norm"]["scale"])
    params["mlm_norm.bias"] = fp32(tree["mlm_norm"]["bias"])
    params["mlm_bias"] = fp32(tree["mlm_bias"])
    return params
