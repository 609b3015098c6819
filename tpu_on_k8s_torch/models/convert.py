"""Conversions of parameter trees: Hugging Face Llama and GPT-2 checkpoints
in and out, BERT checkpoints in, and the W8A16 serving variant.

Counterpart of ``tpu_on_k8s/models/convert.py``. ``from_hf_llama`` and
``from_hf_gpt2`` map a ``transformers`` causal LM (anything with a
``config`` read by attribute and a ``state_dict()``) onto the port's state
dict, ``to_hf_llama`` and ``to_hf_gpt2`` map it back, and
``draft_from_hf_gpt2`` loads a speculative draft beside a target. Nothing
here imports ``transformers``: a config object with the documented fields
(a ``types.SimpleNamespace`` will do) and a state dict of tensors or arrays
are enough.

Layouts: the port stores a projection as ``weight [out, in]``, the layout
of torch's ``nn.Linear``, so HF Llama's weights carry over as they are;
HF GPT-2's ``Conv1D`` stores ``[in, out]`` and transposes both ways, and
its fused ``c_attn`` splits into ``wq``, ``wk``, ``wv`` along the output
dimension, in that order. A tied head is one tensor with the embedding
table in HF's state dict, and the export shares it the same way. Norm
scales and biases are fp32 in the port; a converter rounds them through
``dtype`` first, as the reference stores them in ``dtype``.

``from_hf_bert`` maps a ``BertForMaskedLM`` onto ``models/bert.py``'s
state dict (``nn.Linear`` weights carry over as they are; the MLM decoder
is the word-embedding table, so an untied checkpoint is refused). The
reference's orbax checkpoint converters belong to a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.models.decode import quantize_weights_for_serving
from tpu_on_k8s_torch.models.layouts import migrate_param_layout
from tpu_on_k8s_torch.models.params import keeps_fp32
from tpu_on_k8s_torch.models.transformer import Transformer, TransformerConfig
from tpu_on_k8s_torch.ops.quantization import quantize_int8

Params = Dict[str, torch.Tensor]


def _host_fp32(state_dict, name: str) -> torch.Tensor:
    """An fp32 host copy of a state-dict entry (a tensor or an array),
    never an alias of the source model's parameter."""
    w = state_dict[name]
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32, copy=True)
    return torch.from_numpy(np.array(w, np.float32))


def _placed(params: Dict[str, torch.Tensor], dtype: torch.dtype,
            device: str | torch.device) -> Params:
    """``params`` (fp32 host tensors) on ``device``, contiguous, in
    ``dtype``; norm scales and biases rounded through ``dtype`` and stored
    in fp32."""
    dev = resolve_device(device)
    out = {}
    for name, t in params.items():
        t = t.to(dtype).contiguous()
        out[name] = (t.to(device=dev, dtype=torch.float32)
                     if keeps_fp32(name) else t.to(dev))
    return out


def config_from_hf_llama(hf_config) -> TransformerConfig:
    """A ``TransformerConfig`` matching a ``transformers.LlamaConfig``."""
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    if head_dim * hf_config.num_attention_heads != hf_config.hidden_size:
        raise ValueError(
            f"unsupported head_dim {head_dim}: this transformer derives "
            f"head_dim as hidden_size/num_heads")
    if getattr(hf_config, "attention_bias", False):
        raise ValueError("attention_bias=True is not supported")
    scaling = getattr(hf_config, "rope_scaling", None)
    if scaling and scaling.get("rope_type", scaling.get("type")) != "default":
        # Llama-3.1+ rescales rope frequencies; converting silently would
        # give wrong logits far from the trained context
        raise ValueError(f"rope_scaling {scaling!r} is not supported "
                         f"(plain rope only)")
    act = getattr(hf_config, "hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"unsupported hidden_act {act!r}: the SwiGLU MLP "
                         f"assumes silu gating")
    return TransformerConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=hf_config.num_key_value_heads,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(hf_config.rope_theta),
        norm_eps=float(hf_config.rms_norm_eps),
        tie_embeddings=bool(getattr(hf_config, "tie_word_embeddings",
                                    False)),
        remat=False,
    )


#: HF Llama's per-layer names → the port's, ``model.layers.{i}.`` and
#: ``blocks.{i}.`` before them
_LLAMA_LAYER = (("self_attn.q_proj.weight", "attn.wq.weight"),
                ("self_attn.k_proj.weight", "attn.wk.weight"),
                ("self_attn.v_proj.weight", "attn.wv.weight"),
                ("self_attn.o_proj.weight", "attn.wo.weight"),
                ("input_layernorm.weight", "attn_norm.scale"),
                ("mlp.gate_proj.weight", "mlp.w_gate.weight"),
                ("mlp.up_proj.weight", "mlp.w_up.weight"),
                ("mlp.down_proj.weight", "mlp.w_down.weight"),
                ("post_attention_layernorm.weight", "mlp_norm.scale"))


def params_from_hf_llama(state_dict, cfg: TransformerConfig,
                         dtype: torch.dtype = torch.float32,
                         device: str | torch.device = "cuda") -> Params:
    """The port's state dict from an HF Llama ``state_dict`` (tensors or
    numpy arrays), on ``device`` in ``dtype``. ``nn.Linear`` weights are
    ``[out, in]`` as the port's: none transposes but the untied head."""
    def arr(name: str) -> torch.Tensor:
        return _host_fp32(state_dict, name)

    params = {"embed": arr("model.embed_tokens.weight")}
    for i in range(cfg.n_layers):
        for hf, port in _LLAMA_LAYER:
            params[f"blocks.{i}.{port}"] = arr(f"model.layers.{i}.{hf}")
    params["final_norm.scale"] = arr("model.norm.weight")
    if not cfg.tie_embeddings:
        params["lm_head"] = arr("lm_head.weight").t()
    return _placed(params, dtype, device)


def config_from_hf_gpt2(hf_config) -> TransformerConfig:
    """A ``TransformerConfig`` matching a ``transformers.GPT2Config``
    (learned positions, LayerNorm, tanh-GELU, tied embeddings, biased
    projections)."""
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(f"unsupported activation {act!r}: this "
                         f"transformer's gelu is the tanh approximation")
    if getattr(hf_config, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx changes the "
                         "attention math; not supported")
    if getattr(hf_config, "reorder_and_upcast_attn", False):
        raise ValueError("reorder_and_upcast_attn changes the attention "
                         "math; not supported")
    return TransformerConfig(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.n_embd,
        n_layers=hf_config.n_layer,
        n_heads=hf_config.n_head,
        n_kv_heads=hf_config.n_head,
        d_ff=hf_config.n_inner or 4 * hf_config.n_embd,
        max_seq_len=hf_config.n_positions,
        norm_eps=float(hf_config.layer_norm_epsilon),
        pos_emb="learned", norm="ln", activation="gelu",
        use_bias=True, tie_embeddings=True, remat=False,
    )


#: HF GPT-2's per-layer ``Conv1D`` and LayerNorm names past ``c_attn`` →
#: the port's, ``transformer.h.{i}.`` and ``blocks.{i}.`` before them
_GPT2_LAYER = (("attn.c_proj", "attn.wo"), ("ln_1", "attn_norm"),
               ("mlp.c_fc", "mlp.w_up"), ("mlp.c_proj", "mlp.w_down"),
               ("ln_2", "mlp_norm"))


def params_from_hf_gpt2(state_dict, cfg: TransformerConfig,
                        dtype: torch.dtype = torch.float32,
                        device: str | torch.device = "cuda") -> Params:
    """The port's state dict from an HF GPT-2 ``state_dict``, on
    ``device`` in ``dtype``. ``Conv1D`` weights are ``[in, out]`` and
    transpose to the port's ``[out, in]``; ``c_attn`` splits into wq, wk,
    wv along the output dimension, in HF's q, k, v order."""
    def arr(name: str) -> torch.Tensor:
        return _host_fp32(state_dict, name)

    d = cfg.d_model
    params = {"embed": arr("transformer.wte.weight"),
              "pos_embed": arr("transformer.wpe.weight")}
    for i in range(cfg.n_layers):
        hf, port = f"transformer.h.{i}.", f"blocks.{i}."
        w, b = arr(hf + "attn.c_attn.weight"), arr(hf + "attn.c_attn.bias")
        for j, name in enumerate(("wq", "wk", "wv")):
            params[port + f"attn.{name}.weight"] = w[:, j * d:(j + 1) * d].t()
            params[port + f"attn.{name}.bias"] = b[j * d:(j + 1) * d]
        for hf_name, port_name in _GPT2_LAYER:
            w = arr(hf + hf_name + ".weight")
            norm = port_name.endswith("norm")
            params[port + port_name + (".scale" if norm else ".weight")] = (
                w if norm else w.t())
            params[port + port_name + ".bias"] = arr(hf + hf_name + ".bias")
    params["final_norm.scale"] = arr("transformer.ln_f.weight")
    params["final_norm.bias"] = arr("transformer.ln_f.bias")
    return _placed(params, dtype, device)


def _from_hf(hf_model, config_fn, params_fn, dtype, compute_dtype, device
             ) -> Tuple[TransformerConfig, Params]:
    cfg = dataclasses.replace(config_fn(hf_model.config),
                              dtype=compute_dtype or dtype,
                              param_dtype=dtype)
    params = params_fn(hf_model.state_dict(), cfg, dtype, device)
    with torch.device("meta"):
        Transformer(cfg)    # the config constructs: bad fields fail here
    return cfg, params


def from_hf_llama(hf_model, dtype: torch.dtype = torch.float32,
                  compute_dtype: torch.dtype | None = None,
                  device: str | torch.device = "cuda"
                  ) -> Tuple[TransformerConfig, Params]:
    """(config, params) from a loaded ``LlamaForCausalLM``, ready for
    ``load_model``, ``generate``, the engine or a ``Trainer``. ``dtype``
    stores the parameters; ``compute_dtype`` (default: ``dtype``) sets the
    model's activations: bf16 for serving, fp32 to hold logits against
    the HF model closely."""
    return _from_hf(hf_model, config_from_hf_llama, params_from_hf_llama,
                    dtype, compute_dtype, device)


def from_hf_gpt2(hf_model, dtype: torch.dtype = torch.float32,
                 compute_dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda"
                 ) -> Tuple[TransformerConfig, Params]:
    """(config, params) from a loaded ``GPT2LMHeadModel``, as
    ``from_hf_llama``."""
    return _from_hf(hf_model, config_from_hf_gpt2, params_from_hf_gpt2,
                    dtype, compute_dtype, device)


def draft_from_hf_gpt2(hf_model, target_cfg: TransformerConfig,
                       dtype: torch.dtype = torch.float32,
                       compute_dtype: torch.dtype | None = None,
                       device: str | torch.device = "cuda"
                       ) -> Tuple[TransformerConfig, Params]:
    """(draft_cfg, draft_params) for speculative decoding beside
    ``target_cfg``: a small GPT-2 through ``from_hf_gpt2``, refused unless
    it shares the target's vocabulary (proposals and target logits index
    the same tokens). Pass the pair to ``ContinuousBatchingEngine(
    draft_cfg=..., draft_params=...)`` or ``speculative_generate``."""
    cfg, params = from_hf_gpt2(hf_model, dtype, compute_dtype, device)
    if cfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"draft vocab {cfg.vocab_size} != target vocab "
            f"{target_cfg.vocab_size}: a speculative draft must share "
            f"the target's tokenizer")
    return cfg, params


def config_from_hf_bert(hf_config):
    """A ``BertConfig`` matching a ``transformers.BertConfig`` (any object
    with its fields). Refused, as the reference refuses them: an activation
    other than the exact gelu, position embeddings other than absolute, an
    untied MLM decoder."""
    from tpu_on_k8s_torch.models.bert import BertConfig

    act = getattr(hf_config, "hidden_act", "gelu")
    if act != "gelu":
        raise ValueError(f"unsupported hidden_act {act!r}: this encoder "
                         f"uses the exact (erf) gelu")
    if getattr(hf_config, "position_embedding_type",
               "absolute") != "absolute":
        raise ValueError("only absolute position embeddings are supported")
    if not getattr(hf_config, "tie_word_embeddings", True):
        # the MLM decoder here IS the word-embedding matrix; an untied
        # checkpoint's own decoder.weight would be silently dropped
        raise ValueError("untied MLM decoder weights are not supported "
                         "(this encoder ties the decoder to the "
                         "embeddings)")
    return BertConfig(
        vocab_size=hf_config.vocab_size, d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        d_ff=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        type_vocab_size=hf_config.type_vocab_size,
        norm_eps=float(hf_config.layer_norm_eps))


#: HF BERT's per-layer module names past ``bert.encoder.layer.{i}.`` → the
#: port's past ``blocks.{i}.``
_BERT_LAYER = (("attention.self.query", "wq"), ("attention.self.key", "wk"),
               ("attention.self.value", "wv"),
               ("attention.output.dense", "wo"),
               ("attention.output.LayerNorm", "attn_norm"),
               ("intermediate.dense", "w_fc"), ("output.dense", "w_proj"),
               ("output.LayerNorm", "mlp_norm"))
#: the rest of ``BertForMaskedLM``'s tensors → the port's
_BERT_TOP = (("bert.embeddings.word_embeddings.weight", "embed"),
             ("bert.embeddings.position_embeddings.weight", "pos_embed"),
             ("bert.embeddings.token_type_embeddings.weight", "type_embed"),
             ("bert.embeddings.LayerNorm.weight", "embed_norm.scale"),
             ("bert.embeddings.LayerNorm.bias", "embed_norm.bias"),
             ("cls.predictions.transform.dense.weight",
              "mlm_transform.weight"),
             ("cls.predictions.transform.dense.bias", "mlm_transform.bias"),
             ("cls.predictions.transform.LayerNorm.weight",
              "mlm_norm.scale"),
             ("cls.predictions.transform.LayerNorm.bias", "mlm_norm.bias"),
             ("cls.predictions.bias", "mlm_bias"))


def params_from_hf_bert(state_dict, cfg, dtype: torch.dtype = torch.float32,
                        device: str | torch.device = "cuda") -> Params:
    """The port's BERT state dict from an HF ``BertForMaskedLM``
    ``state_dict``, on ``device`` in ``dtype`` (norms fp32)."""
    def arr(name: str) -> torch.Tensor:
        return _host_fp32(state_dict, name)

    params = {port: arr(hf) for hf, port in _BERT_TOP}
    for i in range(cfg.n_layers):
        hf, port = f"bert.encoder.layer.{i}.", f"blocks.{i}."
        for hf_name, port_name in _BERT_LAYER:
            norm = port_name.endswith("norm")
            params[port + port_name + (".scale" if norm else ".weight")] = (
                arr(hf + hf_name + ".weight"))
            params[port + port_name + ".bias"] = arr(hf + hf_name + ".bias")
    return _placed(params, dtype, device)


def from_hf_bert(hf_model, dtype: torch.dtype = torch.float32,
                 compute_dtype: torch.dtype | None = None,
                 device: str | torch.device = "cuda"):
    """(``BertConfig``, params) from a loaded ``BertForMaskedLM``, ready for
    ``params.load_module(Bert(cfg), params)``, as ``from_hf_llama``."""
    from tpu_on_k8s_torch.models.bert import Bert

    cfg = dataclasses.replace(config_from_hf_bert(hf_model.config),
                              dtype=compute_dtype or dtype,
                              param_dtype=dtype)
    params = params_from_hf_bert(hf_model.state_dict(), cfg, dtype, device)
    with torch.device("meta"):
        Bert(cfg)           # the config constructs: bad fields fail here
    return cfg, params


def _host(t: torch.Tensor) -> torch.Tensor:
    """An fp32 host copy, never a view of the port's tensor."""
    return t.detach().to("cpu", torch.float32, copy=True)


def to_hf_llama(cfg: TransformerConfig, params: Params
                ) -> Dict[str, torch.Tensor]:
    """HF Llama ``state_dict`` (fp32 host tensors) from the port's state
    dict, the inverse of ``params_from_hf_llama``. A ``fused_qkv`` or
    ``mlp_fused_gateup`` tree's ``wqkv`` / ``w_gateup`` unfuse
    (``layouts.migrate_param_layout``); a tied head is the embedding
    tensor itself, as HF ties them."""
    if (cfg.pos_emb, cfg.norm, cfg.activation) != ("rope", "rms", "swiglu"):
        raise ValueError("to_hf_llama exports the Llama family only "
                         "(rope + rmsnorm + swiglu)")
    if cfg.use_bias or cfg.n_experts or cfg.serve_int8_weights:
        raise ValueError("biased, MoE, or int8-serving param trees have no "
                         "Llama state-dict form")
    # a fused tree unfuses first (``layouts.migrate_param_layout``: exact)
    params = migrate_param_layout(params, fused_qkv=False,
                                  fused_gateup=False)
    sd = {"model.embed_tokens.weight": _host(params["embed"]),
          "model.norm.weight": _host(params["final_norm.scale"])}
    for i in range(cfg.n_layers):
        p = f"blocks.{i}."
        for hf, port in _LLAMA_LAYER:
            sd[f"model.layers.{i}.{hf}"] = _host(params[p + port])
    sd["lm_head.weight"] = (sd["model.embed_tokens.weight"]
                            if cfg.tie_embeddings
                            else _host(params["lm_head"].t()))
    return sd


def to_hf_gpt2(cfg: TransformerConfig, params: Params
               ) -> Dict[str, torch.Tensor]:
    """HF GPT-2 ``state_dict`` (fp32 host tensors) from the port's state
    dict, the inverse of ``params_from_hf_gpt2``: weights transpose back to
    ``Conv1D``'s ``[in, out]``, wq, wk, wv fuse into ``c_attn``, and
    ``lm_head.weight`` is the ``wte`` tensor itself."""
    if (cfg.pos_emb, cfg.norm, cfg.activation,
            cfg.use_bias, cfg.tie_embeddings) != ("learned", "ln", "gelu",
                                                  True, True):
        raise ValueError("to_hf_gpt2 exports the GPT-2 family only "
                         "(learned positions + LayerNorm + gelu + biased "
                         "tied layout)")
    if cfg.n_kv_heads != cfg.n_heads:
        raise ValueError("HF GPT-2 has no GQA: n_kv_heads must equal "
                         "n_heads")
    if cfg.serve_int8_weights:
        raise ValueError("int8-serving param trees have no GPT-2 "
                         "state-dict form (export the bf16 checkpoint)")
    sd = {"transformer.wte.weight": _host(params["embed"]),
          "transformer.wpe.weight": _host(params["pos_embed"]),
          "transformer.ln_f.weight": _host(params["final_norm.scale"]),
          "transformer.ln_f.bias": _host(params["final_norm.bias"])}
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    for i in range(cfg.n_layers):
        hf, port = f"transformer.h.{i}.", f"blocks.{i}."
        qkv = [port + f"attn.{n}." for n in ("wq", "wk", "wv")]
        sd[hf + "attn.c_attn.weight"] = _host(torch.cat(
            [params[n + "weight"] for n in qkv]).t())
        sd[hf + "attn.c_attn.bias"] = _host(torch.cat(
            [params[n + "bias"] for n in qkv]))
        for hf_name, port_name in _GPT2_LAYER:
            norm = port_name.endswith("norm")
            w = params[port + port_name + (".scale" if norm else ".weight")]
            sd[hf + hf_name + ".weight"] = _host(w if norm else w.t())
            sd[hf + hf_name + ".bias"] = _host(
                params[port + port_name + ".bias"])
    return sd


def quantize_serving_tree(cfg: TransformerConfig,
                          params: Dict[str, torch.Tensor], *,
                          stochastic: bool = False, seed: int = 0
                          ) -> Tuple[TransformerConfig,
                                     Dict[str, torch.Tensor]]:
    """The W8A16 serving variant of a bf16/fp32 state dict: ``(cfg with
    serve_int8_weights=True, quantized params)``, which ``decode.generate``
    serves as it is. A tied head stays full precision (it is the embedding
    table).

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
