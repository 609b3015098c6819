"""The port's Hugging Face interop (``tpu_on_k8s_torch/models/convert.py``)
against ``transformers``, an independent oracle, on the CPU.

The reference's ``tests/test_hf_interop.py`` oracles, run against the
port: tiny Llama and GPT-2 models are built by ``transformers`` from
configs written here (nothing is downloaded), converted, and their logits,
greedy tokens and exported state dicts held against the HF models'; the
``--hf-model`` paths of the ``serve`` and ``generate`` CLIs serve a saved
checkpoint directory; and for each family the port's converted model and
the JAX package's give the same logits. ``TestBert`` holds
``from_hf_bert`` to the reference's three BERT oracles (MLM logits with
token types, the padding mask on the xla and the flash path, the refused
configs) and to the JAX package's converted model.

Tolerances: logits against HF within the reference's atol 2e-4 / rtol
2e-3; export round trips exact (atol 1e-6 on HF's own logits, as the
reference); port against the JAX package within ``FP32_ATOL``.
"""
import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from tpu_on_k8s.models import convert as jconvert  # noqa: E402
from tpu_on_k8s.models.transformer import Transformer as JTransformer  # noqa: E402,E501
from tpu_on_k8s_torch import generate as generate_cli  # noqa: E402
from tpu_on_k8s_torch import serve as serve_cli  # noqa: E402
from tpu_on_k8s_torch.models import convert, decode  # noqa: E402
from tpu_on_k8s_torch.models.params import load_model  # noqa: E402
from tpu_on_k8s_torch.models.transformer import TransformerConfig  # noqa: E402,E501

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

HF_ATOL, HF_RTOL = 2e-4, 2e-3
# the two packages' fp32 forwards of the same converted weights differ only
# in summation order: measured within 2.4e-7 on both families
FP32_ATOL = 1e-5
REPO = Path(__file__).resolve().parent.parent
TOKENS = np.array([[3, 17, 95, 4, 88, 120, 7, 1],
                   [9, 2, 64, 31, 5, 77, 12, 40]], np.int32)


def _tiny_llama(tie=False, kv_heads=2):
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=kv_heads, max_position_embeddings=64,
        rms_norm_eps=1e-6, rope_theta=10000.0, tie_word_embeddings=tie,
        attention_bias=False, mlp_bias=False)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(hf_cfg).eval()


def _tiny_gpt2():
    hf_cfg = transformers.GPT2Config(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
        n_inner=None, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(hf_cfg).eval()


def _hf_logits(hf, tokens) -> np.ndarray:
    with torch.no_grad():
        return hf(torch.tensor(tokens, dtype=torch.long)).logits.numpy()


def _port_logits(cfg, params, tokens) -> np.ndarray:
    with torch.no_grad():
        return load_model(cfg, params, "cpu")(
            torch.from_numpy(tokens)).numpy()


# ---- Llama -----------------------------------------------------------------

@pytest.mark.parametrize("tie,kv", [(False, 2), (False, 4), (True, 2)])
def test_logits_match_hf(tie, kv):
    hf = _tiny_llama(tie=tie, kv_heads=kv)
    cfg, params = convert.from_hf_llama(hf, device="cpu")
    assert cfg.n_kv_heads == kv and cfg.tie_embeddings == tie
    assert ("lm_head" in params) != tie
    np.testing.assert_allclose(_port_logits(cfg, params, TOKENS),
                               _hf_logits(hf, TOKENS), atol=HF_ATOL,
                               rtol=HF_RTOL)


def test_converted_params_serve_and_generate():
    """The converted tree plugs into ``generate`` (its greedy first token
    is HF's) and the engine."""
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine

    hf = _tiny_llama()
    cfg, params = convert.from_hf_llama(hf, device="cpu")
    prompt = np.array([[5, 9, 2, 66]], np.int32)
    hf_next = int(_hf_logits(hf, prompt)[0, -1].argmax())
    out = decode.generate(cfg, params, torch.from_numpy(prompt), 4,
                          device="cpu")
    assert int(out[0, 0]) == hf_next
    eng = ContinuousBatchingEngine(cfg, params, n_slots=2, device="cpu")
    rid = eng.submit(prompt[0], 3)
    assert eng.run()[rid].shape == (3,)


def test_config_validation():
    hf = _tiny_llama()
    hf.config.attention_bias = True
    with pytest.raises(ValueError, match="attention_bias"):
        convert.config_from_hf_llama(hf.config)
    hf.config.attention_bias = False
    hf.config.rope_scaling = {"rope_type": "llama3", "factor": 8.0}
    with pytest.raises(ValueError, match="rope_scaling"):
        convert.config_from_hf_llama(hf.config)  # silently-wrong logits
    hf.config.rope_scaling = None
    hf.config.hidden_act = "gelu"
    with pytest.raises(ValueError, match="hidden_act"):
        convert.config_from_hf_llama(hf.config)


def test_serve_cli_loads_hf_checkpoint(tmp_path, capsys):
    """``serve --hf-model`` serves a saved HF checkpoint directory (the
    reference's ``test_serve_example_loads_hf_checkpoint``)."""
    _tiny_llama().save_pretrained(tmp_path)
    out = serve_cli.main(["--hf-model", str(tmp_path), "--device", "cpu",
                          "--n-requests", "2", "--n-slots", "2",
                          "--max-new-tokens", "3", "--arrival", "2",
                          "--prompt-max", "10"])
    assert len(out) == 2
    assert all(len(v) == 3 for v in out.values())
    assert f"loaded HF llama from {tmp_path}" in capsys.readouterr().out


def test_generate_cli_loads_hf_checkpoint(tmp_path, capsys):
    """``generate --hf-model`` on a saved GPT-2 checkpoint: bf16 weights,
    a seeded prompt, the greedy continuation of the converted model."""
    hf = _tiny_gpt2()
    hf.save_pretrained(tmp_path)
    out = generate_cli.main(["--hf-model", str(tmp_path), "--device", "cpu",
                             "--prompt-len", "6", "--max-new-tokens", "4"])
    assert tuple(out.shape) == (1, 4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"loaded HF gpt2 from {tmp_path}")
    prompt = torch.tensor([json.loads(lines[1].split(":", 1)[1])],
                          dtype=torch.int32)
    cfg, params = convert.from_hf_gpt2(hf, dtype=torch.bfloat16,
                                       device="cpu")
    np.testing.assert_array_equal(
        out.numpy(), decode.generate(cfg, params, prompt, 4,
                                     device="cpu").numpy())


def test_hf_model_flag_without_transformers_names_it(tmp_path):
    """Without ``transformers`` the CLIs still import, and ``--hf-model``
    raises an ImportError that names the package."""
    code = ("import sys; sys.modules['transformers'] = None\n"
            "from tpu_on_k8s_torch import serve, generate\n"
            "from tpu_on_k8s_torch.models import convert\n"
            "try:\n"
            f"    serve.main(['--hf-model', {str(tmp_path)!r}, '--device', "
            "'cpu'])\n"
            "except ImportError as e:\n"
            "    assert 'transformers' in str(e), e\n"
            "    print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.stdout.strip() == "ok", res.stderr


class TestExport:
    """to_hf_llama: the round trip back into transformers."""

    def test_roundtrip_exact_logits(self):
        a = _tiny_llama()
        cfg, params = convert.from_hf_llama(a, device="cpu")
        sd = convert.to_hf_llama(cfg, params)
        b = transformers.LlamaForCausalLM(a.config).eval()
        missing, unexpected = b.load_state_dict(sd, strict=False)
        assert not unexpected
        assert all("rotary" in m or "inv_freq" in m for m in missing), missing
        tokens = TOKENS[:1]
        np.testing.assert_allclose(_hf_logits(b, tokens),
                                   _hf_logits(a, tokens), atol=1e-6)
        for name, t in a.state_dict().items():
            assert torch.equal(sd[name], t), name

    def test_fused_layout_exports(self):
        """A fused gate+up tree (``mlp_fused_gateup``, gate first) unfuses
        on export, exactly; so does a tree with both fused layouts
        (``fused_qkv`` too), the reference's case."""
        a = _tiny_llama()
        cfg, params = convert.from_hf_llama(a, device="cpu")
        fused = dict(params)
        for i in range(cfg.n_layers):
            p = f"blocks.{i}.mlp."
            fused[p + "w_gateup.weight"] = torch.cat(
                [fused.pop(p + "w_gate.weight"), fused.pop(p + "w_up.weight")])
        fcfg = dataclasses.replace(cfg, mlp_fused_gateup=True)
        load_model(fcfg, fused, "cpu")           # a tree the port serves
        sd = convert.to_hf_llama(fcfg, fused)
        want = convert.to_hf_llama(cfg, params)
        assert set(sd) == set(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), k
        # the fused-qkv half: a tree migrated to both fused layouts
        # (``layouts.migrate_param_layout``, the reference's
        # ``migrate_param_layout``) unfuses on export, exactly
        from tpu_on_k8s_torch.models.layouts import migrate_param_layout
        both = migrate_param_layout(params, fused_qkv=True,
                                    fused_gateup=True)
        bcfg = dataclasses.replace(cfg, fused_qkv=True,
                                   mlp_fused_gateup=True)
        load_model(bcfg, both, "cpu")            # a tree the port serves
        sd = convert.to_hf_llama(bcfg, both)
        assert set(sd) == set(want)
        for k in want:
            assert torch.equal(sd[k], want[k]), k

    def test_rejects_non_llama_families(self):
        cfg, params = convert.from_hf_gpt2(_tiny_gpt2(), device="cpu")
        with pytest.raises(ValueError, match="Llama family"):
            convert.to_hf_llama(cfg, params)


class TestGPT2:
    """GPT-2-family oracle: learned positions, LayerNorm (with bias),
    tanh-gelu, biased Conv1D projections, tied head."""

    def test_logits_match_hf(self):
        hf = _tiny_gpt2()
        cfg, params = convert.from_hf_gpt2(hf, device="cpu")
        assert cfg.use_bias and cfg.tie_embeddings
        assert cfg.pos_emb == "learned" and cfg.activation == "gelu"
        np.testing.assert_allclose(_port_logits(cfg, params, TOKENS),
                                   _hf_logits(hf, TOKENS), atol=HF_ATOL,
                                   rtol=HF_RTOL)

    def test_generate_matches_hf_greedy(self):
        hf = _tiny_gpt2()
        cfg, params = convert.from_hf_gpt2(hf, device="cpu")
        prompt = np.array([[5, 9, 2, 66, 8, 1]], np.int32)
        with torch.no_grad():
            want = hf.generate(torch.tensor(prompt.astype(np.int64)),
                               max_new_tokens=6, do_sample=False,
                               pad_token_id=0)[0, 6:].numpy()
        got = decode.generate(cfg, params, torch.from_numpy(prompt), 6,
                              device="cpu")[0].numpy()
        np.testing.assert_array_equal(got, want)

    def test_roundtrip_export(self):
        """from_hf_gpt2 → to_hf_gpt2 reloads into HF with exact logits; the
        head is the embedding tensor itself."""
        a = _tiny_gpt2()
        cfg, params = convert.from_hf_gpt2(a, device="cpu")
        sd = convert.to_hf_gpt2(cfg, params)
        assert sd["lm_head.weight"] is sd["transformer.wte.weight"]
        b = transformers.GPT2LMHeadModel(a.config).eval()
        missing, unexpected = b.load_state_dict(sd, strict=False)
        assert not unexpected, unexpected
        assert all("attn.bias" in m or "masked_bias" in m
                   for m in missing), missing   # HF's causal-mask buffers
        tokens = TOKENS[:1]
        np.testing.assert_allclose(_hf_logits(b, tokens),
                                   _hf_logits(a, tokens), atol=1e-6)
        for name, t in a.state_dict().items():
            if name in sd:
                assert torch.equal(sd[name], t), name
        back = convert.params_from_hf_gpt2(sd, cfg, device="cpu")
        assert set(back) == set(params)
        for name, t in params.items():
            assert torch.equal(back[name], t), name

    def test_unsupported_configs_rejected(self):
        hf = _tiny_gpt2()
        hf.config.activation_function = "relu"
        with pytest.raises(ValueError, match="activation"):
            convert.config_from_hf_gpt2(hf.config)
        hf.config.activation_function = "gelu_new"
        hf.config.scale_attn_by_inverse_layer_idx = True
        with pytest.raises(ValueError, match="scale_attn"):
            convert.config_from_hf_gpt2(hf.config)
        hf.config.scale_attn_by_inverse_layer_idx = False
        hf.config.reorder_and_upcast_attn = True
        with pytest.raises(ValueError, match="reorder"):
            convert.config_from_hf_gpt2(hf.config)

    def test_namespace_config_needs_no_transformers(self):
        """A plain namespace with ``GPT2Config``'s documented defaults gives
        the config ``transformers``' own does: what the card's check drives
        the converters with."""
        ns = types.SimpleNamespace(
            vocab_size=50257, n_embd=768, n_layer=12, n_head=12,
            n_positions=1024, n_inner=None, layer_norm_epsilon=1e-5,
            activation_function="gelu_new")
        cfg = convert.config_from_hf_gpt2(ns)
        assert cfg == convert.config_from_hf_gpt2(transformers.GPT2Config())
        assert cfg == dataclasses.replace(TransformerConfig.gpt2_small(),
                                          use_bias=True, remat=False)

    def test_draft_from_hf_gpt2(self):
        hf = _tiny_gpt2()
        target = _tiny_llama()
        tcfg, _ = convert.from_hf_llama(target, device="cpu")
        dcfg, dparams = convert.draft_from_hf_gpt2(hf, tcfg, device="cpu")
        assert dcfg.vocab_size == tcfg.vocab_size and "pos_embed" in dparams
        with pytest.raises(ValueError, match="vocab"):
            convert.draft_from_hf_gpt2(
                hf, dataclasses.replace(tcfg, vocab_size=256), device="cpu")


class TestBert:
    """Encoder-family oracle: post-LN blocks, erf-gelu, token types, tied
    MLM decoder against ``transformers.BertForMaskedLM``."""

    @staticmethod
    def _hf(seed: int, **extra):
        hf_cfg = transformers.BertConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=128,
            max_position_embeddings=64, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0, **extra)
        torch.manual_seed(seed)
        return transformers.BertForMaskedLM(hf_cfg).eval()

    @staticmethod
    def _logits(cfg, params, tokens, types=None, mask=None) -> np.ndarray:
        from tpu_on_k8s_torch.models.bert import Bert
        from tpu_on_k8s_torch.models.params import load_module

        model = load_module(Bert(cfg), params, "cpu")
        with torch.no_grad():
            return model(*(None if a is None else torch.from_numpy(a)
                           for a in (tokens, types, mask))).numpy()

    def test_mlm_logits_match_hf(self):
        hf = self._hf(0, type_vocab_size=2)
        cfg, params = convert.from_hf_bert(hf, device="cpu")
        tokens = np.array([[3, 17, 95, 4, 88, 120, 7, 1]], np.int32)
        types = np.array([[0, 0, 0, 0, 1, 1, 1, 1]], np.int32)
        with torch.no_grad():
            want = hf(torch.tensor(tokens, dtype=torch.long),
                      token_type_ids=torch.tensor(types, dtype=torch.long)
                      ).logits.numpy()
        np.testing.assert_allclose(self._logits(cfg, params, tokens, types),
                                   want, atol=HF_ATOL, rtol=HF_RTOL)

    @pytest.mark.parametrize("impl", ["xla", "flash"])
    def test_padding_mask_matches_hf(self, impl):
        """Batched ragged encoder inputs: the padding attention_mask yields
        the same real-position logits HF computes, on the plain attention
        and on the flash path (the segments the reference builds)."""
        hf = self._hf(1)
        cfg, params = convert.from_hf_bert(hf, device="cpu")
        cfg = dataclasses.replace(cfg, attn_impl=impl)
        tokens = np.array([[3, 17, 95, 4, 0, 0, 0, 0],
                           [9, 2, 64, 31, 5, 77, 12, 40]], np.int32)
        mask = np.array([[1, 1, 1, 1, 0, 0, 0, 0],
                         [1, 1, 1, 1, 1, 1, 1, 1]], np.int32)
        with torch.no_grad():
            want = hf(torch.tensor(tokens, dtype=torch.long),
                      attention_mask=torch.tensor(mask, dtype=torch.long)
                      ).logits.numpy()
        got = self._logits(cfg, params, tokens, None, mask)
        # real positions agree; pad positions are model-undefined in HF too
        np.testing.assert_allclose(got[mask == 1], want[mask == 1],
                                   atol=HF_ATOL, rtol=HF_RTOL)

    def test_unsupported_configs_rejected(self):
        hf = transformers.BertForMaskedLM(transformers.BertConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, intermediate_size=64))
        hf.config.hidden_act = "relu"
        with pytest.raises(ValueError, match="hidden_act"):
            convert.from_hf_bert(hf, device="cpu")
        hf.config.hidden_act = "gelu"
        hf.config.position_embedding_type = "relative_key"
        with pytest.raises(ValueError, match="absolute"):
            convert.from_hf_bert(hf, device="cpu")
        hf.config.position_embedding_type = "absolute"
        hf.config.tie_word_embeddings = False
        with pytest.raises(ValueError, match="untied"):
            convert.from_hf_bert(hf, device="cpu")

    def test_port_and_jax_converted_models_agree(self):
        """The same HF model through both packages' ``from_hf_bert``: equal
        fp32 logits with types and a padding mask."""
        from tpu_on_k8s.models.bert import Bert as JBert

        hf = self._hf(2)
        cfg, params = convert.from_hf_bert(hf, device="cpu")
        jcfg, jparams = jconvert.from_hf_bert(hf)
        mask = np.ones_like(TOKENS)
        mask[0, 5:] = 0
        types = (np.arange(8)[None] >= 4).astype(np.int32).repeat(2, 0)
        want = np.asarray(JBert(jcfg).apply(
            {"params": jparams}, jnp.asarray(TOKENS), jnp.asarray(types),
            jnp.asarray(mask)))
        np.testing.assert_allclose(
            self._logits(cfg, params, TOKENS, types, mask), want,
            atol=FP32_ATOL, rtol=0)
        assert convert.config_from_hf_bert(types_namespace(
            hf.config)) == dataclasses.replace(cfg, dtype=torch.bfloat16)


def types_namespace(hf_config) -> types.SimpleNamespace:
    """A config object with only ``BertConfig``'s documented fields, as the
    card (no ``transformers``) would build one."""
    return types.SimpleNamespace(**{k: getattr(hf_config, k) for k in (
        "vocab_size", "hidden_size", "num_hidden_layers",
        "num_attention_heads", "intermediate_size",
        "max_position_embeddings", "type_vocab_size", "layer_norm_eps",
        "hidden_act", "position_embedding_type")})


# ---- the port against the JAX package's converters ----------------------------

@pytest.mark.parametrize("family", ["llama", "gpt2"])
def test_port_and_jax_converted_models_agree(family):
    """The same HF model through both packages' converters: equal fp32
    logits (the port's own tree held against the JAX package's
    ``from_hf_*`` and its ``Transformer``)."""
    hf = _tiny_llama(tie=True) if family == "llama" else _tiny_gpt2()
    port_from = getattr(convert, f"from_hf_{family}")
    jax_from = getattr(jconvert, f"from_hf_{family}")
    cfg, params = port_from(hf, device="cpu")
    jcfg, jparams = jax_from(hf)
    want = np.asarray(JTransformer(jcfg).apply({"params": jparams},
                                               jnp.asarray(TOKENS)))
    np.testing.assert_allclose(_port_logits(cfg, params, TOKENS), want,
                               atol=FP32_ATOL, rtol=0)
