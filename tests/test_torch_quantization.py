"""The PyTorch port's quantization against the JAX package's, on the CPU:
``quantize_int8`` / ``dequantize_int8`` and the pytree pair
(``ops/quantization.py``), the W8A16 serving tree
(``decode.quantize_weights_for_serving``, ``convert.quantize_serving_tree``),
W8A16 ``generate`` and ``from_jax_params`` on an int8 tree.

The reference's stochastic quantizer draws the TPU's random bits, which the
port cannot reproduce (and which, in interpret mode, repeat on every row),
so its values are compared as distributions and by their rounding rule,
never bit for bit; its scales, the dequantizer and the deterministic
serving quantizer are compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.models import convert as jconvert
from tpu_on_k8s.models import decode as jdecode
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s.ops import quantization as jquant
from tpu_on_k8s_torch.models import convert, decode, params as pparams
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.ops import quantization as quant

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def _normal(shape, seed, scale=1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---- quantize_int8 / dequantize_int8 -------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scales_are_bit_identical_to_jax(dtype):
    x = _normal((300, 96), 0, 3.0)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    jx = jnp.asarray(x, jdt)
    _, jscales = jquant.quantize_int8(jx, seed=1)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(tdt)
    values, scales = quant.quantize_int8(tx, seed=1)
    assert values.dtype == torch.int8 and scales.shape == (300, 1)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))


@pytest.mark.parametrize("seed", [0, 5, 2 ** 40 + 7])
def test_values_are_a_floor_or_ceil_of_x_over_scale(seed):
    x = torch.from_numpy(_normal((64, 200), 1))
    x[3] = 0.0                                    # an all-zero row
    values, scales = quant.quantize_int8(x, seed=seed)
    scaled = x / scales
    v = values.float()
    assert torch.all((v == torch.floor(scaled)) | (v == torch.ceil(scaled)))
    assert torch.all(values[3] == 0)
    # the row's largest |x| maps to exactly ±127
    assert torch.equal(values.abs().amax(dim=1)[x.abs().amax(dim=1) > 0],
                       torch.full((63,), 127, dtype=torch.int8))


def test_stochastic_rounding_is_unbiased():
    """As the reference's test: 64 quantizations of a constant, one seed
    each, average to the truth within a quarter of a step."""
    x = torch.full((8, 128), 0.4217)
    x[:, 0] = 1.0              # the row scale is 1/127: 0.4217 is 53.56 steps
    acc = torch.zeros(8, 128, dtype=torch.float64)
    for seed in range(64):
        v, s = quant.quantize_int8(x, seed=seed)
        acc += quant.dequantize_int8(v, s).double()
    mean = acc / 64
    assert (mean - x.double()).abs().max().item() < 0.25 / 127
    # and the fraction is kept: both neighbours occur
    v, _ = quant.quantize_int8(x, seed=0)
    assert set(v[:, 1:].unique().tolist()) == {53, 54}


def test_jax_rounding_follows_the_same_rule():
    """The reference's values (TPU bits) obey the rule the port's do."""
    x = _normal((256, 128), 2)
    jv, js = jquant.quantize_int8(jnp.asarray(x), seed=4)
    scaled = x / np.asarray(js)
    jv = np.asarray(jv, np.float32)
    assert np.all((jv == np.floor(scaled)) | (jv == np.ceil(scaled)))


def test_extreme_values_saturate_cleanly():
    x = torch.tensor([[0.0] * 128, [1000.0] * 128, [-1000.0] * 128])
    v, s = quant.quantize_int8(x)
    back = quant.dequantize_int8(v, s)
    assert torch.all(back[0] == 0.0)
    np.testing.assert_allclose(back[1].numpy(), 1000.0, rtol=1e-2)
    assert torch.all(v[1] == 127) and torch.all(v[2] == -127)
    assert s[0, 0].item() == np.float32(1e-30) * (np.float32(1) /
                                                  np.float32(127))


def test_philox_bits_are_deterministic_per_seed():
    x = torch.from_numpy(_normal((33, 77), 3))
    a, b = quant.quantize_int8(x, seed=9), quant.quantize_int8(x, seed=9)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = quant.quantize_int8(x, seed=10)
    assert not torch.equal(a[0], c[0])
    # Random123's known answer for Philox4x32-10 at counter 0, key 0
    assert quant._philox_bits(4, 0, "cpu").tolist() == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    # every element has its own bits: rows differ for equal inputs (unlike
    # the reference's interpret mode, which repeats its bits on every row)
    same = torch.full((64, 128), 0.3)
    same[:, 0] = 1.0
    v, _ = quant.quantize_int8(same, seed=3)
    assert len({tuple(r) for r in v.tolist()}) == 64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_is_bit_identical_to_jax(dtype):
    rng = np.random.default_rng(4)
    values = rng.integers(-127, 128, (96, 160)).astype(np.int8)
    scales = np.abs(_normal((96, 1), 5, 0.01)) + 1e-4
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = jquant.dequantize_int8(jnp.asarray(values), jnp.asarray(scales),
                                  dtype=jdt)
    got = quant.dequantize_int8(torch.from_numpy(values),
                                torch.from_numpy(scales), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_pytree_roundtrip():
    tree = {"w": torch.from_numpy(_normal((64, 32), 0)),
            "b": torch.ones(32),                       # 1-D stays raw
            "deep": torch.from_numpy(_normal((4, 16, 32), 1)),
            "half": torch.from_numpy(_normal((8, 16), 2)).to(torch.bfloat16),
            "ids": torch.arange(12).reshape(3, 4)}     # not float: raw
    q = quant.quantize_pytree(tree, seed=3)
    assert q["b"][0] == "raw" and q["ids"][0] == "raw"
    assert q["w"][0] == "q8" and q["w"][1][0].dtype == torch.int8
    back = quant.dequantize_pytree(q)
    assert back["b"] is tree["b"] and back["ids"] is tree["ids"]
    for key in ("w", "deep", "half"):
        assert back[key].shape == tree[key].shape
        assert back[key].dtype == tree[key].dtype
        values, scales, _, _ = q[key][1]
        x = tree[key].float().reshape(-1, tree[key].shape[-1])
        err = (back[key].float().reshape(x.shape) - x).abs()
        # at most one quantization step per row, plus the rounding of the
        # result to its dtype (2⁻⁸ of |x| for bf16)
        cast = 2.0 ** -8 if tree[key].dtype == torch.bfloat16 else 1e-6
        assert torch.all(err <= scales + cast * x.abs())
    raw = sum(t.numel() * 4 for t in (tree["w"], tree["deep"]))
    packed = sum(q[k][1][0].numel() + q[k][1][1].numel() * 4
                 for k in ("w", "deep"))
    assert packed < raw / 3.5        # 32-wide rows: one fp32 scale per 32


# ---- W8A16 serving ------------------------------------------------------

def _w8_setup(dtype=jnp.float32):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    jparams = JTransformer(jcfg).init(jax.random.key(1),
                                      jnp.asarray(tokens))["params"]
    return jcfg, jparams, jax.tree.map(np.asarray, jparams), tokens


@pytest.fixture(scope="module")
def w8():
    return _w8_setup()


def test_serving_quantizer_is_bit_identical_to_jax(w8):
    jcfg, jparams, tree, _ = w8
    jq = jax.tree.map(np.asarray,
                      jdecode.quantize_weights_for_serving(jparams))
    got = decode.quantize_weights_for_serving(
        pparams.from_jax_params(tree, device="cpu"))
    # the reference's int8 tree carried across is the port's own
    want = pparams.from_jax_params(jq, device="cpu")
    assert set(got) == set(want)
    assert set(got) == set(pparams.param_shapes(
        port_config(dataclasses.replace(jcfg, serve_int8_weights=True))))
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        assert torch.equal(got[name], t), name
    assert got["blocks.0.attn.wq.weight_q"].dtype == torch.int8
    assert got["blocks.1.mlp.w_down.weight_scale"].dtype == torch.float32
    assert got["lm_head_q"].shape == (64, 256)
    assert got["lm_head_scale"].shape == (256,)


def test_w8_greedy_generate_token_identity(w8):
    jcfg, jparams, tree, tokens = w8
    wcfg = dataclasses.replace(jcfg, serve_int8_weights=True)
    jq = jdecode.quantize_weights_for_serving(jparams)
    want = np.asarray(jdecode.generate(wcfg, jq, jnp.asarray(tokens), 10))
    params = decode.quantize_weights_for_serving(
        pparams.from_jax_params(tree, device="cpu"))
    got = decode.generate(port_config(wcfg), params, torch.from_numpy(tokens),
                          10, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


# W8A16 prefill logits, fp32 activations: the packages differ in summation
# order only (the int8 weights and fp32 scales are identical); measured
# 2.1e-7 on logits of std ~0.15, the tolerance is ~5x that. Against the
# unquantized model the reference's own gate holds: rel max error < 0.05
# (measured 9.9e-3).
W8_LOGITS_ATOL = 1e-6


def test_w8_prefill_logits_match_jax_and_the_gate(w8):
    jcfg, jparams, tree, tokens = w8
    wcfg = dataclasses.replace(jcfg, serve_int8_weights=True)
    jq = jdecode.quantize_weights_for_serving(jparams)
    dm = jdecode.decode_model(wcfg)
    pos = jnp.broadcast_to(jnp.arange(12), (2, 12))
    want, _ = dm.apply({"params": jq, "cache": jdecode.init_cache(dm, 2)},
                       jnp.asarray(tokens), pos, mutable=["cache"])
    model = decode.decode_model(port_config(wcfg), pparams.from_jax_params(
        jax.tree.map(np.asarray, jq), device="cpu"), "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), None,
                    decode.init_cache(model, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=W8_LOGITS_ATOL, rtol=0)
    full = decode.decode_model(port_config(jcfg), pparams.from_jax_params(
        tree, device="cpu"), "cpu")
    with torch.no_grad():
        ref = full(torch.from_numpy(tokens), None, decode.init_cache(full, 2))
    rel = (got - ref).abs().max() / ref.abs().max()
    assert rel < 0.05, rel


def test_bf16_w8_prefill_logits_near_jax(w8):
    """bf16 activations over int8 weights: the two packages round to bf16
    in different places; measured 3.3e-3, held to test_torch_decode.py's
    bf16 tolerance (8e-3)."""
    jcfg, jparams, tree, tokens = w8
    wcfg = dataclasses.replace(jcfg, serve_int8_weights=True,
                               dtype=jnp.bfloat16)
    jq = jdecode.quantize_weights_for_serving(jparams)
    dm = jdecode.decode_model(wcfg)
    pos = jnp.broadcast_to(jnp.arange(12), (2, 12))
    want, _ = dm.apply({"params": jq, "cache": jdecode.init_cache(dm, 2)},
                       jnp.asarray(tokens), pos, mutable=["cache"])
    model = decode.decode_model(port_config(wcfg), pparams.from_jax_params(
        jax.tree.map(np.asarray, jq), torch.bfloat16, "cpu"), "cpu")
    assert model.blocks[0].attn.wq.weight_q.dtype == torch.int8
    assert model.embed.dtype == torch.bfloat16
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), None,
                    decode.init_cache(model, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=8e-3,
                               rtol=0)


def test_stochastic_serving_tree(w8):
    jcfg, _, tree, tokens = w8
    cfg = port_config(jcfg)
    params = pparams.from_jax_params(tree, device="cpu")
    icfg, iparams = convert.quantize_serving_tree(cfg, params,
                                                  stochastic=True, seed=7)
    dcfg, det = convert.quantize_serving_tree(cfg, params)
    assert icfg == dcfg and icfg.serve_int8_weights
    assert {n: (t.shape, t.dtype) for n, t in iparams.items()} == {
        n: (t.shape, t.dtype) for n, t in det.items()}
    # the reference's bound, and its structure for the same source tree
    jq = jconvert.quantize_serving_tree(jcfg, jax.tree.map(
        jnp.asarray, tree))[1]
    assert set(pparams.from_jax_params(jax.tree.map(np.asarray, jq),
                                       device="cpu")) == set(iparams)
    for name in ("blocks.0.attn.wq", "blocks.1.mlp.w_gate"):
        w = params[f"{name}.weight"]
        q, s = iparams[f"{name}.weight_q"], iparams[f"{name}.weight_scale"]
        assert q.dtype == torch.int8 and s.shape == (w.shape[0],)
        back = q.float() * s[:, None]
        assert (back - w).abs().max() <= w.abs().max() / 60
        assert not torch.equal(q, det[f"{name}.weight_q"])   # rounded at random
    w = params["lm_head"]
    back = iparams["lm_head_q"].float() * iparams["lm_head_scale"]
    assert (back - w).abs().max() <= w.abs().max() / 60
    out = decode.generate(icfg, iparams, torch.from_numpy(tokens), 4,
                          device="cpu")
    assert out.shape == (2, 4) and (out >= 0).all() and (out < 256).all()
    with pytest.raises(ValueError, match="already int8"):
        convert.quantize_serving_tree(icfg, iparams)


def test_w8_config_errors():
    cfg = dataclasses.replace(TransformerConfig.tiny(),
                              serve_int8_weights=True)
    from tpu_on_k8s_torch.models.transformer import Transformer
    with pytest.raises(ValueError, match="serving"):
        Transformer(cfg)                                # training model
    for bad in (dict(fused_qkv=True), dict(n_experts=4)):
        with pytest.raises(ValueError, match="fused_qkv or MoE"):
            decode.decode_model(dataclasses.replace(cfg, **bad), {}, "cpu")
    with pytest.raises(ValueError, match="use_bias"):
        decode.decode_model(dataclasses.replace(cfg, use_bias=True), {},
                            "cpu")
    with pytest.raises(ValueError, match="int8 serving covers"):
        convert.quantize_serving_tree(
            dataclasses.replace(TransformerConfig.tiny(), fused_qkv=True), {})


def test_w8_init_params_and_load_model_keep_int8():
    cfg = dataclasses.replace(TransformerConfig.tiny(),
                              serve_int8_weights=True)
    params = pparams.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    assert params["blocks.0.mlp.w_up.weight_q"].dtype == torch.int8
    assert params["lm_head_scale"].dtype == torch.float32
    assert "lm_head" not in params
    model = decode.decode_model(cfg, params, "cpu")
    assert model.lm_head_q.dtype == torch.int8
    assert model.blocks[1].attn.wo.weight_scale.dtype == torch.float32
    bad = dict(params, lm_head_q=params["lm_head_q"].float())
    with pytest.raises(ValueError, match="lm_head_q"):
        decode.decode_model(cfg, bad, "cpu")
