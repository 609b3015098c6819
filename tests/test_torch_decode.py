"""The PyTorch port's serving path against the JAX package, on the CPU.

A ``TransformerConfig.tiny()`` model is initialised by the JAX package and
carried across with ``from_jax_params``; prompts come from a numpy seed.
Both packages then serve them: prefill and stepwise logits, greedy
``generate`` (token for token), the bucketed cache, the fused gate+up
layout, the config guards and the sampler.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.models import decode as jdecode
from tpu_on_k8s.models import sampling as jsampling
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s_torch import generate as cli
from tpu_on_k8s_torch.models import decode, params as pparams, sampling
from tpu_on_k8s_torch.models.transformer import TransformerConfig

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

# fp32 end to end: the two packages differ only in summation order.
FP32_ATOL = 1e-4
# bf16 weights and activations (fp32 logits), 2 layers. The tiny model's
# logits have a std of ~0.16 (max ~0.64); the two packages round to bf16 in
# different places and differ by 3.2e-3-3.7e-3 over init seeds 1-7, so the
# tolerance is ~2.5x that.
BF16_ATOL = 8e-3

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def _setup(**changes):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32, **changes)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jparams = JTransformer(jcfg).init(jax.random.key(1),
                                      jnp.asarray(tokens))["params"]
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, port_config(jcfg), tree, tokens


@pytest.fixture(scope="module")
def setup():
    return _setup()


@functools.lru_cache(maxsize=None)
def _jax_apply(jcfg):
    dm = jdecode.decode_model(jcfg)
    return dm, jax.jit(lambda params, cache, tok, pos: dm.apply(
        {"params": params, "cache": cache}, tok, pos, mutable=["cache"]))


def _jax_decode(jcfg, jparams, tokens, start_cache=None, positions=None):
    dm, apply = _jax_apply(jcfg)
    cache = (start_cache if start_cache is not None
             else jdecode.init_cache(dm, tokens.shape[0]))
    if positions is None:
        positions = np.broadcast_to(np.arange(tokens.shape[1]), tokens.shape)
    logits, upd = apply(jparams, cache, jnp.asarray(tokens),
                        jnp.asarray(positions, jnp.int32))
    return np.asarray(logits, np.float32), upd["cache"]


def _port_model(pcfg, params):
    model = decode.decode_model(pcfg, params, "cpu")
    return model, decode.init_cache(model, 2)


def test_param_names_cover_the_model(setup):
    jcfg, jparams, pcfg, tree, tokens = setup
    params = pparams.from_jax_params(tree, device="cpu")
    assert set(params) == set(pparams.param_shapes(pcfg))
    for name, shape in pparams.param_shapes(pcfg).items():
        assert params[name].shape == shape, name
    # a Flax kernel [in, out] becomes an nn.Linear weight [out, in]
    np.testing.assert_array_equal(
        params["blocks.1.attn.wk.weight"].numpy(),
        tree["blocks"]["attn"]["wk"]["kernel"][1].T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    """fp32 tables, half-split rotation, output in x's dtype."""
    from tpu_on_k8s.models.transformer import rope as jrope
    from tpu_on_k8s_torch.models.transformer import rope
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 9)).astype(np.int32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(jrope(jnp.asarray(x, jdt), jnp.asarray(pos), 10000.0),
                      np.float32)
    got = rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 10000.0)
    assert got.dtype == tdt
    # fp32: the two libraries' sin/cos of angles up to ~4e3 rad differ in
    # the last bits; bf16: at most one rounding step (1/64 below |x| = 4)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-5 if dtype == "float32" else 1.6e-2,
                               rtol=0)


def test_prefill_logits_match_jax(setup):
    jcfg, jparams, pcfg, tree, tokens = setup
    want, _ = _jax_decode(jcfg, jparams, tokens)
    model, cache = _port_model(pcfg, pparams.from_jax_params(tree,
                                                             device="cpu"))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), None, cache)
    assert got.dtype == torch.float32 and cache[0].index == tokens.shape[1]
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


def test_stepwise_decode_logits_match_jax(setup):
    """Prefill 8 tokens, then feed the rest one at a time through the cache
    (the over-cache path); every step's logits agree."""
    jcfg, jparams, pcfg, tree, tokens = setup
    model, cache = _port_model(pcfg, pparams.from_jax_params(tree,
                                                             device="cpu"))
    _, jcache = _jax_decode(jcfg, jparams, tokens[:, :8])
    with torch.no_grad():
        model(torch.from_numpy(tokens[:, :8]), None, cache)
        for i in range(8, 14):
            pos = np.full((2, 1), i, np.int32)
            want, jcache = _jax_decode(jcfg, jparams, tokens[:, i:i + 1],
                                       jcache, pos)
            got = model(torch.from_numpy(tokens[:, i:i + 1]),
                        torch.from_numpy(pos), cache)
            np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL,
                                       rtol=0, err_msg=f"step {i}")


def test_chunked_prefill_into_nonempty_cache_matches_jax(setup):
    """A multi-token call at a nonzero cursor attends over the cache, not
    among its own tokens; both packages take that path."""
    jcfg, jparams, pcfg, tree, tokens = setup
    model, cache = _port_model(pcfg, pparams.from_jax_params(tree,
                                                             device="cpu"))
    pos = np.broadcast_to(np.arange(24), (2, 24))
    _, jcache = _jax_decode(jcfg, jparams, tokens[:, :10], None, pos[:, :10])
    want, _ = _jax_decode(jcfg, jparams, tokens[:, 10:], jcache, pos[:, 10:])
    with torch.no_grad():
        model(torch.from_numpy(tokens[:, :10]), None, cache)
        got = model(torch.from_numpy(tokens[:, 10:]),
                    torch.from_numpy(np.ascontiguousarray(pos[:, 10:])), cache)
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)


@pytest.mark.parametrize("prompt_len, new", [(8, 12), (24, 9)])
def test_greedy_generate_token_identity(setup, prompt_len, new):
    jcfg, jparams, pcfg, tree, tokens = setup
    prompt = tokens[:, :prompt_len]
    want = np.asarray(jdecode.generate(jcfg, jparams, jnp.asarray(prompt),
                                       new))
    got = decode.generate(pcfg, pparams.from_jax_params(tree, device="cpu"),
                          torch.from_numpy(prompt), new, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucketed_cache_matches_full_length_cache(setup):
    jcfg, jparams, pcfg, tree, tokens = setup
    assert decode._bucket_len(16, 512) == 128
    assert decode._bucket_len(200, 512) == 256
    assert decode._bucket_len(600, 512) == 512   # capped at the model max
    params = pparams.from_jax_params(tree, device="cpu")
    prompt = torch.from_numpy(tokens[:, :10])
    got = decode.generate(dataclasses.replace(pcfg, max_seq_len=512), params,
                          prompt, 6, device="cpu")        # cache 128
    want = decode.generate(dataclasses.replace(pcfg, max_seq_len=16), params,
                           prompt, 6, device="cpu")       # no slack
    assert torch.equal(got, want)


def test_fused_gateup_layout_matches_jax():
    jcfg, jparams, pcfg, tree, tokens = _setup(mlp_fused_gateup=True)
    assert "w_gateup" in tree["blocks"]["mlp"]
    params = pparams.from_jax_params(tree, device="cpu")
    assert "blocks.0.mlp.w_gateup.weight" in params
    want_logits, _ = _jax_decode(jcfg, jparams, tokens)
    model, cache = _port_model(pcfg, params)
    with torch.no_grad():
        got_logits = model(torch.from_numpy(tokens), None, cache)
    np.testing.assert_allclose(got_logits.numpy(), want_logits,
                               atol=FP32_ATOL, rtol=0)
    want = np.asarray(jdecode.generate(jcfg, jparams,
                                       jnp.asarray(tokens[:, :8]), 8))
    got = decode.generate(pcfg, params, torch.from_numpy(tokens[:, :8]), 8,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_prefill_logits_match_jax(setup):
    """bf16 serving: the JAX model casts its fp32 master weights to bf16 at
    every call; the port stores them in bf16. Same numbers, bf16 rounding
    in different places."""
    jcfg, jparams, pcfg, tree, tokens = setup
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    want, _ = _jax_decode(jcfg, jparams, tokens)
    params = pparams.from_jax_params(tree, dtype=torch.bfloat16,
                                     device="cpu")
    assert params["blocks.0.attn.wq.weight"].dtype == torch.bfloat16
    assert params["blocks.0.attn_norm.scale"].dtype == torch.float32
    model, cache = _port_model(pcfg, params)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), None, cache)
    assert cache[0].k.dtype == torch.bfloat16 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)


def test_overflow_raises(setup):
    jcfg, jparams, pcfg, tree, tokens = setup
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        decode.generate(pcfg, pparams.from_jax_params(tree, device="cpu"),
                        torch.from_numpy(tokens), 1000, device="cpu")


@pytest.mark.parametrize("flag, value", [
    ("decode_multislot", True), ("cache_int8", True),
    ("fused_qkv", True), ("n_experts", 4),
    ("pos_emb", "learned"), ("norm", "ln"), ("activation", "gelu"),
    ("tie_embeddings", True), ("use_bias", True), ("attn_impl", "ring"),
])
def test_unported_flags_raise(flag, value):
    cfg = dataclasses.replace(TransformerConfig.tiny(), **{flag: value})
    with pytest.raises(NotImplementedError, match=flag):
        decode.decode_model(cfg, {}, "cpu")


@pytest.mark.parametrize("flag, value", [
    ("remat_policy", "dots"), ("remat_policy", "dots_kernels"),
    ("fused_qkv", True), ("attn_impl", "ulysses"),
])
def test_unported_training_flags_raise(flag, value):
    from tpu_on_k8s_torch.models.transformer import Transformer
    cfg = dataclasses.replace(TransformerConfig.tiny(), remat=True,
                              **{flag: value})
    with pytest.raises(NotImplementedError, match=flag):
        Transformer(cfg)


# ---- sampling ----------------------------------------------------------

def _logits_with_ties(seed=0):
    rng = np.random.default_rng(seed)
    # few distinct values: many ties, across and inside the top k
    return rng.integers(0, 6, (4, 32)).astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 7, 40])
def test_top_k_mask_matches_jax_with_ties(k):
    x = _logits_with_ties()
    want = np.asarray(jsampling._top_k_mask(jnp.asarray(x), k))
    got = sampling._top_k_mask(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.1, 0.5, 0.9, 1.0])
def test_top_p_mask_matches_jax(p):
    rng = np.random.default_rng(1)
    for x in (rng.standard_normal((4, 64)).astype(np.float32) * 3,
              _logits_with_ties(2)):
        want = np.asarray(jsampling._top_p_mask(jnp.asarray(x), p))
        got = sampling._top_p_mask(torch.from_numpy(x), p).numpy()
        np.testing.assert_array_equal(got, want)


def test_top_k_1_sampling_is_greedy():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 100)).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    sp = sampling.SamplingParams(temperature=0.7, top_k=1)
    for _ in range(5):
        assert torch.equal(sampling.sample(x, gen, sp),
                           x.argmax(-1).to(torch.int32))


def test_sampled_tokens_in_range_and_follow_the_distribution():
    """Gumbel-max draws: in range, never a masked token, and frequencies
    near softmax(logits / temperature) (bits differ from JAX's draws, so
    the distribution is what is compared)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0, -3.0]])
    sp = sampling.SamplingParams(temperature=0.8, top_k=4)
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sampling.sample(logits, gen, sp)
                         for _ in range(4000)]).flatten()
    assert draws.min() >= 0 and draws.max() <= 3   # token 4 masked by top_k
    freq = torch.bincount(draws, minlength=5).float() / draws.numel()
    want = torch.softmax(torch.tensor([2.0, 1.0, 0.0, -1.0]) / 0.8, 0)
    assert (freq[:4] - want).abs().max() < 0.03    # ~4 sigma at n=4000
    assert freq[4] == 0


def test_sampled_generate_shapes_and_bounds(setup):
    jcfg, jparams, pcfg, tree, tokens = setup
    out = decode.generate(pcfg, pparams.from_jax_params(tree, device="cpu"),
                          torch.from_numpy(tokens[:, :4]), 5,
                          temperature=0.8, top_p=0.9,
                          generator=torch.Generator().manual_seed(7),
                          device="cpu")
    assert out.shape == (2, 5)
    assert (out >= 0).all() and (out < pcfg.vocab_size).all()
    none = decode.generate(pcfg, pparams.from_jax_params(tree, device="cpu"),
                           torch.from_numpy(tokens[:, :4]), 0, device="cpu")
    assert none.shape == (2, 0)       # as the reference's empty scan


@pytest.mark.parametrize("bad", [dict(top_k=-1), dict(top_p=1.5)])
def test_sampling_params_validate(bad):
    with pytest.raises(ValueError):
        sampling.SamplingParams(**bad)


def test_cli_generates_on_cpu(capsys):
    out = cli.main(["--config", "tiny", "--device", "cpu", "--batch", "2",
                    "--prompt-len", "5", "--max-new-tokens", "4"])
    assert out.shape == (2, 4)
    assert "continuation[1]:" in capsys.readouterr().out


def test_init_params_are_seeded_and_flax_shaped():
    cfg = TransformerConfig.tiny()
    a = pparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = pparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert a["embed"].dtype == cfg.dtype and a["final_norm.scale"].dtype == torch.float32
    assert torch.equal(a["blocks.0.attn_norm.scale"], torch.ones(cfg.d_model))
    std = a["blocks.0.mlp.w_up.weight"].float().std().item()
    assert abs(std - 0.02) < 0.002
