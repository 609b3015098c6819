"""The PyTorch port's int8 KV cache (``cache_int8``) against the JAX package,
on the CPU.

The cache quantizer must be the reference's bit for bit: its scale is the
fp32 absmax times fp32(1/127), the product XLA makes of ``max|x| / 127.0``
under ``jit`` (every serving path of the reference is jitted), and the
values a true division rounded half to even. The cache leaves, their
dtypes and bytes are the reference's; a prefill off the int8 cache equals
the fp cache's (it attends among the prompt), a decode step equals the JAX
int8 model's. ``generate``, ``speculative_generate`` and the
continuous-batching engine (dense, paged, chunked, prefix, horizon, W8A16,
speculative) give the JAX package's greedy tokens with ``cache_int8``, and
a handoff sealed by the JAX engine from an int8 cache verifies in the port
with its digest and decodes to the JAX engine's tokens; so do migrations
and exported prefixes.

A ``TransformerConfig.tiny()`` model (fp32 unless stated, ``max_seq_len``
64) is initialised by the JAX package and carried across with
``from_jax_params``; inputs come from numpy seeds, decoding is greedy. The
JAX engines are built once per module.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.models import decode as jdecode
from tpu_on_k8s.models.serving import ContinuousBatchingEngine as JEngine
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s_torch.models import decode
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.serving import (
    ContinuousBatchingEngine,
    KVHandoff,
)
from tpu_on_k8s_torch.models.transformer import (
    TransformerConfig,
    dequantize_kv,
    quantize_kv,
)

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

#: tiny-config page size (16 divides max_len 64 and the 128-token granule)
PAGE = 16
#: the int8 cache's leaves in the reference's flatten order
INT8_LEAVES = ["k", "k_scale", "v", "v_scale"]
#: tolerance of a logit computed by both packages in fp32
FP32_ATOL = 1e-5


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def jax_init(jcfg: JConfig, seed: int = 1):
    tok = jax.random.randint(jax.random.key(0), (1, 8), 0, jcfg.vocab_size,
                             jnp.int32)
    jparams = JTransformer(jcfg).init(jax.random.key(seed), tok)["params"]
    return jparams, pparams.from_jax_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


@functools.partial(jax.jit, static_argnums=0)
def jax_apply(model, params, cache, tokens, positions):
    """The reference's decode model under ``jit``, as its serving runs."""
    return model.apply({"params": params, "cache": cache}, tokens,
                       positions, mutable=["cache"])


def reference_quantize(x):
    """The reference cache's quantizer, as ``_cached_attention`` writes it
    (``tpu_on_k8s/models/transformer.py``)."""
    s = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1) / 127.0
    safe = jnp.maximum(s, 1e-9)
    q8 = jnp.round(x.astype(jnp.float32) / safe[..., None])
    return q8.astype(jnp.int8), s.astype(jnp.float32)


def _pool(kw: dict) -> dict:
    kw = dict(kw)
    kw.setdefault("n_slots", 2)
    if kw.pop("paged", False):
        kw.update(kv_pages=24, page_tokens=PAGE)
    return kw


@dataclasses.dataclass
class Setup:
    jcfg: JConfig
    jparams: dict
    pcfg: TransformerConfig
    params: dict
    jax_engines: dict

    def engine(self, **kw) -> ContinuousBatchingEngine:
        return ContinuousBatchingEngine(self.pcfg, self.params, device="cpu",
                                        **_pool(kw))

    def jax_engine(self, role: str = "", **kw) -> JEngine:
        """One JAX engine per role and configuration for the whole
        module."""
        key = (role, *sorted(kw.items()))
        if key not in self.jax_engines:
            self.jax_engines[key] = JEngine(self.jcfg, self.jparams,
                                            **_pool(kw))
        return self.jax_engines[key]

    def drafts(self):
        """(port draft, JAX draft), each (cfg, params): the first layer,
        which keeps the target's ``cache_int8``."""
        return (decode.truncated_draft(self.pcfg, self.params, 1),
                jdecode.truncated_draft(self.jcfg, self.jparams, 1))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               max_seq_len=64, cache_int8=True)
    jparams, params = jax_init(jcfg)
    return Setup(jcfg, jparams, port_config(jcfg), params, {})


def prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in sizes]


def want_generate(setup, prompt, n) -> np.ndarray:
    """The JAX int8 ``generate`` oracle: the request's greedy
    continuation."""
    return np.asarray(jdecode.generate(
        setup.jcfg, setup.jparams, jnp.asarray(prompt, jnp.int32)[None],
        max_new_tokens=n))[0]


# ---- the quantizer -----------------------------------------------------------

def _rows(dtype, seed=0):
    """[4, 64, 8, 128] fp32 normals of mixed magnitudes (llama2_7b's head
    width), one all-zero row, in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 64, 8, 128)).astype(np.float32)
    x *= rng.uniform(0.01, 30.0, size=(4, 64, 8, 1)).astype(np.float32)
    x[1, 3, 5] = 0.0
    return jnp.asarray(x, dtype)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_quantizer_matches_the_jitted_reference(dtype):
    """``quantize_kv`` equals the reference's quantizer under ``jit`` bit
    for bit: the int8 values and the fp32 scales' bytes, a zero row
    keeping scale 0 (the 1e-9 floor divides, it is not stored)."""
    x = _rows(dtype)
    want_q, want_s = jax.jit(reference_quantize)(x)
    got_q, got_s = quantize_kv(torch.from_numpy(np.array(
        x.astype(jnp.float32))).to(_DTYPES[dtype]))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  np.asarray(want_s).view(np.uint32))
    assert got_s[1, 3, 5] == 0 and not got_q[1, 3, 5].any()
    # the read: int8 · scale in fp32, then the model's dtype
    back = dequantize_kv(got_q, got_s, _DTYPES[dtype])
    want = (np.asarray(want_q, np.float32)
            * np.asarray(want_s)[..., None])
    np.testing.assert_array_equal(
        back.float().numpy(),
        np.asarray(jnp.asarray(want).astype(dtype).astype(jnp.float32)))


def test_the_jitted_scale_is_the_reciprocal_product():
    """The hazard the port follows: under ``jit`` XLA evaluates ``max|x| /
    127.0`` as ``max|x| · fp32(1/127)``, which differs from the true
    division in some rows; eagerly the reference divides."""
    x = _rows(jnp.float32, seed=1)
    absmax = np.abs(np.asarray(x)).max(axis=-1)
    product = absmax * np.float32(1.0 / 127.0)
    quotient = absmax / np.float32(127.0)
    jitted = np.asarray(jax.jit(reference_quantize)(x)[1])
    eager = np.asarray(reference_quantize(x)[1])
    np.testing.assert_array_equal(jitted, product)
    np.testing.assert_array_equal(eager, quotient)
    assert (product != quotient).any()
    np.testing.assert_array_equal(quantize_kv(torch.from_numpy(
        np.array(x)))[1].numpy(), product)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_quantizer_matches_the_reference_cache(dtype):
    """The reference's own int8 cache: a jitted prefill of the JAX int8
    model stores exactly ``quantize_kv`` of the keys and values its fp
    twin caches, leaf by leaf."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=dtype)
    jparams, _ = jax_init(jcfg, seed=2)
    tokens = jnp.asarray(np.random.default_rng(3).integers(0, 256, (2, 12)),
                         jnp.int32)
    positions = jnp.broadcast_to(jnp.arange(12), (2, 12))
    caches = {}
    for int8 in (False, True):
        model = jdecode.decode_model(
            dataclasses.replace(jcfg, cache_int8=int8))
        _, upd = jax_apply(model, jparams, jdecode.init_cache(model, 2),
                           tokens, positions)
        caches[int8] = jax.tree.map(np.asarray, upd["cache"]["blocks"]
                                    ["attn"])
    for name in ("k", "v"):
        fp = caches[False][name]
        q, s = quantize_kv(torch.from_numpy(fp.astype(np.float32)).to(
            _DTYPES[dtype]))
        np.testing.assert_array_equal(q.numpy(), caches[True][name])
        np.testing.assert_array_equal(
            s.numpy().view(np.uint32),
            caches[True][f"{name}_scale"].view(np.uint32))


# ---- the cache ---------------------------------------------------------------

def test_cache_leaves_and_bytes(setup):
    """``init_cache`` builds the reference's leaves (``k, k_scale, v,
    v_scale``, its cursorless flatten order), dtypes and shapes, at under
    0.65 of the fp cache's bytes; at llama2_7b width (Dh 128) an 8-slot
    2048-position pool is (128 + 4) / 256 of bf16."""
    model = decode.decode_model(setup.pcfg, setup.params, "cpu")
    shapes = decode.cache_shapes(model, 2)
    jmodel = jdecode.decode_model(setup.jcfg)
    jcache = jdecode.init_cache(jmodel, 2)["blocks"]["attn"]
    assert list(shapes) == INT8_LEAVES == [n for n in sorted(jcache)
                                           if n != "index"]
    torch_of = {np.dtype(np.int8): torch.int8,
                np.dtype(np.float32): torch.float32}
    for name, (shape, dtype) in shapes.items():
        assert shape == jcache[name].shape
        assert dtype == torch_of[jcache[name].dtype]
    cache = decode.init_cache(model, 2)
    assert len(cache) == setup.pcfg.n_layers and cache[0].int8
    assert cache[0].k.dtype == cache[0].v.dtype == torch.int8
    assert cache[0].k_scale.shape == (2, 64, 2)

    def nbytes(cfg, batch, length):
        shapes = decode.cache_shapes(types.SimpleNamespace(cfg=cfg), batch,
                                     length)
        return sum(np.prod(shape) * torch.empty(0, dtype=dtype).element_size()
                   for shape, dtype in shapes.values())

    fp = dataclasses.replace(setup.pcfg, cache_int8=False)
    assert nbytes(setup.pcfg, 2, 64) < 0.65 * nbytes(fp, 2, 64)
    assert nbytes(setup.pcfg, 2, 64) == 20 / 64 * nbytes(fp, 2, 64)
    big = TransformerConfig.llama2_7b()
    assert nbytes(big, 8, 2048) == 2_147_483_648
    assert nbytes(dataclasses.replace(big, cache_int8=True), 8,
                  2048) == 1_107_296_256
    assert nbytes(dataclasses.replace(big, cache_int8=True), 1,
                  1024) == 69_206_016


def test_cache_must_match_the_config(setup):
    """A model refuses a cache of the other layout."""
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    q8 = decode.decode_model(setup.pcfg, setup.params, "cpu")
    fp = decode.decode_model(dataclasses.replace(setup.pcfg,
                                                 cache_int8=False),
                             setup.params, "cpu")
    for model, other in ((q8, fp), (fp, q8)):
        with pytest.raises(ValueError, match="cache_int8"):
            model(tokens, None, decode.init_cache(other, 1))


def test_prefill_and_step_against_jax(setup):
    """The prefill off the int8 cache equals the fp cache's (it attends
    among the prompt); one decode step off it equals the JAX int8 model's
    under ``jit`` and stays within the reference's rel 0.05 of the fp
    cache's step."""
    tokens = np.random.default_rng(4).integers(0, 256, (2, 12)).astype(
        np.int32)
    nxt = np.full((2, 1), 3, np.int32)
    pos = np.full((2, 1), 12, np.int32)
    got = {}
    for int8 in (False, True):
        model = decode.decode_model(
            dataclasses.replace(setup.pcfg, cache_int8=int8), setup.params,
            "cpu")
        cache = decode.init_cache(model, 2)
        with torch.inference_mode():
            pre = model(torch.from_numpy(tokens), None, cache)
            step = model(torch.from_numpy(nxt), torch.from_numpy(pos), cache)
        got[int8] = (pre.numpy(), step.numpy())
    np.testing.assert_allclose(got[True][0], got[False][0], atol=1e-5,
                               rtol=0)

    jmodel = jdecode.decode_model(setup.jcfg)
    positions = jnp.broadcast_to(jnp.arange(12), (2, 12))
    jpre, upd = jax_apply(jmodel, setup.jparams,
                          jdecode.init_cache(jmodel, 2), jnp.asarray(tokens),
                          positions)
    jstep, _ = jax_apply(jmodel, setup.jparams, upd["cache"],
                         jnp.asarray(nxt), jnp.asarray(pos))
    np.testing.assert_allclose(got[True][0], np.asarray(jpre),
                               atol=FP32_ATOL, rtol=0)
    np.testing.assert_allclose(got[True][1], np.asarray(jstep),
                               atol=FP32_ATOL, rtol=0)
    sq, sf = got[True][1], got[False][1]
    rel = np.abs(sq - sf).max() / (np.abs(sf).max() + 1e-9)
    assert 0 < rel < 0.05


# ---- generate and speculative_generate -----------------------------------------

@pytest.mark.parametrize("lp, new", [(5, 9), (40, 30), (120, 20)],
                         ids=["bucket128-short", "bucket128", "bucket256"])
def test_generate_matches_jax(setup, lp, new):
    """Greedy ``generate`` off the int8 cache gives the JAX int8
    ``generate``'s tokens, batch 2, at both cache buckets."""
    jcfg = dataclasses.replace(setup.jcfg, max_seq_len=256)
    cfg = dataclasses.replace(setup.pcfg, max_seq_len=256)
    prompt = np.random.default_rng(lp).integers(0, 256, (2, lp)).astype(
        np.int32)
    want = np.asarray(jdecode.generate(jcfg, setup.jparams,
                                       jnp.asarray(prompt), new))
    got = decode.generate(cfg, setup.params, torch.from_numpy(prompt), new,
                          device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lp, new", [(30, 15)])
def test_speculative_generate_matches_jax(setup, lp, new):
    """Batch-1 speculation with a one-layer ``truncated_draft`` (which
    keeps ``cache_int8``) over int8 caches: tokens and stats equal the JAX
    ``speculative_generate``'s, and the tokens its ``generate``'s."""
    (dcfg, dparams), (jdcfg, jdparams) = setup.drafts()
    assert dcfg.cache_int8 and jdcfg.cache_int8
    prompt = prompts(lp, (lp,))[0][None]
    got, stats = decode.speculative_generate(
        setup.pcfg, setup.params, dcfg, dparams, torch.from_numpy(prompt),
        new, k=3, device="cpu")
    jgot, jstats = jdecode.speculative_generate(
        setup.jcfg, setup.jparams, jdcfg, jdparams, jnp.asarray(prompt),
        new, k=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(got.numpy()[0],
                                  want_generate(setup, prompt[0], new))
    assert stats == jstats and stats["rounds"] >= 1


# ---- the engine ----------------------------------------------------------------

ENGINE_MODES = {
    "dense": {},
    "paged": dict(paged=True),
    "chunked": dict(prefill_chunk=8),
    "paged-chunked": dict(paged=True, prefill_chunk=8),
    "horizon": dict(step_horizon=3),
    "w8a16": dict(int8_weights=True),
}


def _traffic(eng, prefix: bool):
    """Three staggered requests through two slots (slot reuse); with
    ``prefix``, two of them over a registered 20-token prefix (a full page
    aliased on a paged engine). Returns the outputs in submission order."""
    pre, *ps = prompts(8, (20, 5, 19, 11))
    pid = eng.register_prefix(pre) if prefix else None
    rids = [eng.submit(ps[0], 8, prefix_id=pid), eng.submit(ps[1], 6)]
    eng.step()
    rids.append(eng.submit(ps[2], 9, prefix_id=pid))
    out = eng.run()
    if prefix:
        eng.drop_prefix(pid)
    return [out[r] for r in rids]


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_engine_matches_jax(setup, mode, prefix):
    """The engine over int8 caches gives the JAX int8 engine's tokens in
    every mode, with and without a prefix; the pool's bytes equal its, and
    a paged pool drains with the null page (scales included) zero."""
    kw = ENGINE_MODES[mode]
    eng = setup.engine(**kw)
    leaves = eng._pool_cache if kw.get("paged") else eng._cache
    assert list(leaves.leaves) == INT8_LEAVES
    got = _traffic(eng, prefix)
    want = _traffic(setup.jax_engine(**kw), prefix)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert eng.kv_bytes_per_chip == setup.jax_engine(**kw).kv_bytes_per_chip
    assert eng.pages_in_use == 0 and eng.null_page_is_zero()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_speculative_engine_matches_jax(setup, paged):
    """A speculative engine whose target and one-layer draft both keep int8
    caches: tokens and round counts equal the JAX engine's through the same
    traffic, prefix mirrored through the draft."""
    (dcfg, dparams), (jdcfg, jdparams) = setup.drafts()
    kw = dict(paged=paged, spec_k=3)
    eng = setup.engine(draft_cfg=dcfg, draft_params=dparams, **kw)
    assert list(eng._draft.cache.leaves) == INT8_LEAVES
    key = ("spec", *sorted(kw.items()))
    if key not in setup.jax_engines:
        setup.jax_engines[key] = JEngine(setup.jcfg, setup.jparams,
                                         draft_cfg=jdcfg,
                                         draft_params=jdparams, **_pool(kw))
    jeng = setup.jax_engines[key]
    before = {k: jeng.stats[k] for k in ("spec_rounds", "spec_accepted")}
    got, want = _traffic(eng, True), _traffic(jeng, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for k in before:
        assert eng.stats[k] == jeng.stats[k] - before[k]
    assert eng.stats["spec_rounds"] > 0


# ---- handoffs, migration, prefixes ---------------------------------------------

def prefill_handoff(engine, prompt, prefix_id=None, **kw):
    job = engine.start_prefill(prompt, prefix_id)
    while not job.advance():
        pass
    return job.handoff(**kw)


def adopt(engine, handoff, n, prefix_id=None) -> np.ndarray:
    rid = engine.submit_kv(handoff, n, prefix_id=prefix_id)
    return engine.run()[rid]


@pytest.mark.parametrize("paged, suffix_only",
                         [(False, False), (True, False), (True, True)],
                         ids=["dense", "paged", "paged-suffix"])
def test_jax_sealed_int8_handoff_adopts_in_the_port(setup, paged,
                                                    suffix_only):
    """A handoff the JAX engine sealed from its int8 cache, carried across
    by ``handoff_from_numpy``: leaves ``k, k_scale, v, v_scale`` with their
    dtypes, the JAX digest verifies (and reseals to itself), a flipped
    scale byte fails, and the port decodes the JAX engine's tokens."""
    prefix, prompt = prompts(9, (20, 9))
    ja = setup.jax_engine("prefill")
    jpid = ja.register_prefix(prefix) if suffix_only else None
    jho = prefill_handoff(ja, prompt, jpid, suffix_only=suffix_only)
    ho = pparams.handoff_from_numpy(
        jax.tree.map(np.asarray, jho.cache), pos=jho.pos,
        first_token=jho.first_token, emitted=jho.emitted, base=jho.base,
        prefix_hash=jho.prefix_hash, checksum=jho.checksum)
    assert list(ho.cache) == INT8_LEAVES
    assert [t.dtype for t in ho.cache.values()] == [
        torch.int8, torch.float32, torch.int8, torch.float32]
    assert ho.cache["k_scale"].shape == (2, 1, 64, 2)
    assert ho.verify() and ho.checksum == jho.checksum
    assert ho.nbytes == jho.nbytes == 2 * 64 * 2 * (2 * 16 + 2 * 4)
    assert KVHandoff(cache=ho.cache, pos=ho.pos, first_token=ho.first_token,
                     emitted=ho.emitted, base=ho.base
                     ).seal().checksum == jho.checksum
    if suffix_only:
        assert not ho.cache["k_scale"][:, :, :20].any()

    b, jb = setup.engine(paged=paged), setup.jax_engine("decode",
                                                        paged=paged)
    pid_b = jpid_b = None
    if suffix_only:
        pid_b, jpid_b = b.register_prefix(prefix), jb.register_prefix(prefix)
    got = adopt(b, ho, 7, pid_b)
    np.testing.assert_array_equal(got, adopt(jb, jho, 7, jpid_b))
    full = np.concatenate([prefix, prompt]) if suffix_only else prompt
    np.testing.assert_array_equal(got, want_generate(setup, full, 7))
    assert b.stats["prefill_positions"] == (64 if suffix_only else 0)
    if suffix_only:
        ja.drop_prefix(jpid)
        jb.drop_prefix(jpid_b)
    bad = {name: t.clone() for name, t in ho.cache.items()}
    bad["v_scale"].view(torch.uint8).view(-1)[-1] ^= 1
    assert not KVHandoff(cache=bad, pos=ho.pos, first_token=ho.first_token,
                         emitted=ho.emitted, base=ho.base,
                         checksum=ho.checksum).verify()


@pytest.mark.parametrize("src_paged, dst_paged",
                         [(False, True), (True, False)],
                         ids=["dense-to-paged", "paged-to-dense"])
def test_int8_migration_and_port_handoff(setup, src_paged, dst_paged):
    """The port's own int8 handoffs: a chunked ``start_prefill`` adopted,
    and a request migrated mid-decode (``export_kv``, ``abort``,
    ``submit_kv``) between a dense and a paged engine; each stream equals
    the JAX int8 ``generate``'s, and the handoff's bytes count the
    scales."""
    p1, p2 = prompts(10, (21, 10))
    a = setup.engine(paged=src_paged, prefill_chunk=8)
    b = setup.engine(paged=dst_paged)
    ho = prefill_handoff(a, p1)
    assert list(ho.cache) == INT8_LEAVES and ho.verify()
    assert ho.layout.gathered_bytes == ho.nbytes == 2 * 64 * 2 * 40
    np.testing.assert_array_equal(adopt(b, ho, 8),
                                  want_generate(setup, p1, 8))
    rid = a.submit(p2, 10)
    for _ in range(4):
        a.step()
    mig = a.export_kv(rid)
    a.abort(rid)
    assert mig.verify() and list(mig.cache) == INT8_LEAVES
    np.testing.assert_array_equal(adopt(b, mig, 10),
                                  want_generate(setup, p2, 10))
    assert b.stats["prefill_positions"] == 0
    assert a.pages_in_use == b.pages_in_use == 0


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_int8_prefix_export_import(setup, paged):
    """``export_prefix`` → ``import_prefix`` of an int8 prefix, and a
    descendant imported over its ancestor (aliasing its full pages on a
    paged engine): suffixes over each decode as the JAX engine does over
    its own imports, with no prefill of the prefixes."""
    base, ext, suffix = prompts(11, (17, 16, 6))
    desc = np.concatenate([base, ext])
    a, b = setup.engine(), setup.engine(paged=paged)
    host, lp = a.export_prefix(a.register_prefix(base))
    assert list(host) == INT8_LEAVES and lp == 17
    pid = b.import_prefix(host, lp)
    dhost, dlp = a.export_prefix(a.register_prefix(desc))
    did = b.import_prefix(dhost, dlp, base_pid=pid, base_len=lp)
    assert b.stats["pages_aliased"] == (1 if paged else 0)
    rids = [b.submit(suffix, 5, prefix_id=pid),
            b.submit(suffix, 5, prefix_id=did)]
    out = b.run()
    assert b.stats["prefix_prefills"] == 0

    ja, jb = setup.jax_engine("prefill"), setup.jax_engine("decode",
                                                           paged=paged)
    jpa, jda = ja.register_prefix(base), ja.register_prefix(desc)
    jpid = jb.import_prefix(*ja.export_prefix(jpa))
    jdid = jb.import_prefix(*ja.export_prefix(jda), base_pid=jpid,
                            base_len=lp)
    jrids = [jb.submit(suffix, 5, prefix_id=jpid),
             jb.submit(suffix, 5, prefix_id=jdid)]
    jout = jb.run()
    for r, jr in zip(rids, jrids):
        np.testing.assert_array_equal(out[r], jout[jr])
    np.testing.assert_array_equal(
        out[rids[1]], want_generate(setup, np.concatenate([desc, suffix]), 5))
    for e, ids in ((ja, (jpa, jda)), (jb, (jpid, jdid))):
        for i in ids:
            e.drop_prefix(i)


@pytest.mark.parametrize("case", ["missing-scale", "scale-dtype",
                                  "scale-shape", "fp-payload"])
def test_int8_payload_validation(setup, case):
    """``submit_kv`` and ``import_prefix`` refuse a payload that does not
    hold the int8 cache's leaves at their dtypes and shapes; a plain
    engine refuses an int8 payload."""
    prompt = prompts(12, (8,))[0]
    a = setup.engine()
    ho = prefill_handoff(a, prompt)
    cache = dict(ho.cache)
    eng = setup.engine()
    if case == "missing-scale":
        del cache["v_scale"]
    elif case == "scale-dtype":
        cache["k_scale"] = cache["k_scale"].to(torch.bfloat16)
    elif case == "scale-shape":
        cache["k_scale"] = cache["k_scale"][..., None]
    else:
        eng = ContinuousBatchingEngine(
            dataclasses.replace(setup.pcfg, cache_int8=False), setup.params,
            n_slots=2, device="cpu")
    bad = KVHandoff(cache=cache, pos=ho.pos, first_token=ho.first_token,
                    emitted=ho.emitted).seal()
    with pytest.raises(ValueError, match="payload"):
        eng.submit_kv(bad, 4)
    with pytest.raises(ValueError, match="payload"):
        eng.import_prefix(cache, 8)
    assert not eng._kv_queue
