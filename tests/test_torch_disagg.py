"""The PyTorch port's KV handoff (disaggregated prefill) against the JAX
package, on the CPU.

A prefill handed off between engines (whole prompt, chunked, suffix-only
over a registered prefix, a mid-decode ``export_kv`` migration) and a
prefix moved by ``export_prefix`` / ``import_prefix`` must decode token for
token as the JAX engine does through the same calls and as the JAX
``generate`` of the whole request; each decode engine runs dense and
paged. A handoff sealed by the JAX engine, carried across with
``handoff_from_numpy``, keeps its digest and decodes in the port as it does
in the JAX engine. A ``TransformerConfig.tiny()`` model (fp32,
``max_seq_len`` 64) is initialised by the JAX package and carried across
with ``from_jax_params``; prompts come from numpy seeds, decoding is greedy.
Each JAX engine is built once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.models import decode as jdecode
from tpu_on_k8s.models.serving import ContinuousBatchingEngine as JEngine
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s.serve.kvstore import prefix_hash
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.serving import (
    ContinuousBatchingEngine,
    KVHandoff,
)
from tpu_on_k8s_torch.models.transformer import TransformerConfig

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

#: tiny-config page size (16 divides max_len 64 and the 128-token granule)
PAGE = 16

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

MODES = pytest.mark.parametrize("paged", [False, True],
                                ids=["dense", "paged"])


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def _pool(paged: bool, kw: dict) -> dict:
    kw.setdefault("n_slots", 2)
    if paged:
        kw.update(kv_pages=24, page_tokens=PAGE)
    return kw


@dataclasses.dataclass
class Setup:
    jcfg: JConfig
    jparams: dict
    pcfg: TransformerConfig
    params: dict
    jax_engines: dict

    def engine(self, paged=False, **kw) -> ContinuousBatchingEngine:
        return ContinuousBatchingEngine(self.pcfg, self.params, device="cpu",
                                        **_pool(paged, kw))

    def jax_engine(self, role: str, paged=False, **kw) -> JEngine:
        """One JAX engine per role and configuration for the whole module
        (a prefill engine and a decode engine of one configuration are
        two)."""
        key = (role, paged, *sorted(kw.items()))
        if key not in self.jax_engines:
            self.jax_engines[key] = JEngine(self.jcfg, self.jparams,
                                            **_pool(paged, kw))
        return self.jax_engines[key]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               max_seq_len=64)
    tok = jax.random.randint(jax.random.key(0), (1, 8), 0, jcfg.vocab_size,
                             jnp.int32)
    jparams = JTransformer(jcfg).init(jax.random.key(1), tok)["params"]
    params = pparams.from_jax_params(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return Setup(jcfg, jparams, port_config(jcfg), params, {})


def want_generate(setup, prompt, n) -> np.ndarray:
    """The JAX ``generate`` oracle: the request's greedy continuation."""
    return np.asarray(jdecode.generate(
        setup.jcfg, setup.jparams, jnp.asarray(prompt, jnp.int32)[None],
        max_new_tokens=n))[0]


def prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in sizes]


def prefill_handoff(engine, prompt, prefix_id=None, **kw):
    """``start_prefill`` → ``advance`` until done → ``handoff(**kw)``, on
    either package's engine; returns the handoff and the advance calls."""
    job = engine.start_prefill(prompt, prefix_id)
    calls = 1
    while not job.advance():
        calls += 1
    return job.handoff(**kw), calls


def adopt(engine, handoff, n, prefix_id=None) -> np.ndarray:
    rid = engine.submit_kv(handoff, n, prefix_id=prefix_id)
    return engine.run()[rid]


@MODES
def test_kv_handoff_roundtrip_oracle(setup, paged):
    """A whole-prompt prefill on one engine, its sealed KV adopted by
    another: the decode equals the JAX engine's through the same calls and
    the JAX ``generate``, and the decode engine ran no prefill."""
    prompt = prompts(0, (12,))[0]
    a, b = setup.engine(), setup.engine(paged)
    ho, calls = prefill_handoff(a, prompt)
    assert calls == 1 and ho.verify() and ho.pos == 12 and ho.base == 0
    assert ho.cache["k"].shape == (2, 1, 64, 2, 16)
    assert ho.nbytes == 2 * 2 * 64 * 2 * 16 * 4
    got = adopt(b, ho, 8)
    np.testing.assert_array_equal(got, want_generate(setup, prompt, 8))
    jho, _ = prefill_handoff(setup.jax_engine("prefill"), prompt)
    assert ho.emitted == jho.emitted
    np.testing.assert_array_equal(
        got, adopt(setup.jax_engine("decode", paged), jho, 8))
    assert b.stats["kv_adopted"] == 1 and b.stats["prefill_positions"] == 0
    assert b.stats["fresh_prefills"] == 0
    assert a.stats["fresh_prefills"] == 1
    assert (a.stats["export_gather_bytes"] == ho.nbytes
            == ho.layout.gathered_bytes)
    assert ho.layout.mesh_axes == {} and not ho.layout.sharded
    jb = setup.jax_engine("decode", paged)
    assert b.param_bytes_per_chip == jb.param_bytes_per_chip
    assert b.kv_bytes_per_chip == jb.kv_bytes_per_chip


@MODES
def test_kv_handoff_chunked_prefill_oracle(setup, paged):
    """A ``PrefillJob`` advancing one chunk a call takes the chunk
    boundaries of the monolithic chunked admission, so the handed-off
    decode is exact; only its first chunk starts from an empty cache."""
    prompt = prompts(1, (20,))[0]
    a, b = setup.engine(prefill_chunk=4), setup.engine(paged)
    ho, calls = prefill_handoff(a, prompt)
    assert calls == 5 and a.stats["fresh_prefills"] == 1
    got = adopt(b, ho, 6)
    np.testing.assert_array_equal(got, want_generate(setup, prompt, 6))
    jho, _ = prefill_handoff(setup.jax_engine("prefill", prefill_chunk=4),
                             prompt)
    np.testing.assert_array_equal(
        got, adopt(setup.jax_engine("decode", paged), jho, 6))
    assert b.stats["prefill_positions"] == 0


@pytest.mark.parametrize("paged, plen", [(False, 8), (True, 8), (True, 20)],
                         ids=["dense", "paged", "paged-aliased"])
def test_kv_handoff_suffix_only_oracle(setup, paged, plen):
    """Suffix-only transfer: the prefix's rows stay home (zero in the
    payload), the adopting engine supplies them from its own registration,
    and the decode is still exact; a paged engine aliases the prefix's full
    pages."""
    prefix, suffix = prompts(2, (plen, 6))
    a, b = setup.engine(), setup.engine(paged)
    ho, _ = prefill_handoff(a, suffix, a.register_prefix(prefix),
                            suffix_only=True, prefix_hash=prefix_hash(prefix))
    assert ho.base == plen and ho.pos == plen + 6 and ho.verify()
    assert ho.prefix_hash == prefix_hash(prefix)
    assert not ho.cache["k"][:, :, :plen].any()
    assert not ho.cache["v"][:, :, :plen].any()
    got = adopt(b, ho, 6, b.register_prefix(prefix))
    full = np.concatenate([prefix, suffix])
    np.testing.assert_array_equal(got, want_generate(setup, full, 6))

    ja, jb = setup.jax_engine("prefill"), setup.jax_engine("decode", paged)
    jpa, jpb = ja.register_prefix(prefix), jb.register_prefix(prefix)
    jho, _ = prefill_handoff(ja, suffix, jpa, suffix_only=True)
    np.testing.assert_array_equal(got, adopt(jb, jho, 6, jpb))
    ja.drop_prefix(jpa)
    jb.drop_prefix(jpb)
    assert b.stats["pages_aliased"] == (plen // PAGE if paged else 0)
    assert b.stats["prefill_positions"] == 64    # the prefix's own


@MODES
def test_export_import_prefix_roundtrip(setup, paged):
    """``export_prefix`` → ``import_prefix``: the imported copy serves a
    suffix exactly, and the importing engine never prefills it."""
    prefix, suffix = prompts(3, (8, 5))
    a, b = setup.engine(), setup.engine(paged)
    host, lp = a.export_prefix(a.register_prefix(prefix))
    assert lp == 8 and host["k"].shape == (2, 1, 64, 2, 16)
    assert a.stats["export_gather_bytes"] == 2 * host["k"].numel() * 4
    pid = b.import_prefix(host, lp)
    rid = b.submit(suffix, 5, prefix_id=pid)
    got = b.run()[rid]
    full = np.concatenate([prefix, suffix])
    np.testing.assert_array_equal(got, want_generate(setup, full, 5))
    assert b.stats["prefix_prefills"] == 0

    ja, jb = setup.jax_engine("prefill"), setup.jax_engine("decode", paged)
    jpa = ja.register_prefix(prefix)
    jpid = jb.import_prefix(*ja.export_prefix(jpa))
    jrid = jb.submit(suffix, 5, prefix_id=jpid)
    np.testing.assert_array_equal(got, jb.run()[jrid])
    ja.drop_prefix(jpa)
    jb.drop_prefix(jpid)


@MODES
def test_export_kv_mid_decode_migration_oracle(setup, paged):
    """``export_kv`` mid-decode, ``abort``, then ``submit_kv`` elsewhere:
    the stream continues token for token."""
    prompt = prompts(4, (10,))[0]
    a, b = setup.engine(paged), setup.engine(paged)
    rid = a.submit(prompt, 8)
    for _ in range(4):
        a.step()
    ho = a.export_kv(rid)
    assert ho is not None and ho.verify() and len(ho.emitted) >= 2
    assert ho.pos == 10 + len(ho.emitted) - 1
    assert a.stats["kv_exported"] == 1 and a.export_kv(12345) is None
    a.abort(rid)
    got = adopt(b, ho, 8)
    np.testing.assert_array_equal(got, want_generate(setup, prompt, 8))

    ja = setup.jax_engine("export", paged)
    jrid = ja.submit(prompt, 8)
    for _ in range(4):
        ja.step()
    jho = ja.export_kv(jrid)
    ja.abort(jrid)
    assert ho.emitted == jho.emitted and ho.pos == jho.pos
    np.testing.assert_array_equal(
        got, adopt(setup.jax_engine("decode", paged), jho, 8))


@MODES
def test_submit_kv_validation_and_checksum(setup, paged):
    """One flipped payload byte fails ``verify()``; ``submit_kv`` refuses a
    zero budget, a budget past ``max_len``, a handoff with no tokens, a
    suffix-only handoff without (or with an unknown, or a mismatched)
    prefix id, and a payload of another shape; the engine then adopts the
    sound handoff exactly."""
    prompt = prompts(5, (8,))[0]
    a, b = setup.engine(), setup.engine(paged)
    ho, _ = prefill_handoff(a, prompt)
    bad = {name: t.clone() for name, t in ho.cache.items()}
    bad["k"].view(torch.uint8).view(-1)[0] ^= 0xFF
    corrupt = KVHandoff(cache=bad, pos=ho.pos, first_token=ho.first_token,
                        emitted=ho.emitted, checksum=ho.checksum)
    assert not corrupt.verify()
    assert ho.verify()
    with pytest.raises(ValueError, match="max_new_tokens"):
        b.submit_kv(ho, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_len"):
        b.submit_kv(ho, max_new_tokens=64)
    empty = KVHandoff(cache=ho.cache, pos=ho.pos, first_token=0,
                      emitted=()).seal()
    with pytest.raises(ValueError, match="no emitted tokens"):
        b.submit_kv(empty, max_new_tokens=4)
    sfx = KVHandoff(cache=ho.cache, pos=ho.pos, first_token=ho.first_token,
                    emitted=ho.emitted, base=4).seal()
    with pytest.raises(ValueError, match="needs a prefix_id"):
        b.submit_kv(sfx, max_new_tokens=4)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        b.submit_kv(sfx, max_new_tokens=4, prefix_id=99)
    with pytest.raises(ValueError, match="base 4 != local prefix length 3"):
        b.submit_kv(sfx, max_new_tokens=4,
                    prefix_id=b.register_prefix(prompt[:3]))
    short = KVHandoff(cache={n: t[:, :, :4] for n, t in ho.cache.items()},
                      pos=ho.pos, first_token=ho.first_token,
                      emitted=ho.emitted).seal()
    with pytest.raises(ValueError, match="does not fit"):
        b.submit_kv(short, max_new_tokens=4)
    assert not b._kv_queue
    np.testing.assert_array_equal(adopt(b, ho, 4),
                                  want_generate(setup, prompt, 4))


@pytest.mark.parametrize("paged, suffix_only",
                         [(False, False), (True, False), (True, True)],
                         ids=["dense", "paged", "paged-suffix"])
def test_jax_sealed_handoff_adopts_in_the_port(setup, paged, suffix_only):
    """A handoff sealed by the JAX engine, converted by
    ``handoff_from_numpy``, keeps the JAX digest and verifies; the port's
    decode engine then decodes the tokens the JAX decode engine decodes
    from the same handoff."""
    prefix, prompt = prompts(6, (20, 9))
    ja = setup.jax_engine("prefill")
    jpid = ja.register_prefix(prefix) if suffix_only else None
    jho, _ = prefill_handoff(ja, prompt, jpid, suffix_only=suffix_only)
    ho = pparams.handoff_from_numpy(
        jax.tree.map(np.asarray, jho.cache), pos=jho.pos,
        first_token=jho.first_token, emitted=jho.emitted, base=jho.base,
        prefix_hash=jho.prefix_hash, checksum=jho.checksum)
    assert ho.verify() and ho.checksum == jho.checksum
    assert ho.nbytes == jho.nbytes and ho.base == jho.base
    assert KVHandoff(cache=ho.cache, pos=ho.pos, first_token=ho.first_token,
                     emitted=ho.emitted, base=ho.base
                     ).seal().checksum == jho.checksum

    b = setup.engine(paged)
    jb = setup.jax_engine("decode", paged)
    pid_b = jpid_b = None
    if suffix_only:
        pid_b, jpid_b = b.register_prefix(prefix), jb.register_prefix(prefix)
    got = adopt(b, ho, 7, pid_b)
    np.testing.assert_array_equal(got, adopt(jb, jho, 7, jpid_b))
    full = np.concatenate([prefix, prompt]) if suffix_only else prompt
    np.testing.assert_array_equal(got, want_generate(setup, full, 7))
    if suffix_only:
        ja.drop_prefix(jpid)
        jb.drop_prefix(jpid_b)


def test_bf16_handoff_keeps_the_jax_digest():
    """At the tiny config's own bf16 (a dtype numpy lacks), the payload's
    raw 16-bit words carry across: the JAX digest verifies in the port, the
    tensors are bf16, and a flipped byte fails."""
    jcfg = JConfig.tiny()
    assert jcfg.dtype == jnp.bfloat16
    tok = jax.random.randint(jax.random.key(0), (1, 8), 0, jcfg.vocab_size,
                             jnp.int32)
    jparams = JTransformer(jcfg).init(jax.random.key(1), tok)["params"]
    jho, _ = prefill_handoff(JEngine(jcfg, jparams, n_slots=1),
                             prompts(7, (11,))[0])
    ho = pparams.handoff_from_numpy(
        jax.tree.map(np.asarray, jho.cache), pos=jho.pos,
        first_token=jho.first_token, emitted=jho.emitted,
        checksum=jho.checksum)
    assert ho.cache["k"].dtype == ho.cache["v"].dtype == torch.bfloat16
    assert ho.cache["k"].shape == (2, 1, 128, 2, 16)
    assert ho.verify() and ho.checksum == jho.checksum
    np.testing.assert_array_equal(
        ho.cache["v"].float().numpy(),
        np.asarray(jho.cache["blocks"]["attn"]["v"], np.float32))
    ho.cache["v"].view(torch.int16).view(-1)[-1] ^= 1
    assert not ho.verify()


def test_handoff_from_numpy_refuses_other_layouts():
    leaf = np.zeros((2, 1, 64, 2, 16), np.float32)
    with pytest.raises(NotImplementedError, match="layout"):
        pparams.handoff_from_numpy(
            {"blocks": {"attn": {"k": leaf, "v": leaf, "k_scale": leaf}}},
            pos=3, first_token=1, emitted=(1,))
