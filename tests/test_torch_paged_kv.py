"""The PyTorch port's paged KV pool against the JAX package, on the CPU.

The paged engine gathers each slot's block table into the same view the
dense engine decodes over, so its greedy tokens must equal the dense
engine's and the JAX paged engine's through staggered admits, slot reuse,
chunked prefill and prefix forks, while its pages come and go with the
requests. Copy-on-write at the fork: a request writes its own fork and
suffix pages and only references a prefix's full pages, so no write ever
changes a sibling's bytes; page 0 (the null page) stays zero. A request's
KV migrates between dense and paged engines (``export_kv`` /
``submit_kv``), a descendant prefix imports over its ancestor's pages, and
``PagedKVMetrics`` reads what the JAX engine's reads. A
``TransformerConfig.tiny()`` model (fp32, ``max_seq_len`` 64) is initialised
by the JAX package and carried across with ``from_jax_params``; each JAX
engine is built once per module.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.metrics.metrics import PagedKVMetrics as JPagedKVMetrics
from tpu_on_k8s.models import decode as jdecode
from tpu_on_k8s.models.serving import ContinuousBatchingEngine as JEngine
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s_torch.metrics import PagedKVMetrics
from tpu_on_k8s_torch.models import decode
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
from tpu_on_k8s_torch.models.transformer import TransformerConfig

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

#: tiny-config page size: max_seq_len 64 < PAGE_TOKENS, so the tests shrink
#: the page to keep several pages per sequence (16 divides 64 and the
#: 128-token granule, the alignment production configs get for free)
PAGE = 16

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


@dataclasses.dataclass
class Setup:
    jcfg: JConfig
    jparams: dict
    pcfg: TransformerConfig
    params: dict
    jax_engines: dict

    def engine(self, paged=True, kv_pages=24, **kw):
        kw.setdefault("n_slots", 2)
        if paged:
            kw.update(kv_pages=kv_pages, page_tokens=PAGE)
        return ContinuousBatchingEngine(self.pcfg, self.params, device="cpu",
                                        **kw)

    def jax_engine(self, kv_pages=24, role="", **kw) -> JEngine:
        """One JAX paged engine per configuration (and ``role``: two
        engines of one configuration) for the whole module; ``kv_pages=0``
        gives a dense one."""
        kw.setdefault("n_slots", 2)
        key = (role, kv_pages, *sorted(kw.items()))
        if key not in self.jax_engines:
            self.jax_engines[key] = JEngine(self.jcfg, self.jparams,
                                            kv_pages=kv_pages,
                                            page_tokens=PAGE, **kw)
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


def by_order(out: dict) -> dict:
    """{id: tokens} keyed by submission order (a module's JAX engine has
    served earlier tests, so its ids do not start at 0)."""
    return {j: out[rid] for j, rid in enumerate(sorted(out))}


def assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for j in want:
        np.testing.assert_array_equal(got[j], want[j], err_msg=f"request {j}")


def three_ways(setup, traffic, jax_kw=None, **kw):
    """``traffic(engine)`` on the port's paged engine, the port's dense
    engine and the JAX paged engine: equal tokens. Returns the paged
    engine and its tokens, keyed by submission order."""
    eng = setup.engine(**kw)
    got = by_order(traffic(eng))
    assert_same(got, by_order(traffic(setup.engine(paged=False, **kw))))
    assert_same(got, by_order(traffic(setup.jax_engine(
        **(kw if jax_kw is None else jax_kw)))))
    return eng, got


def null_page_is_zero(eng) -> bool:
    bare = not (eng._pool_cache.k[:, 0].any() or eng._pool_cache.v[:, 0].any())
    assert eng.null_page_is_zero() == bare
    return bare


def test_page_size_is_the_position_bucket():
    """One constant, the reference's: every prefill bucket is a whole number
    of default pages, and the default page is the bucket granule (or the
    whole cache when it is shorter)."""
    assert decode.PAGE_TOKENS == jdecode.PAGE_TOKENS == 128
    assert decode.PAGE_TOKENS % PAGE == 0
    cfg = dataclasses.replace(TransformerConfig.tiny(), max_seq_len=512)
    params = pparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for max_len, page in ((512, 128), (64, 64)):
        eng = ContinuousBatchingEngine(cfg, params, n_slots=1,
                                       max_len=max_len, kv_pages=8,
                                       device="cpu")
        assert eng.page_tokens == page
        for total in range(1, max_len + 1, 7):
            assert decode._bucket_len(total, max_len) % page == 0


def test_staggered_admits_and_slot_reuse_match_dense(setup):
    """More requests than slots, admitted while others are mid-decode and
    onto pages another request just released: equal to the dense engine
    and the JAX paged engine; every page returns to the pool."""
    ps = prompts(31, (5, 11, 3, 17, 8, 26))
    news = (10, 6, 12, 5, 9, 7)

    def traffic(eng):
        for p, n in zip(ps[:3], news[:3]):
            eng.submit(p, n)
        eng.step()
        eng.step()
        for p, n in zip(ps[3:], news[3:]):
            eng.submit(p, n)
        return eng.run()

    eng, _ = three_ways(setup, traffic)
    assert eng.pages_in_use == 0 and not eng._tables.any()
    # each request reserves its whole span's pages at admission
    assert eng.stats["pages_allocated"] == sum(
        -(-(p.size + n) // PAGE) for p, n in zip(ps, news))
    assert null_page_is_zero(eng)


@pytest.mark.parametrize("horizon", [1, 3])
def test_chunked_prefill_paged_matches_dense(setup, horizon):
    """A long prompt split across engine steps lands in its pages once,
    while a short request decodes between its chunks."""
    long_p, short_p = prompts(32, (33, 4))

    def traffic(eng):
        eng.submit(long_p, 8)
        eng.submit(short_p, 6)
        return eng.run()

    eng, _ = three_ways(setup, traffic, prefill_chunk=7,
                        step_horizon=horizon)
    assert eng.pages_in_use == 0 and null_page_is_zero(eng)


def test_prefix_fork_cow_isolation(setup):
    """Requests sharing a registered prefix alias its full pages
    (refcounted, not copied) and write their own fork and suffix pages: the
    prefix's bytes never change while forks decode past the fork, and a
    later fork over the same prefix still matches."""
    prefix, *suffixes = prompts(33, (21, 4, 9, 2))
    news = (8, 5, 10)

    def traffic(eng):
        pid = eng.register_prefix(prefix)
        out = {}
        for s, n in zip(suffixes[:2], news[:2]):
            eng.submit(s, n, prefix_id=pid)
        eng.step()
        eng.step()
        if eng is probe:
            shared = eng._prefix_pages[pid]
            assert len(shared) == 21 // PAGE      # only FULL pages shared
            assert all(int(eng._pool._refs[p]) == 3 for p in shared)
            forks = [eng._slots[i].pages for i in range(2)]
            assert forks[0][:1] == forks[1][:1] == shared
            assert not set(forks[0][1:]) & set(forks[1][1:])
            snapshot.append(eng._pool_cache.k[:, shared].clone())
        out.update(eng.run())
        # a THIRD fork after the first two retired
        eng.submit(suffixes[2], news[2], prefix_id=pid)
        out.update(eng.run())
        return out

    snapshot = []
    probe = setup.engine()
    got = by_order(traffic(probe))
    assert_same(got, by_order(traffic(setup.engine(paged=False))))
    assert_same(got, by_order(traffic(setup.jax_engine())))
    shared = probe._prefix_pages[0]
    assert torch.equal(probe._pool_cache.k[:, shared], snapshot[0])
    assert probe.stats["pages_aliased"] == 3 * len(shared)
    assert all(int(probe._pool._refs[p]) == 1 for p in shared)
    assert probe.pages_in_use == len(shared) and null_page_is_zero(probe)
    probe.drop_prefix(0)
    assert probe.pages_in_use == 0


def test_pool_exhaustion_stalls_then_drains(setup):
    """A pool too small for the offered load stalls admissions (counted, as
    often as the JAX engine's) instead of failing them; everything still
    finishes as retiring requests return pages. A request that alone
    outsizes the pool is refused at submission."""
    ps = prompts(36, (20, 22, 24))

    def traffic(eng):
        for p in ps:
            eng.submit(p, 8)
        return eng.run()

    eng, _ = three_ways(setup, traffic, kv_pages=4, n_slots=4)
    stalls = eng.stats["admission_stalls"]
    assert stalls > 0
    assert stalls == setup.jax_engine(kv_pages=4, n_slots=4).stats[
        "admission_stalls"]
    assert eng.pages_in_use == 0

    tiny = setup.engine(kv_pages=3)
    with pytest.raises(ValueError, match="pages"):
        tiny.submit(np.zeros(40, np.int32), 24)


def test_null_page_stays_zero_after_every_step(setup):
    """Free slots and appends past a request's reservation (a horizon's
    surplus steps) write into the null page, which is zero again after
    every step; the tokens still equal the dense engine's."""
    ps = prompts(37, (5, 14, 9))
    news = (7, 4, 11)            # none a multiple of the horizon

    def traffic(eng):
        for p, n in zip(ps, news):
            eng.submit(p, n)
        out = {}
        while eng._queue or any(s is not None for s in eng._slots):
            eng.step()
            if eng._pool is not None:
                assert null_page_is_zero(eng)
            out.update(eng._finished)
        return out

    eng = setup.engine(n_slots=3, step_horizon=3)
    assert_same(by_order(traffic(eng)),
                by_order(traffic(setup.engine(paged=False, n_slots=3,
                                              step_horizon=3))))
    assert eng.stats["steps"] > 0


@pytest.mark.parametrize("src_paged, dst_paged",
                         [(True, True), (True, False), (False, True),
                          (False, False)],
                         ids=["paged-paged", "paged-dense", "dense-paged",
                              "dense-dense"])
def test_export_submit_kv_between_modes(setup, src_paged, dst_paged):
    """Mid-decode migration in every direction: the export ships the
    bucket's page run (or slot row), and the stream continues token for
    token as the JAX engines' through the same calls and the JAX
    ``generate``."""
    p = prompts(35, (7,))[0]

    def migrate(src, dst):
        r = src.submit(p, 14)
        src.step()
        src.step()
        h = src.export_kv(r)
        assert h is not None and h.verify()
        src.abort(r)
        r2 = dst.submit_kv(h, 14)
        return h, dst.run()[r2]

    h, got = migrate(setup.engine(paged=src_paged),
                     setup.engine(paged=dst_paged))
    assert h.cache["k"].shape == (2, 1, 64, 2, 16) and h.pos == 9
    np.testing.assert_array_equal(got, want_generate(setup, p, 14))
    jh, jgot = migrate(
        setup.jax_engine(kv_pages=24 if src_paged else 0, role="src"),
        setup.jax_engine(kv_pages=24 if dst_paged else 0, role="dst"))
    assert h.emitted == jh.emitted
    np.testing.assert_array_equal(got, jgot)


def test_base_aliased_import_end_to_end(setup):
    """A descendant prefix imported with ``base_pid``/``base_len`` aliases
    the resident ancestor's full pages (their bytes untouched, no page
    allocated for them) and writes only the rest; a request under the
    imported prefix decodes as the JAX engines' and the JAX ``generate``."""
    anc, tail, suffix = prompts(38, (33, 17, 5))
    desc = np.concatenate([anc, tail])

    def promote(a, b):
        ha, la = a.export_prefix(a.register_prefix(anc))
        hd, ld = a.export_prefix(a.register_prefix(desc))
        pid_anc = b.import_prefix(ha, la)
        allocated = b.stats["pages_allocated"]
        aliased = b.stats["pages_aliased"]
        pid_desc = b.import_prefix(hd, ld, base_pid=pid_anc, base_len=la)
        pages = b._prefix_pages[pid_desc]
        assert pages[:2] == b._prefix_pages[pid_anc]
        assert b.stats["pages_aliased"] - aliased == 2
        assert b.stats["pages_allocated"] - allocated == 1
        r = b.submit(suffix, 9, prefix_id=pid_desc)
        return b.run()[r]

    b = setup.engine()
    got = promote(setup.engine(), b)
    np.testing.assert_array_equal(
        got, want_generate(setup, np.concatenate([desc, suffix]), 9))
    np.testing.assert_array_equal(got, promote(
        setup.jax_engine(role="prefixes"), setup.jax_engine(role="adopter")))
    assert b.pages_in_use == 3 and null_page_is_zero(b)


def test_import_prefix_without_pages_when_the_pool_is_short(setup):
    """An import the pool cannot back is recorded without pages (the
    aliases it took are released) and still serves through its own cache,
    every block written fresh, as the JAX engine's does."""
    anc, tail, other, suffix = prompts(39, (33, 17, 48, 2))
    desc = np.concatenate([anc, tail])

    def short_pool(src, dst):
        hd, ld = src.export_prefix(src.register_prefix(desc))
        pid_anc = dst.register_prefix(anc)
        pid_other = dst.register_prefix(other)
        assert dst._pool.in_use == 5
        pid = dst.import_prefix(hd, ld, base_pid=pid_anc, base_len=33)
        assert dst._prefix_pages[pid] == [] and dst._pool.in_use == 5
        dst.drop_prefix(pid_anc)
        dst.drop_prefix(pid_other)
        r = dst.submit(suffix, 4, prefix_id=pid)
        return dst.run()[r]

    dst = setup.engine(kv_pages=5)
    got = short_pool(setup.engine(), dst)
    np.testing.assert_array_equal(
        got, want_generate(setup, np.concatenate([desc, suffix]), 4))
    np.testing.assert_array_equal(got, short_pool(
        setup.jax_engine(role="prefixes"),
        setup.jax_engine(kv_pages=5, role="short")))
    assert dst.stats["pages_aliased"] == 2 and dst.pages_in_use == 0


def test_paged_kv_metrics_match_jax(setup):
    """``PagedKVMetrics`` on the port's paged engine and on the JAX one,
    the same traffic (a prefix fork and a pool short enough to stall):
    equal page gauges and allocation, alias and stall counters.
    ``programs_compiled`` counts the reference's compiled programs; the
    port compiles none and never counts it."""
    prefix, *ps = prompts(40, (20, 3, 22, 24))

    def traffic(eng, m):
        assert m.gauges == {"pages_total": 5, "pages_in_use": 0}
        pid = eng.register_prefix(prefix)
        eng.submit(ps[0], 8, prefix_id=pid)
        for p in ps[1:]:
            eng.submit(p, 8)
        out = eng.run()
        eng.drop_prefix(pid)
        return out

    m, jm = PagedKVMetrics(), JPagedKVMetrics()
    got = traffic(setup.engine(kv_pages=5, n_slots=4, kv_metrics=m), m)
    jgot = traffic(JEngine(setup.jcfg, setup.jparams, n_slots=4, kv_pages=5,
                           page_tokens=PAGE, kv_metrics=jm), jm)
    assert_same(by_order(got), by_order(jgot))
    assert m.gauges == jm.gauges == {"pages_total": 5, "pages_in_use": 0}
    assert jm.counters.pop("programs_compiled") > 0
    assert m.counters.get("programs_compiled", 0) == 0
    assert dict(m.counters) == dict(jm.counters)
    assert m.counters["admission_stalls"] > 0
    assert m.counters["pages_aliased"] == 1
