"""The PyTorch port's speculative decoding against the JAX package, on the
CPU.

The contract is greedy token identity: the batched speculative engine
(per-slot drafts, one batched verify forward, accept and rollback by
position bookkeeping) and the batch-1 ``speculative_generate`` must give
the JAX ``generate``'s greedy tokens, through staggered admission, slot
reuse, prefix caching, chunked prefill, abort, ``export_kv`` mid-round, KV
adoption, imported prefixes, a draft crash, a W8A16 target and the paged
pool. Where the JAX engine runs the same traffic, the port's round counts
(``spec_rounds``, ``spec_proposed``, ``spec_accepted``,
``spec_rollbacks``) equal its; ``speculative_generate``'s stats equal the
JAX function's, and the ``SpecMetrics`` scrape text the JAX package's.

A ``TransformerConfig.tiny()`` model (fp32, ``max_seq_len`` 64) is
initialised by the JAX package and carried across with
``from_jax_params``; the draft is its first layer (``truncated_draft`` in
each package). Prompts come from numpy seeds. The JAX engines are built
once per module. The reference's ``test_serve_load_spec_trace`` runs on
the port's load driver (``serve_load --spec --trace-out``).
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s.chaos import scenarios as jscenarios
from tpu_on_k8s.metrics import metrics as jmetrics
from tpu_on_k8s.models import convert as jconvert
from tpu_on_k8s.models import decode as jdecode
from tpu_on_k8s.models.serving import ContinuousBatchingEngine as JEngine
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch import generate as gen_cli
from tpu_on_k8s_torch import metrics as pmetrics
from tpu_on_k8s_torch import serve as serve_cli
from tpu_on_k8s_torch.models import convert, decode
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
from tpu_on_k8s_torch.models.transformer import TransformerConfig

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

#: the engine's round counts held equal to the JAX engine's
SPEC_KEYS = ("spec_rounds", "spec_proposed", "spec_accepted",
             "spec_rollbacks")
#: tiny-config page size (max_seq_len 64 < PAGE_TOKENS), as in
#: tests/test_torch_paged_kv.py
PAGE = 16


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


def jax_init(jcfg: JConfig, seed: int):
    tok = jax.random.randint(jax.random.key(0), (1, 8), 0, jcfg.vocab_size,
                             jnp.int32)
    jparams = JTransformer(jcfg).init(jax.random.key(seed), tok)["params"]
    return jparams, pparams.from_jax_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


@dataclasses.dataclass
class Setup:
    jcfg: JConfig
    jparams: dict
    pcfg: TransformerConfig
    params: dict
    jax_engines: dict

    def drafts(self, draft: str):
        """(port draft, JAX draft), each (cfg, params): the first layer, or
        the target itself."""
        if draft == "self":
            return (self.pcfg, self.params), (self.jcfg, self.jparams)
        return (decode.truncated_draft(self.pcfg, self.params, 1),
                jdecode.truncated_draft(self.jcfg, self.jparams, 1))

    def engine(self, draft="layer", **kw) -> ContinuousBatchingEngine:
        kw.setdefault("n_slots", 2)
        kw.setdefault("spec_k", 3)
        (dcfg, dparams), _ = self.drafts(draft)
        return ContinuousBatchingEngine(self.pcfg, self.params,
                                        draft_cfg=dcfg, draft_params=dparams,
                                        device="cpu", **kw)

    def jax_engine(self, draft="layer", fresh=False, **kw) -> JEngine:
        """One JAX engine per configuration for the whole module (a fresh
        one with ``fresh``: metrics objects and chaos are per run)."""
        kw.setdefault("n_slots", 2)
        kw.setdefault("spec_k", 3)
        key = (draft, *sorted(kw.items()))
        if fresh or key not in self.jax_engines:
            _, (dcfg, dparams) = self.drafts(draft)
            eng = JEngine(self.jcfg, self.jparams, draft_cfg=dcfg,
                          draft_params=dparams, **kw)
            if fresh:
                return eng
            self.jax_engines[key] = eng
        return self.jax_engines[key]


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               max_seq_len=64)
    jparams, params = jax_init(jcfg, 1)
    return Setup(jcfg, jparams, port_config(jcfg), params, {})


def want_generate(jcfg, jparams, prompt, n) -> np.ndarray:
    """The JAX ``generate`` oracle: the single-request greedy continuation."""
    return np.asarray(jdecode.generate(
        jcfg, jparams, jnp.asarray(prompt, jnp.int32)[None],
        max_new_tokens=n))[0]


def prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in sizes]


def spec_stats(eng) -> dict:
    return {key: eng.stats[key] for key in SPEC_KEYS}


def by_order(out: dict) -> dict:
    """{id: tokens} keyed by submission order (a module's JAX engine has
    served earlier tests, so its ids do not start at 0)."""
    return {j: out[rid] for j, rid in enumerate(sorted(out))}


def both(setup, traffic, draft="layer", **kw):
    """Run ``traffic(engine)`` (returning {id: tokens} of what it submitted)
    on the port's speculative engine and on the JAX engine of the same
    configuration: equal tokens, and equal round counts for this traffic.
    Returns the port's tokens by submission order and its engine."""
    eng = setup.engine(draft, **kw)
    got = by_order(traffic(eng))
    jeng = setup.jax_engine(draft, **kw)
    before = spec_stats(jeng)
    want = by_order(traffic(jeng))
    assert set(got) == set(want)
    for j in want:
        np.testing.assert_array_equal(got[j], want[j], err_msg=f"request {j}")
    assert spec_stats(eng) == {key: jeng.stats[key] - before[key]
                               for key in SPEC_KEYS}
    return got, eng


def run_all(eng, reqs) -> dict:
    for p, n in reqs:
        eng.submit(p, n)
    return eng.run()


# ---- the engine: oracles of tests/test_speculative.py ----------------------

def test_staggered_spec_decode_matches_jax_and_generate(setup):
    """Ragged requests admitted at different times: each continuation equals
    its JAX ``generate`` output and the JAX engine's, the 1-layer draft
    makes both accepts and rollbacks happen, and ``SpecMetrics`` counts
    what the engine counted; its scrape text equals the JAX package's for
    the JAX engine's run of the same traffic."""
    ps, news = prompts(3, (5, 11, 3)), [10, 6, 12]

    def traffic(eng):
        rids = [eng.submit(ps[0], news[0])]
        eng.step()
        eng.step()
        rids.append(eng.submit(ps[1], news[1]))
        eng.step()
        rids.append(eng.submit(ps[2], news[2]))    # queued: both slots busy
        out = eng.run()
        assert sorted(out) == rids
        return out

    sm, jsm = pmetrics.SpecMetrics(), jmetrics.SpecMetrics()
    eng = setup.engine(spec_metrics=sm)
    got = by_order(traffic(eng))
    jeng = setup.jax_engine(fresh=True, spec_metrics=jsm)
    want = by_order(traffic(jeng))
    for j, (p, n) in enumerate(zip(ps, news)):
        np.testing.assert_array_equal(got[j], want[j])
        np.testing.assert_array_equal(
            got[j], want_generate(setup.jcfg, setup.jparams, p, n))
    st = eng.stats
    assert spec_stats(eng) == spec_stats(jeng)
    assert st["spec_rounds"] > 0 and st["spec_rollbacks"] > 0
    assert sm.counters["spec_tokens_proposed"] == st["spec_proposed"]
    assert sm.gauges["spec_acceptance_rate"] == pytest.approx(
        st["spec_accepted"] / st["spec_proposed"])
    assert dict(sm.counters) == dict(jsm.counters)
    assert sm.gauges == jsm.gauges
    assert pmetrics.render_text(sm) == jmetrics.render_text(jsm)
    assert st["spec_draft_s"] > 0 and st["spec_verify_s"] > 0


def test_self_draft_accepts_everything(setup):
    """draft == target: every proposal is accepted, a round emits k+1
    tokens, 11 tokens take ceil(10 / 4) = 3 rounds after the prefill's
    first, and the output stays exact."""
    p = prompts(4, (6,))[0]
    got, eng = both(setup, lambda e: run_all(e, [(p, 11)]), draft="self")
    np.testing.assert_array_equal(
        got[0], want_generate(setup.jcfg, setup.jparams, p, 11))
    st = eng.stats
    assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert st["spec_rollbacks"] == 0 and st["spec_rounds"] == 3
    assert st["steps"] == 3


def test_spec_slot_reuse_after_retirement(setup):
    """A slot freed by a finished request serves a new one: stale target
    and draft rows never leak into attention."""
    long_p, short_p = prompts(5, (20, 4))

    def traffic(eng):
        out = run_all(eng, [(long_p, 8)])
        out.update(run_all(eng, [(short_p, 16)]))
        return out

    got, _ = both(setup, traffic, n_slots=1)
    for j, (p, n) in enumerate(((long_p, 8), (short_p, 16))):
        np.testing.assert_array_equal(
            got[j], want_generate(setup.jcfg, setup.jparams, p, n))


@pytest.mark.parametrize("paged", [False, True])
def test_spec_prefix_caching_matches_full_prompt(setup, paged):
    """``register_prefix`` mirrors through the draft: a request carrying the
    prefix is drafted (its draft prefills only the suffix) and matches the
    full-prompt oracle, dense and paged."""
    pre, suf = prompts(6, (7, 5))
    kw = dict(kv_pages=24, page_tokens=PAGE) if paged else {}

    def traffic(eng):
        pid = eng.register_prefix(pre)
        rid = eng.submit(suf, 9, prefix_id=pid)
        out = eng.run()
        assert eng.drop_prefix(pid)
        return {rid: out[rid]}

    got, eng = both(setup, traffic, **kw)
    np.testing.assert_array_equal(got[0], want_generate(
        setup.jcfg, setup.jparams, np.concatenate([pre, suf]), 9))
    assert eng.stats["spec_rounds"] > 0
    # one fresh draft prefill (the prefix); the suffix seed starts after it
    assert eng._draft.fresh_prefills == 1 and not eng._draft.prefixes
    assert eng.pages_in_use == 0 and eng.null_page_is_zero()


def test_spec_chunked_prefill_matches_whole_prompt(setup):
    """Chunked prefill and speculation: the draft seeds from the whole
    prompt in one call whatever the target's chunk boundaries."""
    long_p = prompts(7, (30,))[0]
    got, _ = both(setup, lambda e: run_all(e, [(long_p, 8)]),
                  prefill_chunk=8)
    np.testing.assert_array_equal(
        got[0], want_generate(setup.jcfg, setup.jparams, long_p, 8))


def test_spec_mid_decode_abort(setup):
    """Aborting one speculating slot mid-flight frees it; the other slot's
    output stays exact, and the aborted prefix is itself exact."""
    pa, pb = prompts(8, (6, 9))

    def traffic(eng):
        ra = eng.submit(pa, 14)
        rb = eng.submit(pb, 10)
        eng.step()
        partial = eng.abort(ra)
        out = eng.run()
        assert ra not in out
        return {ra: partial, rb: out[rb]}

    got, _ = both(setup, traffic)
    assert got[0].size >= 1
    np.testing.assert_array_equal(
        got[0], want_generate(setup.jcfg, setup.jparams, pa,
                              14)[:got[0].size])
    np.testing.assert_array_equal(
        got[1], want_generate(setup.jcfg, setup.jparams, pb, 10))


def test_export_kv_mid_speculation_adopts_exactly(setup):
    """``export_kv`` during speculation: ``pos`` counts only accepted
    tokens, the handoff equals the JAX engine's, and a plain engine adopting
    it continues token for token."""
    p = prompts(9, (6,))[0]

    def export(eng):
        rid = eng.submit(p, 14)
        eng.step()
        eng.step()
        h = eng.export_kv(rid)
        eng.abort(rid)
        return h

    eng, jeng = setup.engine(), setup.jax_engine()
    before = spec_stats(jeng)
    h, jh = export(eng), export(jeng)
    assert h is not None and h.verify()
    assert len(h.emitted) == h.pos - p.size + 1 > 2
    assert (h.pos, h.emitted) == (jh.pos, jh.emitted)
    assert spec_stats(eng) == {key: jeng.stats[key] - before[key]
                               for key in SPEC_KEYS}
    plain = ContinuousBatchingEngine(setup.pcfg, setup.params, n_slots=2,
                                     device="cpu")
    rid = plain.submit_kv(h, 14)
    np.testing.assert_array_equal(
        plain.run()[rid], want_generate(setup.jcfg, setup.jparams, p, 14))


def test_adopted_handoff_decodes_plain_beside_spec_slots(setup):
    """A ``submit_kv`` adoption carries no prompt, so its slot is not
    drafted: it decodes plain inside the same rounds, exactly, while the
    drafted slot keeps speculating."""
    pa, pb = prompts(10, (4, 9))

    def handoff(src):
        ra = src.submit(pa, 12)
        src.step()
        h = src.export_kv(ra)
        src.abort(ra)
        return h

    h = handoff(ContinuousBatchingEngine(setup.pcfg, setup.params,
                                         n_slots=1, device="cpu"))
    jh = handoff(JEngine(setup.jcfg, setup.jparams, n_slots=1))

    def traffic(eng):
        rk = eng.submit_kv(jh if isinstance(eng, JEngine) else h, 12)
        rb = eng.submit(pb, 10)
        out = eng.run()
        return {rk: out[rk], rb: out[rb]}

    got, eng = both(setup, traffic)
    np.testing.assert_array_equal(
        got[0], want_generate(setup.jcfg, setup.jparams, pa, 12))
    np.testing.assert_array_equal(
        got[1], want_generate(setup.jcfg, setup.jparams, pb, 10))
    assert eng.stats["spec_rounds"] > 0


def test_imported_prefix_slot_degrades_to_plain(setup):
    """An ``import_prefix`` id never went through the draft, so requests
    under it decode plain, exactly; an all-undrafted pool takes the plain
    step: no round, no proposal."""
    pre, suf = prompts(11, (7, 5))
    donor = ContinuousBatchingEngine(setup.pcfg, setup.params, n_slots=1,
                                     device="cpu")
    host, lp = donor.export_prefix(donor.register_prefix(pre))
    eng = setup.engine()
    rid = eng.submit(suf, 9, prefix_id=eng.import_prefix(host, lp))
    np.testing.assert_array_equal(
        eng.run()[rid], want_generate(setup.jcfg, setup.jparams,
                                      np.concatenate([pre, suf]), 9))
    assert eng.stats["spec_proposed"] == eng.stats["spec_rounds"] == 0
    assert eng.stats["steps"] == 8


def test_draft_crash_degrades_to_plain_zero_loss(setup):
    """``DraftCrash`` at ``SITE_SPEC_DRAFT`` on the second round: the engine
    drops the draft, finishes every request on the plain step exactly, and
    counts the crash; the JAX engine under the JAX scenario does the same,
    and the two scrapes read alike."""
    pa, pb = prompts(12, (6, 9))

    def traffic(eng):
        ids = [eng.submit(pa, 14), eng.submit(pb, 10)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = eng.run()
        return {rid: out[rid] for rid in ids}

    sm, jsm = pmetrics.SpecMetrics(), jmetrics.SpecMetrics()
    with chaos.spec_draft_crash(at_round=2).injector() as inj:
        eng = setup.engine(spec_metrics=sm)
        got = by_order(traffic(eng))
    with jscenarios.spec_draft_crash(at_round=2).injector():
        jeng = setup.jax_engine(fresh=True, spec_metrics=jsm)
        want = by_order(traffic(jeng))
    for j, (p, n) in enumerate(((pa, 14), (pb, 10))):
        np.testing.assert_array_equal(got[j], want[j])
        np.testing.assert_array_equal(
            got[j], want_generate(setup.jcfg, setup.jparams, p, n))
    assert inj.events == ["seq=1 draft_crash note=draft dies mid-speculation"]
    assert eng.stats["draft_crashes"] == 1 and eng._draft is None
    assert 1 <= eng.stats["spec_rounds"] <= 2
    assert spec_stats(eng) == spec_stats(jeng)
    assert sm.counters["spec_draft_crashes"] == 1
    assert "tpu_on_k8s_spec_draft_crashes_total 1.0" in pmetrics.exposition(sm)
    assert pmetrics.render_text(sm) == jmetrics.render_text(jsm)


def test_degrade_draft_warns_and_counts(setup):
    eng = setup.engine(spec_metrics=pmetrics.SpecMetrics())
    with pytest.warns(UserWarning, match="degraded to plain decode"):
        eng.degrade_draft()
    assert eng._draft is None and eng.stats["draft_crashes"] == 1
    assert eng.spec_metrics.counters["spec_draft_crashes"] == 1


def test_on_spec_round_reports_and_a_raising_callback_detaches(setup):
    """``on_spec_round(ids, draft_s, verify_s, proposed, accepted)`` fires
    once a round; a raising one is detached, counted on
    ``callback_errors`` and warned, and serving goes on exactly."""
    p = prompts(13, (6,))[0]
    seen = []
    eng = setup.engine(on_spec_round=lambda *a: seen.append(a))
    rid = eng.submit(p, 9)
    out = eng.run()[rid]
    assert len(seen) == eng.stats["spec_rounds"] > 0
    assert all(ids == [rid] and d >= 0 and v >= 0 and n == 3
               for ids, d, v, n, _ in seen)
    assert sum(a for *_, a in seen) == eng.stats["spec_accepted"]

    def boom(*_):
        raise RuntimeError("gone")

    m = pmetrics.ServingMetrics()
    eng = setup.engine(on_spec_round=boom, metrics=m)
    rid = eng.submit(p, 9)
    with pytest.warns(UserWarning, match="on_spec_round callback raised"):
        np.testing.assert_array_equal(eng.run()[rid], out)
    assert m.counters["callback_errors"] == 1


@pytest.mark.parametrize("kw, match", [
    (dict(step_horizon=4), "step_horizon"),
    (dict(temperature=0.7), "greedy"),
    (dict(spec_k=0), "spec_k"),
    (dict(spec_k=16, kv_pages=8, page_tokens=PAGE), "exceeds page_tokens"),
])
def test_spec_validation(setup, kw, match):
    with pytest.raises(ValueError, match=match):
        setup.engine(**kw)


def test_spec_validation_of_the_draft(setup):
    dcfg, dparams = decode.truncated_draft(setup.pcfg, setup.params, 1)
    bad = dataclasses.replace(dcfg, vocab_size=setup.pcfg.vocab_size * 2)
    with pytest.raises(ValueError, match="vocab"):
        ContinuousBatchingEngine(setup.pcfg, setup.params, draft_cfg=bad,
                                 draft_params=dparams, device="cpu")
    for kw in (dict(draft_cfg=dcfg), dict(draft_params=dparams)):
        with pytest.raises(ValueError, match="come together"):
            ContinuousBatchingEngine(setup.pcfg, setup.params, device="cpu",
                                     **kw)
    eng = setup.engine()
    with pytest.raises(ValueError, match="desync the draft"):
        eng.replace_params(setup.params)


def test_speculation_composes_with_int8_target(setup):
    """A W8A16 target with the fp32 first-layer draft: the tokens equal the
    JAX int8 engine's and the int8 tree's own greedy ``generate``."""
    icfg, iparams = convert.quantize_serving_tree(setup.pcfg, setup.params)
    jicfg, jiparams = jconvert.quantize_serving_tree(setup.jcfg,
                                                     setup.jparams)
    (dcfg, dparams), (jdcfg, jdparams) = setup.drafts("layer")
    p = prompts(14, (7,))[0]
    eng = ContinuousBatchingEngine(icfg, iparams, n_slots=2, spec_k=3,
                                   draft_cfg=dcfg, draft_params=dparams,
                                   device="cpu")
    got = run_all(eng, [(p, 10)])[0]
    jeng = JEngine(jicfg, jiparams, n_slots=2, spec_k=3, draft_cfg=jdcfg,
                   draft_params=jdparams)
    np.testing.assert_array_equal(got, run_all(jeng, [(p, 10)])[0])
    np.testing.assert_array_equal(got, want_generate(jicfg, jiparams, p, 10))
    assert spec_stats(eng) == spec_stats(jeng)


def test_spec_decode_accept_rollback_paged(setup):
    """Rounds over the paged pool with a draft of another width (the oracle
    of tests/test_paged_kv.py): accepts and rollbacks are page-table
    bookkeeping, exact against ``generate`` and the JAX paged engine; the
    pool drains with page 0 zero."""
    jdcfg = dataclasses.replace(setup.jcfg, n_layers=1, n_heads=2,
                                d_model=32)
    jdparams, dparams = jax_init(jdcfg, 3)
    ps = prompts(34, (6, 13))
    eng = ContinuousBatchingEngine(
        setup.pcfg, setup.params, n_slots=2, kv_pages=24, page_tokens=PAGE,
        draft_cfg=port_config(jdcfg), draft_params=dparams, spec_k=3,
        device="cpu")
    got = by_order(run_all(eng, [(p, 12) for p in ps]))
    jeng = JEngine(setup.jcfg, setup.jparams, n_slots=2, kv_pages=24,
                   page_tokens=PAGE, draft_cfg=jdcfg, draft_params=jdparams,
                   spec_k=3)
    want = by_order(run_all(jeng, [(p, 12) for p in ps]))
    for j, p in enumerate(ps):
        np.testing.assert_array_equal(got[j], want[j])
        np.testing.assert_array_equal(
            got[j], want_generate(setup.jcfg, setup.jparams, p, 12))
    assert spec_stats(eng) == spec_stats(jeng)
    assert eng.stats["spec_rounds"] > 0
    assert eng.pages_in_use == 0 and eng.null_page_is_zero()


def test_truncated_draft_keeps_the_targets_tensors(setup):
    """The draft's tensors are the target's (no copy), the blocks past
    ``n_layers`` are gone, and a W8A16 tree keeps its int8 head."""
    dcfg, dparams = decode.truncated_draft(setup.pcfg, setup.params, 1)
    assert dcfg.n_layers == 1
    assert set(dparams) == {n for n in setup.params
                            if not n.startswith("blocks.1.")}
    assert all(dparams[n] is setup.params[n] for n in dparams)
    model = decode.decode_model(dcfg, dparams, "cpu")
    assert model.embed.data_ptr() == setup.params["embed"].data_ptr()
    icfg, iparams = convert.quantize_serving_tree(setup.pcfg, setup.params)
    _, iq = decode.truncated_draft(icfg, iparams, 1)
    assert {"lm_head_q", "lm_head_scale", "embed",
            "final_norm.scale"} <= set(iq)
    for n in (0, setup.pcfg.n_layers):
        with pytest.raises(ValueError, match="draft layers"):
            decode.truncated_draft(setup.pcfg, setup.params, n)


# ---- speculative_generate: oracles of tests/test_decode.py -----------------

@pytest.fixture(scope="module")
def batch1():
    """The reference's ``TestSpeculative._models``: tiny at max_seq_len 128
    and a 1-layer, 32-wide draft of its own weights."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               max_seq_len=128)
    jdcfg = dataclasses.replace(jcfg, n_layers=1, d_model=32, d_ff=64)
    jparams, params = jax_init(jcfg, 1)
    jdparams, dparams = jax_init(jdcfg, 2)
    tok = np.array(jax.random.randint(jax.random.key(0), (1, 8), 0,
                                      jcfg.vocab_size, jnp.int32))
    return (jcfg, jparams, jdcfg, jdparams, port_config(jcfg), params,
            port_config(jdcfg), dparams, tok)


@pytest.mark.parametrize("draft, new", [("other", 16), ("self", 15)])
def test_speculative_generate_matches_jax(batch1, draft, new):
    """Batch-1 speculation equals the JAX ``generate`` token for token, and
    its stats dict equals the JAX ``speculative_generate``'s. The
    self-draft accepts every proposal: 15 tokens in ceil(14 / 5) = 3
    rounds."""
    jcfg, jparams, jdcfg, jdparams, cfg, params, dcfg, dparams, tok = batch1
    if draft == "self":
        jdcfg, jdparams, dcfg, dparams = jcfg, jparams, cfg, params
    got, stats = decode.speculative_generate(
        cfg, params, dcfg, dparams, torch.from_numpy(tok), new, k=4,
        device="cpu")
    jgot, jstats = jdecode.speculative_generate(
        jcfg, jparams, jdcfg, jdparams, jnp.asarray(tok), new, k=4)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    np.testing.assert_array_equal(
        got.numpy()[0], want_generate(jcfg, jparams, tok[0], new))
    assert stats == jstats
    assert stats["rounds"] >= 1 and 0.0 <= stats["acceptance_rate"] <= 1.0
    if draft == "self":
        assert stats["acceptance_rate"] == 1.0 and stats["rounds"] == 3
        assert stats["tokens_per_target_forward"] > 3


@pytest.mark.parametrize("case, match", [
    ("batch", "batch-1"), ("vocab", "vocabulary"), ("long", "exceeds"),
    ("k", "window k")])
def test_speculative_generate_rejects(batch1, case, match):
    _, _, _, _, cfg, params, dcfg, dparams, tok = batch1
    prompt, new, k = torch.from_numpy(tok), 4, 4
    if case == "batch":
        prompt = prompt.repeat(2, 1)
    elif case == "vocab":
        dcfg = dataclasses.replace(dcfg, vocab_size=cfg.vocab_size * 2)
    elif case == "long":
        new = 1000
    else:
        k = 0
    with pytest.raises(ValueError, match=match):
        decode.speculative_generate(cfg, params, dcfg, dparams, prompt, new,
                                    k=k, device="cpu")


# ---- metrics, chaos, CLIs --------------------------------------------------

@pytest.mark.parametrize("openmetrics", [False, True])
def test_spec_metrics_render_like_the_jax_package(openmetrics):
    ours, theirs = pmetrics.SpecMetrics(), jmetrics.SpecMetrics()
    for m in (ours, theirs):
        m.inc("spec_tokens_proposed", 12)
        m.inc("spec_tokens_accepted", 7)
        m.inc("spec_rollbacks", 2)
        m.inc("spec_draft_crashes")
        m.set_gauge("spec_acceptance_rate", 7 / 12)
    assert (pmetrics.render_text(ours, openmetrics=openmetrics)
            == jmetrics.render_text(theirs, openmetrics=openmetrics))
    assert ours._families == {n: pmetrics._Family(*dataclasses.astuple(f))
                              for n, f in theirs._families.items()}


def test_spec_chaos_site_and_scenario_match_the_jax_package():
    from tpu_on_k8s.chaos import faults as jfaults

    assert chaos.SITE_SPEC_DRAFT == jfaults.SITE_SPEC_DRAFT
    assert chaos.DraftCrash.kind == jfaults.DraftCrash.kind
    ours = chaos.spec_draft_crash(at_round=3, seed=4)
    theirs = jscenarios.spec_draft_crash(at_round=3, seed=4)
    assert (ours.name, ours.seed) == (theirs.name, theirs.seed)
    (rule,), (jrule,) = ours.rules, theirs.rules
    assert (rule.site, rule.trigger.at, rule.note) == (
        jrule.site, jrule.trigger.at, jrule.note)


@pytest.mark.parametrize("layers, exact", [(1, False), (0, True)])
def test_serve_cli_spec(capsys, layers, exact):
    """``serve --spec``: every request served, the closing line reports
    rounds and acceptance; the self-draft (0 layers) accepts everything."""
    out = serve_cli.main(["--config", "tiny", "--device", "cpu",
                          "--n-requests", "4", "--n-slots", "2",
                          "--max-new-tokens", "6", "--spec",
                          "--spec-draft-layers", str(layers)])
    assert len(out) == 4 and all(t.shape == (6,) for t in out.values())
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("served 4 requests, 24 tokens")
    assert "spec rounds" in line
    assert ("acceptance 1.000" in line) == exact


def test_generate_cli_draft_config(capsys, tmp_path):
    out = gen_cli.main(["--config", "tiny", "--device", "cpu",
                        "--draft-config", "tiny", "--max-new-tokens", "6",
                        "--spec-k", "2"])
    assert tuple(out.shape) == (1, 6)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("speculative stats: {'rounds': ")
    # the draft restores from a checkpoint directory, which must hold one
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        gen_cli.main(["--device", "cpu", "--draft-config", "tiny",
                      "--draft-checkpoint-dir", str(tmp_path / "ckpt")])
    with pytest.raises(SystemExit, match="greedy-only"):
        gen_cli.main(["--device", "cpu", "--draft-config", "tiny",
                      "--temperature", "0.5"])


def test_serve_load_spec_trace(tmp_path):
    """The reference's ``test_serve_load_spec_trace`` on the port's load
    driver and ``obs/trace_report`` copy (``test_torch_api.TOOLS``; its
    flags with ``--device cpu``, its dump under ``tmp_path``): token
    identity against the plain arm, the cost-model TPOT win, acceptance 1
    for the self-draft and the trace's spec attribution."""
    from test_torch_api import TOOLS, reference_functions

    flags = (r'"--spec", "--n-requests", "10"',
             '"--device", "cpu", "--spec", "--n-requests", "10"')
    dump = (r'"/tmp/test_spec_trace\.json"', "SPEC_TRACE")
    ns = reference_functions(
        "test_speculative", ["test_serve_load_spec_trace"],
        {"SPEC_TRACE": str(tmp_path / "test_spec_trace.json")},
        subs=(*TOOLS, flags, dump))
    ns["test_serve_load_spec_trace"](None)
    assert (tmp_path / "test_spec_trace.json").exists()
