"""The PyTorch port's continuous-batching engine against the JAX package, on
the CPU.

A ``TransformerConfig.tiny()`` model (fp32, ``max_seq_len`` 64) is
initialised by the JAX package and carried across with ``from_jax_params``;
prompts come from numpy seeds. The same traffic runs through the port's
engine and the JAX engine, and their greedy tokens must agree token for
token; a few requests are also held against the JAX ``generate``. The JAX
engines are built once per module (each compiles its programs once). Also
here: the multislot append at the layer, the engine's lifecycle (streaming,
threads, queue cap, abort, reset, parameter swaps), its metrics (against the
JAX package's counts and scrape text), chaos at its step, and the ``serve``
CLI.
"""
import dataclasses
import sys
import threading
import urllib.error
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_on_k8s import chaos as jchaos
from tpu_on_k8s.chaos import scenarios as jscenarios
from tpu_on_k8s.metrics import metrics as jmetrics
from tpu_on_k8s.models import decode as jdecode
from tpu_on_k8s.models.serving import ContinuousBatchingEngine as JEngine
from tpu_on_k8s.models.transformer import Attention as JAttention
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch import metrics as pmetrics
from tpu_on_k8s_torch import serve as cli
from tpu_on_k8s_torch.serve import cli as cli_module
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models import serving
from tpu_on_k8s_torch.models.serving import (
    ContinuousBatchingEngine,
    EngineCrashError,
    EngineOverloadedError,
)
from tpu_on_k8s_torch.models.transformer import (
    Attention,
    KVCache,
    Positions,
    TransformerConfig,
    _append_per_row,
    _rope_tables,
)

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

# fp32 end to end: the two packages differ only in summation order.
FP32_ATOL = 1e-4

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

    def engine(self, **kw) -> ContinuousBatchingEngine:
        kw.setdefault("n_slots", 2)
        return ContinuousBatchingEngine(self.pcfg, self.params, device="cpu",
                                        **kw)

    def jax_engine(self, **kw) -> JEngine:
        """One JAX engine per configuration for the whole module."""
        kw.setdefault("n_slots", 2)
        key = tuple(sorted(kw.items()))
        if key not in self.jax_engines:
            self.jax_engines[key] = JEngine(self.jcfg, self.jparams, **kw)
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
    """The JAX ``generate`` oracle: the single-request greedy continuation
    (it compiles once per prompt length and n: the tests share a few)."""
    return np.asarray(jdecode.generate(
        setup.jcfg, setup.jparams, jnp.asarray(prompt, jnp.int32)[None],
        max_new_tokens=n))[0]


def prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).astype(np.int32) for n in sizes]


def same_tokens(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid],
                                      err_msg=f"request {rid}")


def by_order(out: dict) -> dict:
    """{id: tokens} keyed by submission order instead (a module's JAX engine
    has served earlier tests, so its ids do not start at 0)."""
    return {j: out[rid] for j, rid in enumerate(sorted(out))}


def both(setup, traffic, jax_kw=None, **kw):
    """Run ``traffic(engine)`` (submits and steps, returning {id: tokens}
    of every request it submitted) on the port's engine and on the JAX
    engine of the same configuration (or of ``jax_kw``); their tokens must
    be equal. Returns the port's, keyed by submission order."""
    got = by_order(traffic(setup.engine(**kw)))
    same_tokens(got, by_order(traffic(setup.jax_engine(
        **(kw if jax_kw is None else jax_kw)))))
    return got


# ---- the multislot append --------------------------------------------------

@pytest.mark.parametrize("l", [1, 3, 5])
def test_multislot_append_drops_like_the_reference(l):
    """Each row writes at its own positions; a position at or past the cache
    length writes nothing (the reference's ``mode="drop"``). Rows: a
    sentinel row, one whose first write lands at the last position beside
    dropped ones aimed at the same index, one inside: the cache must be
    byte-equal to the reference's scatter."""
    rng = np.random.default_rng(5)
    b, length, hkv, d = 3, 16, 2, 8
    cache = rng.standard_normal((b, length, hkv, d)).astype(np.float32)
    k = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    pos = np.stack([np.full(l, length),                      # free slot
                    length - 1 + np.arange(l),               # the last one
                    4 + np.arange(l)]).astype(np.int32)
    kv = KVCache(torch.from_numpy(cache.copy()),
                 torch.from_numpy(cache.copy()))
    rows = jnp.arange(b)[:, None]
    want = np.asarray(jnp.asarray(cache).at[rows, jnp.asarray(pos)].set(
        jnp.asarray(k), mode="drop"))
    _append_per_row(torch.from_numpy(k), torch.from_numpy(k),
                    torch.from_numpy(pos), kv)
    np.testing.assert_array_equal(kv.k.numpy(), want)
    np.testing.assert_array_equal(kv.v.numpy(), want)
    np.testing.assert_array_equal(kv.k[0].numpy(), cache[0])
    np.testing.assert_array_equal(kv.k[1, length - 1].numpy(), k[1, 0])
    assert kv.index == 0


def test_multislot_attention_matches_reference(setup):
    """A multislot ``Attention`` call with one sentinel row: outputs within
    FP32_ATOL of the reference's multislot apply, each live row's cache
    written at its own position, every other byte (the sentinel row's
    included) unchanged."""
    jcfg = dataclasses.replace(setup.jcfg, decode=True, remat=False,
                               attn_impl="xla", decode_multislot=True)
    pcfg = dataclasses.replace(setup.pcfg, decode=True, remat=False,
                               decode_multislot=True)
    rng = np.random.default_rng(6)
    b, length = 3, jcfg.max_seq_len
    shape = (b, length, jcfg.n_kv_heads, jcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    pos = np.asarray([[9], [length], [length - 1]], np.int32)

    layer0 = jax.tree.map(lambda a: a[0], setup.jparams["blocks"]["attn"])
    want, upd = JAttention(jcfg).apply(
        {"params": layer0,
         "cache": {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}},
        jnp.asarray(x),
        jnp.asarray(pos), mutable=["cache"])

    attn = Attention(pcfg)
    attn.load_state_dict({name[len("blocks.0.attn."):]: t
                          for name, t in setup.params.items()
                          if name.startswith("blocks.0.attn.")})
    ids = torch.from_numpy(pos)
    cos, sin = _rope_tables(ids, pcfg.head_dim // 2, pcfg.rope_theta)
    cache = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    with torch.no_grad():
        got = attn(torch.from_numpy(x),
                   Positions(ids, cos[:, :, None], sin[:, :, None], False,
                             multislot=True),
                   cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL,
                               rtol=0)
    for name, before, after in (("k", k0, cache.k), ("v", v0, cache.v)):
        ref = np.asarray(upd["cache"][name])
        np.testing.assert_allclose(after.numpy(), ref, atol=FP32_ATOL,
                                   rtol=0)
        written = np.zeros(shape[:2], bool)
        written[0, 9] = written[2, length - 1] = True
        np.testing.assert_array_equal(after.numpy()[~written],
                                      before[~written])
        np.testing.assert_array_equal(ref[~written], before[~written])


def test_multislot_verify_chunk_matches_reference(setup):
    """A speculative verify chunk through a multislot ``Attention``: 5
    tokens a row at GQA rep 2 (tiny: 4 heads, 2 kv heads), a drafted row at
    its own positions, one whose last writes pass the cache end, and an
    undrafted row at the sentinel past column 0. Outputs within FP32_ATOL
    of the reference's multislot apply (the ``_over_cache`` mask takes each
    row's ``[B, l]`` positions, rep-major as the query rows are laid out),
    and the caches equal its."""
    jcfg = dataclasses.replace(setup.jcfg, decode=True, remat=False,
                               attn_impl="xla", decode_multislot=True)
    pcfg = dataclasses.replace(setup.pcfg, decode=True, remat=False,
                               decode_multislot=True)
    assert pcfg.n_heads // pcfg.n_kv_heads == 2
    rng = np.random.default_rng(7)
    b, l, length = 3, 5, jcfg.max_seq_len
    shape = (b, length, jcfg.n_kv_heads, jcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    x = rng.standard_normal((b, l, jcfg.d_model)).astype(np.float32)
    pos = np.stack([9 + np.arange(l), length - 3 + np.arange(l),
                    [20] + [length] * (l - 1)]).astype(np.int32)

    layer0 = jax.tree.map(lambda a: a[0], setup.jparams["blocks"]["attn"])
    want, upd = JAttention(jcfg).apply(
        {"params": layer0,
         "cache": {"k": jnp.asarray(k0), "v": jnp.asarray(v0)}},
        jnp.asarray(x), jnp.asarray(pos), mutable=["cache"])

    attn = Attention(pcfg)
    attn.load_state_dict({name[len("blocks.0.attn."):]: t
                          for name, t in setup.params.items()
                          if name.startswith("blocks.0.attn.")})
    ids = torch.from_numpy(pos)
    cos, sin = _rope_tables(ids, pcfg.head_dim // 2, pcfg.rope_theta)
    cache = KVCache(torch.from_numpy(k0.copy()), torch.from_numpy(v0.copy()))
    with torch.no_grad():
        got = attn(torch.from_numpy(x),
                   Positions(ids, cos[:, :, None], sin[:, :, None], False,
                             multislot=True),
                   cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FP32_ATOL,
                               rtol=0)
    for name, after in (("k", cache.k), ("v", cache.v)):
        np.testing.assert_allclose(after.numpy(),
                                   np.asarray(upd["cache"][name]),
                                   atol=FP32_ATOL, rtol=0)


# ---- token identity with the JAX engine and generate -----------------------

def test_staggered_requests_match_jax(setup):
    """Three ragged requests admitted at different times (5/11/3 tokens, 2
    slots; the third queues): equal to the JAX engine's tokens and to each
    request's solo JAX ``generate``."""
    ps, news = prompts(3, (5, 11, 3)), (10, 6, 12)

    def traffic(eng):
        eng.submit(ps[0], news[0])
        eng.step()
        eng.step()
        eng.submit(ps[1], news[1])
        eng.step()
        eng.submit(ps[2], news[2])   # queued: both slots busy
        return eng.run()

    out = both(setup, traffic)
    for rid, p, n in zip(range(3), ps, news):
        np.testing.assert_array_equal(out[rid], want_generate(setup, p, n))


def test_slot_reuse_after_retirement(setup):
    """A slot freed by a finished request serves the next one: the stale
    cache beyond the new prompt never leaks into its attention."""
    long_p, short_p = prompts(3, (5, 11, 3))[1:]

    def traffic(eng):
        eng.submit(long_p, 6)     # fills rows 0..16 of slot 0
        out = eng.run()
        eng.submit(short_p, 12)   # reuses slot 0; rows 3..16 stale
        out.update(eng.run())
        return out

    out = both(setup, traffic, jax_kw={}, n_slots=1)
    np.testing.assert_array_equal(out[0], want_generate(setup, long_p, 6))
    np.testing.assert_array_equal(out[1], want_generate(setup, short_p, 12))


@pytest.mark.parametrize("horizon", [1, 3])
def test_step_horizon(setup, horizon):
    """``step_horizon`` 3 equals 1, with request lengths that are not
    horizon multiples (surplus tokens discarded) and an eos mid-horizon;
    each equals the JAX engine of the same horizon."""
    ps, news = prompts(3, (5, 11, 3)), (10, 6, 12)
    eos = int(want_generate(setup, ps[0], 10)[5])

    def traffic(eng):
        for p, n in zip(ps, news):
            eng.submit(p, n)
        eng.step()
        out = eng.run()
        eng.submit(ps[0], 10, eos_id=eos)
        out.update(eng.run())
        return out

    # the horizon-1 JAX engine is the module's default one
    out = both(setup, traffic, jax_kw={} if horizon == 1 else None,
               step_horizon=horizon)
    for rid, p, n in zip(range(3), ps, news):
        np.testing.assert_array_equal(out[rid], want_generate(setup, p, n))
    full = want_generate(setup, ps[0], 10)
    np.testing.assert_array_equal(out[3], full[:int(np.argmax(full == eos))
                                               + 1])


def test_eos_retires_early(setup):
    p = prompts(3, (5,))[0]
    full = want_generate(setup, p, 10)
    eos = int(full[4])

    def traffic(eng):
        eng.submit(p, 10, eos_id=eos)
        out = eng.run()
        assert all(s is None for s in eng._slots)
        return out

    out = both(setup, traffic, jax_kw={}, n_slots=1)
    np.testing.assert_array_equal(out[0], full[:int(np.argmax(full == eos))
                                               + 1])


def test_prefix_caching_matches_full_prompt(setup):
    """A registered prefix is prefilled once; requests carrying it continue
    exactly as the full prefix + suffix prompt would, beside a plain
    request."""
    ps = prompts(21, (6, 5, 7))
    prefix, suffix = ps[0], ps[1]

    def traffic(eng):
        pid = eng.register_prefix(prefix)
        a = eng.submit(suffix, 6, prefix_id=pid)
        eng.submit(ps[2], 7)
        eng.submit(suffix[:2], 10, prefix_id=pid)
        out = eng.run()
        assert min(out) == a
        return by_order(out)

    eng = setup.engine()
    out = traffic(eng)
    same_tokens(out, traffic(setup.jax_engine()))
    assert eng.stats["prefix_prefills"] == 1
    # the plain request's prefill and the prefix's; suffixes attend the
    # cache and are not fresh
    assert eng.stats["fresh_prefills"] == 2
    np.testing.assert_array_equal(
        out[0], want_generate(setup, np.concatenate([prefix, suffix]), 6))


def test_chunked_prefill_matches_whole_prompt(setup):
    """``prefill_chunk`` splits a long prompt across engine steps (private
    accumulating cache, exact appends after the cursor), with and without a
    prefix; only each prompt's first chunk is a fresh prefill."""
    ps = prompts(3, (5, 11, 3))
    prefix = prompts(21, (6,))[0]

    def traffic(eng):
        pid = eng.register_prefix(prefix)
        eng.submit(ps[1], 6)                  # 11 → 3 chunks
        eng.submit(ps[0], 6, prefix_id=pid)   # 5 → 2 chunks
        eng.submit(ps[2], 12)                 # under the chunk
        return by_order(eng.run())

    eng = setup.engine(prefill_chunk=4)
    out = traffic(eng)
    same_tokens(out, traffic(setup.jax_engine(prefill_chunk=4)))
    # prefix, the short request, the long prompt's first chunk
    assert eng.stats["fresh_prefills"] == 3
    np.testing.assert_array_equal(out[0], want_generate(setup, ps[1], 6))
    np.testing.assert_array_equal(out[2], want_generate(setup, ps[2], 12))
    np.testing.assert_array_equal(
        out[1], want_generate(setup, np.concatenate([prefix, ps[0]]), 6))


def test_decode_continues_between_chunks(setup):
    """While a long prompt prefills chunk by chunk, an active request keeps
    emitting tokens, and both end as the JAX engine's."""
    ps = prompts(3, (5, 11, 3))
    eng = setup.engine(prefill_chunk=3)

    def emitted(rid):
        return next(len(s.emitted) for s in eng._slots
                    if s is not None and s.request_id == rid)

    r_active = eng.submit(ps[2], 12)
    eng.step()
    before = emitted(r_active)
    r_long = eng.submit(ps[1], 6)                 # 11 tokens → 4 chunks
    for _ in range(3):
        eng.step()
    assert eng._prefilling is not None
    assert emitted(r_active) >= before + 3
    out = eng.run()
    np.testing.assert_array_equal(out[r_active],
                                  want_generate(setup, ps[2], 12))
    np.testing.assert_array_equal(out[r_long], want_generate(setup, ps[1], 6))


def test_burst_admission_batches_prefills(setup):
    """A burst of same-bucket requests admits through ONE batched prefill
    (not one per request), and each still matches."""
    ps = prompts(27, (4, 9, 6, 12))

    def traffic(eng):
        for p in ps:
            eng.submit(p, 5)
        eng.step()
        assert eng.free_slots == 0
        return eng.run()

    eng = setup.engine(n_slots=4)
    out = traffic(eng)
    assert eng.stats["fresh_prefills"] == 1
    assert eng.stats["prefill_positions"] == 4 * 64
    same_tokens(out, by_order(traffic(setup.jax_engine(n_slots=4))))


@pytest.mark.parametrize("seed", [31, 32])
def test_random_traffic_fuzz(setup, seed):
    """Ragged lengths, random admission times, random slot counts and
    horizons, prefix and plain requests interleaved, slot churn: every
    continuation equals the JAX engine's."""
    rng = np.random.default_rng(seed)
    n_slots, horizon = int(rng.integers(1, 4)), int(rng.integers(1, 5))
    prefix = rng.integers(0, 256, size=10).astype(np.int32)
    reqs = []
    for _ in range(8):
        lp, n = int(rng.integers(1, 14)), int(rng.integers(1, 11))
        reqs.append((rng.integers(0, 256, size=lp).astype(np.int32), n,
                     bool(rng.random() < 0.4), int(rng.integers(0, 3))))

    def traffic(eng):
        pid = eng.register_prefix(prefix)
        ids = []
        for p, n, with_prefix, steps in reqs:
            ids.append(eng.submit(p, n,
                                  prefix_id=pid if with_prefix else None))
            for _ in range(steps):
                eng.step()
        out = eng.run()
        return {j: out[rid] for j, rid in enumerate(ids)}

    # greedy tokens do not depend on the slot count or the horizon
    same_tokens(traffic(setup.engine(n_slots=n_slots,
                                     step_horizon=horizon)),
                traffic(setup.jax_engine()))


def test_concurrent_submitters_one_stepping_thread(setup):
    """Four threads submit while one thread steps the engine: every request is
    served exactly once, ids never collide, and every continuation equals
    the JAX engine's."""
    eng = setup.engine(n_slots=3, step_horizon=2)
    submitted, lock, stop, collected = {}, threading.Lock(), \
        threading.Event(), {}

    def frontend(tid):
        rng = np.random.default_rng(100 + tid)
        for _ in range(5):
            p = rng.integers(0, 256, size=int(rng.integers(2, 10))).astype(
                np.int32)
            n = int(rng.integers(1, 7))
            rid = eng.submit(p, n)
            with lock:
                assert rid not in submitted
                submitted[rid] = (p, n)

    def stepper():
        while not stop.is_set() or eng._queue \
                or any(s is not None for s in eng._slots):
            for rid in eng.step():
                collected[rid] = eng.result(rid)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=frontend, args=(t,))
                   for t in range(4)]
        loop = threading.Thread(target=stepper)
        loop.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        stop.set()
        loop.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not loop.is_alive() and not any(t.is_alive() for t in threads)
    assert set(collected) == set(submitted) and len(collected) == 20
    jeng = setup.jax_engine()
    want = {rid: jeng.submit(p, n) for rid, (p, n) in sorted(
        submitted.items())}
    jout = jeng.run()
    same_tokens(collected, {rid: jout[j] for rid, j in want.items()})


# ---- the lifecycle ---------------------------------------------------------

def test_streaming_callback_order(setup):
    """``on_token`` streams every kept token in order as it is emitted (the
    first before the request completes), ``on_retire`` fires once with the
    tokens, and an eos stops the stream at the kept tokens."""
    p = prompts(3, (5,))[0]
    streamed, partial, retired = [], [], []
    eng = setup.engine(n_slots=1, step_horizon=2,
                       on_retire=lambda rid, toks: retired.append(
                           (rid, toks.tolist())))

    def on_token(rid, tok):
        streamed.append((rid, tok))
        partial.append(eng.result(rid) is None)

    rid = eng.submit(p, 7, on_token=on_token)
    out = eng.run()[rid]
    assert streamed == [(rid, t) for t in out.tolist()]
    assert partial[0]
    assert retired == [(rid, out.tolist())]
    full = want_generate(setup, p, 10)
    streamed.clear()
    eos = int(full[3])
    r2 = eng.submit(p, 10, eos_id=eos, on_token=on_token)
    out2 = eng.run()[r2]
    assert [t for _, t in streamed] == out2.tolist() == \
        full[:int(np.argmax(full == eos)) + 1].tolist()


def test_raising_callback_is_detached(setup):
    """A raising callback (a client gone away) is detached with a warning;
    its request completes, and a concurrent request stays exact."""
    ps = prompts(3, (5, 11, 3))

    def explode(rid, tok):
        raise RuntimeError("client went away")

    sm = pmetrics.ServingMetrics()
    eng = setup.engine(step_horizon=2, on_retire=explode, metrics=sm)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        bad = eng.submit(ps[0], 6, on_token=explode)
        good = eng.submit(ps[1], 6)
        out = eng.run()
    messages = [str(x.message) for x in w]
    assert sum("streaming detached" in m for m in messages) == 1
    assert sum("on_retire callback raised" in m for m in messages) == 1
    assert sm.counters["callback_errors"] == 2
    assert out[bad].shape == (6,)
    np.testing.assert_array_equal(out[good], want_generate(setup, ps[1], 6))


def test_sampled_engine_bounds_and_seed(setup):
    """temperature > 0: tokens in the vocabulary, every request drained,
    and the same generator seed gives the same tokens."""
    ps = prompts(8, (5, 5, 5))

    def run(seed):
        eng = setup.engine(temperature=0.9, top_k=20, top_p=0.9,
                           generator=torch.Generator().manual_seed(seed))
        ids = [eng.submit(p, 6) for p in ps]
        out = eng.run()
        assert set(out) == set(ids)
        return out

    a, b, c = run(11), run(11), run(12)
    for t in a.values():
        assert t.shape == (6,) and (t >= 0).all() and (t < 256).all()
    same_tokens(a, b)
    assert any(not np.array_equal(a[r], c[r]) for r in a)


def test_timestamps_ride_the_injected_clock(setup):
    """Every timestamp reads the engine's ``clock``: on a virtual clock the
    submit times are virtual, and the time to first token and the latency
    measured through ``on_token``/``on_retire`` are exact virtual
    durations."""
    class VClock:
        t = 1000.0

        def __call__(self):
            return self.t

    vclock = VClock()
    first, done = {}, {}
    eng = setup.engine(n_slots=1, clock=vclock,
                       on_retire=lambda rid, toks: done.setdefault(
                           rid, vclock()))
    rid = eng.submit(prompts(5, (4,))[0], 3,
                     on_token=lambda r, t: first.setdefault(r, vclock()))
    assert eng._queue[0].submitted_at == 1000.0
    vclock.t += 2.5
    eng.step()
    assert eng._slots[0].submitted_at == 1000.0
    vclock.t += 4.0
    eng.run()
    assert first[rid] - 1000.0 == 2.5 and done[rid] - 1000.0 == 6.5


def test_queue_cap_raises_overloaded(setup):
    eng = setup.engine(n_slots=1, queue_cap=2)
    ps = prompts(3, (5, 11, 3))
    eng.submit(ps[0], 4)
    eng.submit(ps[1], 4)
    with pytest.raises(EngineOverloadedError) as err:
        eng.submit(ps[2], 4)
    assert (err.value.inflight, err.value.cap) == (2, 2)
    eng.step()               # one admitted, one queued: still 2 in flight
    with pytest.raises(EngineOverloadedError):
        eng.submit(ps[2], 4)
    eng.run()
    eng.submit(ps[2], 4)     # drained: room again


def test_abort_reset_and_replace_params(setup):
    """``abort`` frees a queued, a chunked-prefilling and a decoding request
    at once; ``reset`` drops all in-flight state and the engine serves on;
    ``replace_params`` refuses a busy engine and a mismatched tree, then
    swaps in a same-shape tree whose tokens equal a fresh engine's."""
    ps = prompts(3, (5, 11, 3))
    eng = setup.engine(n_slots=1, prefill_chunk=4)
    decoding = eng.submit(ps[2], 10)
    eng.step()
    chunking = eng.submit(ps[1], 4)
    queued = eng.submit(ps[0], 4)
    with pytest.raises(RuntimeError, match="busy"):
        eng.replace_params(setup.params)
    assert eng.abort(queued).size == 0
    assert eng.abort(decoding).size == 2
    eng.step()                                   # first chunk of 3
    assert eng._prefilling is not None
    assert eng.abort(chunking).size == 0
    assert eng.abort(12345) is None
    assert eng._prefilling is None and eng.free_slots == 1

    eng.submit(ps[0], 10)
    eng.step()
    eng.submit(ps[2], 4)
    assert eng.reset() == [3, 4]
    assert eng.free_slots == 1 and not eng._queue

    with pytest.raises(ValueError, match="structure"):
        eng.replace_params({k: v for k, v in setup.params.items()
                            if k != "embed"})
    bad = dict(setup.params, embed=setup.params["embed"][:, :8])
    with pytest.raises(ValueError, match="leaf mismatch"):
        eng.replace_params(bad)
    other = {k: (v * 1.5 if k.endswith("weight") else v)
             for k, v in setup.params.items()}
    assert eng.replace_params(other) is setup.params
    assert eng.stats["param_swaps"] == 1
    r = eng.submit(ps[1], 6)
    fresh = ContinuousBatchingEngine(setup.pcfg, other, n_slots=1,
                                     device="cpu")
    f = fresh.submit(ps[1], 6)
    np.testing.assert_array_equal(eng.run()[r], fresh.run()[f])


def test_validation(setup):
    eng = setup.engine(n_slots=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.arange(4), 0)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(np.arange(60), 10)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit(np.arange(4), 2, prefix_id=99)
    with pytest.raises(ValueError, match="empty prefix"):
        eng.register_prefix(np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="no room"):
        eng.register_prefix(np.arange(64))
    pid = eng.register_prefix(np.arange(40))
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(np.arange(10), 20, prefix_id=pid)   # 40+10+20 > 64
    assert eng.drop_prefix(pid) and not eng.drop_prefix(pid)


@pytest.mark.parametrize("kw, match", [
    (dict(step_horizon=0), "step_horizon"),
    (dict(queue_cap=0), "queue_cap"),
    (dict(prefill_chunk=-1), "prefill_chunk"),
    (dict(kv_pages=-1), "kv_pages"),
    (dict(kv_pages=8, page_tokens=24), "must divide max_len"),
    (dict(kv_pages=8, page_tokens=16, step_horizon=17), "exceeds page"),
])
def test_bad_constructor_arguments(setup, kw, match):
    with pytest.raises(ValueError, match=match):
        setup.engine(**kw)


@pytest.mark.parametrize("arg", ["mesh", "rules", "shard_metrics"])
def test_unported_arguments_raise(setup, arg):
    """The mesh arguments are ported (``tests/test_torch_serve_shard.py``
    serves on meshes); a value the engine cannot serve with raises before
    anything is built, naming the argument: a mesh that is not a
    ``DeviceMesh``, rules without a mesh (never quietly meshless), a
    metrics object that is not a ``ShardMetrics``."""
    with pytest.raises((TypeError, ValueError), match=f"{arg}="):
        setup.engine(**{arg: object() if arg != "rules" else []})


def test_int8_weights_engine_serves(setup):
    """``int8_weights`` serves the W8A16 tree of the deterministic
    quantizer; its tokens equal the JAX int8 engine's."""
    ps = prompts(3, (5, 11))

    def traffic(eng):
        for p in ps:
            eng.submit(p, 6)
        return eng.run()

    both(setup, traffic, int8_weights=True)


# ---- metrics ---------------------------------------------------------------

def test_serving_metrics(setup):
    """The engine reports through ``ServingMetrics``: counters, the TTFT,
    queue-wait and latency histograms, the slot and queue gauges; its
    counts and gauges equal the JAX engine's for the same traffic."""
    def traffic(eng, m):
        rng = np.random.default_rng(13)
        ids = [eng.submit(rng.integers(0, 256, size=4 + i).astype(np.int32),
                          3) for i in range(3)]
        assert m.counters["requests_submitted"] == 3
        assert m.gauges["queue_depth"] == 3     # nothing admitted yet
        out = eng.run()
        assert set(out) == set(ids)
        return out

    m = pmetrics.ServingMetrics()
    out = traffic(setup.engine(n_slots=1, metrics=m), m)
    assert m.counters["requests_finished"] == 3
    assert m.counters["tokens_emitted"] == 9   # 3 requests x 3 tokens
    assert len(m.histograms["time_to_first_token_seconds"]) == 3
    assert len(m.histograms["queue_wait_seconds"]) == 3
    assert len(m.histograms["request_latency_seconds"]) == 3
    # one slot: the 2nd and 3rd requests queued longer than the 1st
    waits = m.histograms["queue_wait_seconds"]
    assert waits[0] <= waits[1] <= waits[2]
    for ttft, lat in zip(m.histograms["time_to_first_token_seconds"],
                         m.histograms["request_latency_seconds"]):
        assert lat >= ttft
    assert m.gauges["slots_active"] == 0 and m.gauges["queue_depth"] == 0

    jm = jmetrics.ServingMetrics()
    jout = traffic(JEngine(setup.jcfg, setup.jparams, n_slots=1, metrics=jm),
                   jm)
    same_tokens(by_order(out), by_order(jout))
    assert dict(m.counters) == dict(jm.counters)
    assert m.gauges == jm.gauges
    assert dict(m.histogram_counts) == dict(jm.histogram_counts)


def _feed(m, paged: bool) -> None:
    """The same calls on either package's metrics object: values in several
    buckets and past the last, exemplars whose ids need escaping."""
    if paged:
        m.inc("page_allocs", 7)
        m.inc("pages_aliased", 2)
        m.inc("admission_stalls")
        m.set_gauge("pages_total", 24)
        m.set_gauge("pages_in_use", 5)
        return
    m.inc("requests_submitted", 3)
    m.inc("tokens_emitted", 41)
    m.set_gauge("queue_depth", 2)
    m.set_gauge("slots_active", 1.5)
    for i, v in enumerate((0.0005, 0.01, 0.3, 0.3, 7.0, 45.0)):
        m.observe("time_to_first_token_seconds", v,
                  exemplar=f'trace "{i}"\\n' if i % 2 else None)
    m.observe("request_latency_seconds", 1.25)


@pytest.mark.parametrize("cls, paged", [("ServingMetrics", False),
                                        ("PagedKVMetrics", True)])
@pytest.mark.parametrize("openmetrics", [False, True])
def test_render_text_matches_the_jax_package(cls, paged, openmetrics):
    ours, theirs = getattr(pmetrics, cls)(), getattr(jmetrics, cls)()
    _feed(ours, paged)
    _feed(theirs, paged)
    assert (pmetrics.render_text(ours, openmetrics=openmetrics)
            == jmetrics.render_text(theirs, openmetrics=openmetrics))
    assert ours._families == {n: pmetrics._Family(*dataclasses.astuple(f))
                              for n, f in theirs._families.items()}


def test_exposition_and_serve_without_prometheus_client(monkeypatch):
    """With ``_prom`` patched to None, ``exposition()`` is ``render_text``
    and ``serve()`` answers /metrics from a stdlib HTTP thread (on
    localhost, an ephemeral port) with that body."""
    monkeypatch.setattr(pmetrics, "_prom", None)
    m = pmetrics.ServingMetrics()
    assert m.registry is None
    _feed(m, paged=False)
    body = pmetrics.exposition(m)
    assert body == pmetrics.render_text(m)
    assert "tpu_on_k8s_serving_requests_submitted_total 3.0" in body
    assert pmetrics.exposition(m, openmetrics=True).endswith("# EOF\n")
    _check_served(m)


def _check_served(m) -> None:
    """``serve(m, 0)`` answers /metrics with ``exposition(m)`` (on
    localhost, an ephemeral port) and 404 elsewhere."""
    server = pmetrics.serve(m, 0)
    # no proxy: the request must stay on this host whatever the environment
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with opener.open(url + "/metrics", timeout=30) as r:
            assert r.status == 200
            assert r.read().decode() == pmetrics.exposition(m)
        with pytest.raises(urllib.error.HTTPError, match="404"):
            opener.open(url + "/other", timeout=30)
    finally:
        server.shutdown()
        server.server_close()


def test_exposition_with_prometheus_client_is_the_clients():
    if pmetrics._prom is None:
        pytest.skip("prometheus_client is not installed here")
    m = pmetrics.PagedKVMetrics()
    _feed(m, paged=True)
    assert pmetrics.exposition(m) == pmetrics._prom.generate_latest(
        m.registry).decode()
    assert "tpu_on_k8s_paged_page_allocs_total 7.0" in pmetrics.exposition(m)


def test_serve_with_prometheus_client_answers_the_clients_body():
    """The same stdlib server answers when the client imported, and its
    body is then the client's rendering of the registry."""
    if pmetrics._prom is None:
        pytest.skip("prometheus_client is not installed here")
    m = pmetrics.ServingMetrics()
    assert m.registry is not None
    _feed(m, paged=False)
    assert pmetrics.exposition(m) == pmetrics._prom.generate_latest(
        m.registry).decode()
    _check_served(m)


# ---- chaos at the step -----------------------------------------------------

def test_engine_crash_mid_decode(setup):
    """``engine_crash_mid_decode(at_steps=(3,))`` on the port's injector:
    the third ``step()`` raises ``EngineCrashError`` and counts a crash, as
    the JAX engine's does under the JAX injector; ``reset()`` drops every
    in-flight request and the engine serves on, exactly."""
    ps = prompts(9, (5, 7, 4))

    def crash(eng, scenario):
        ids = [eng.submit(p, 8) for p in ps]
        crashes = eng.stats["crashes"]
        with scenario(at_steps=(3,)).injector() as inj:
            eng.step()
            eng.step()
            with pytest.raises(RuntimeError,
                               match="crashed mid-decode") as err:
                eng.step()
        assert eng.stats["crashes"] == crashes + 1
        assert eng.reset() == sorted(ids)
        return err.type.__name__, inj.events

    eng = setup.engine()
    got = crash(eng, chaos.engine_crash_mid_decode)
    assert got == (EngineCrashError.__name__,
                   ["seq=1 engine_crash note=crash mid-decode"])
    assert chaos.active() is None
    assert got == crash(setup.jax_engine(),
                        jscenarios.engine_crash_mid_decode)
    assert eng.free_slots == 2 and not eng._queue
    rid = eng.submit(ps[1], 8)
    np.testing.assert_array_equal(eng.run()[rid],
                                  want_generate(setup, ps[1], 8))


def test_engine_stall_moves_no_token(setup):
    """An ``EngineStall`` rule: ``step()`` returns ``[]`` with no
    admission, no token and no retirement; the next step moves again and
    every token is exact."""
    p, q = prompts(10, (6, 9))
    eng = setup.engine()
    rid = eng.submit(p, 6)
    eng.step()
    queued = eng.submit(q, 4)
    before = dict(eng.stats)
    emitted = list(eng._slots[0].emitted)
    rule = chaos.FaultRule(chaos.SITE_SERVE_STEP, chaos.on_call(1, 2),
                           chaos.EngineStall())
    with chaos.FaultInjector([rule], seed=0) as inj:
        assert eng.step() == [] and eng.step() == []
        assert eng.stats == before and eng._slots[0].emitted == emitted
        assert [r.request_id for r in eng._queue] == [queued]
        eng.step()
        assert eng.stats["emitted"] > before["emitted"]
    assert inj.counts() == {"serve.engine.step#0": (3, 2)}
    out = eng.run()
    np.testing.assert_array_equal(out[rid], want_generate(setup, p, 6))
    np.testing.assert_array_equal(out[queued], want_generate(setup, q, 4))


def test_injector_fires_as_the_jax_package_does():
    """The copied injector elects the same invocations as the reference for
    one seeded schedule (``prob``, ``every`` with a limit, ``at``, a ctx
    filter), logs the same events, and refuses to stack."""
    def schedule(ch):
        return [
            ch.FaultRule(ch.SITE_SERVE_STEP, ch.with_prob(0.3),
                         ch.EngineStall(), note="flaky"),
            ch.FaultRule(ch.SITE_SERVE_STEP, ch.every(4, limit=3),
                         ch.EngineCrash()),
            ch.FaultRule(ch.SITE_SERVE_STEP,
                         ch.Trigger(at=(2,), match={"replica": "r-1"}),
                         ch.EngineCrash(), note="r-1"),
        ]

    def run(ch):
        inj = ch.FaultInjector(schedule(ch), seed=7)
        kinds = [getattr(inj.fire(ch.SITE_SERVE_STEP, steps=i,
                                  replica=f"r-{i % 11}"), "kind", None)
                 for i in range(60)]
        return kinds, inj.events, inj.counts(), inj.fired_total()

    got = run(chaos)
    assert got == run(jchaos)
    assert got == run(chaos)
    assert got[3] > 3
    first = chaos.FaultInjector(schedule(chaos), name="first")
    with first:
        with pytest.raises(RuntimeError, match="already installed"):
            chaos.install(chaos.FaultInjector([]))
    assert chaos.active() is None
    with pytest.raises(ValueError, match="trigger needs"):
        chaos.Trigger()


# ---- the CLI ---------------------------------------------------------------

def test_cli_serves_on_cpu(capsys):
    out = cli.main(["--config", "tiny", "--device", "cpu", "--n-requests",
                    "4", "--n-slots", "2", "--max-new-tokens", "3",
                    "--system-prompt-len", "8", "--kv-pages", "16"])
    assert len(out) == 4 and all(t.shape == (3,) for t in out.values())
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("served 4 requests, 12 tokens")
    assert "p50 latency" in line and "p50 TTFT" in line


def test_cli_metrics_port_serves_the_engine_metrics(capsys, monkeypatch):
    """``--metrics-port`` hands the engine's ``ServingMetrics`` to
    ``serve`` (patched here: no port is bound), and the closing line's p50
    latency and TTFT come from its histograms."""
    bound = []
    monkeypatch.setattr(cli_module, "serve_metrics",
                        lambda m, port: bound.append((m, port)))
    out = cli.main(["--config", "tiny", "--device", "cpu", "--n-requests",
                    "3", "--n-slots", "2", "--max-new-tokens", "3",
                    "--metrics-port", "9100"])
    (m, port), = bound
    assert port == 9100 and len(out) == 3
    assert m.counters["requests_submitted"] == m.counters[
        "requests_finished"] == 3
    assert m.counters["tokens_emitted"] == 9
    lat = m.histograms["request_latency_seconds"]
    assert len(lat) == len(m.histograms["time_to_first_token_seconds"]) == 3
    lines = capsys.readouterr().out.splitlines()
    assert "metrics at :9100/metrics" in lines
    assert lines[-1].startswith("served 3 requests, 9 tokens")
    assert (f"p50 latency {np.median(list(lat)) * 1e3:.0f}ms"
            in lines[-1]) and "p50 TTFT" in lines[-1]


@pytest.mark.parametrize("flag", [
    ["--model-axis", "2"], ["--fsdp", "2"]])
def test_cli_unported_flags_raise(flag):
    """The mesh flags are ported; without a launcher's world the process is
    a world of one rank, which a two-rank mesh does not fit (the
    reference's JAX raises alike on one device). The world it made is gone
    after the error."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match="onto 1 devices|needs 2 devices "
                                         "but 1"):
        cli.main(["--device", "cpu", *flag])
    assert not dist.is_initialized()


def test_cli_checkpoint_dir_serves_the_saved_parameters(tmp_path, capsys):
    """``--checkpoint-dir`` serves the newest checkpoint's parameters: the
    same tokens as the CLI on the random weights it was saved from; a
    directory without checkpoints raises."""
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager

    cfg = TransformerConfig.tiny()
    params = pparams.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", dtype=torch.float32)
    CheckpointManager(str(tmp_path / "ck")).save(
        {f"params/{k}": v for k, v in params.items()}, step=5)
    argv = ["--device", "cpu", "--n-requests", "3"]
    want = cli.main(argv)
    got = cli.main([*argv, "--checkpoint-dir", str(tmp_path / "ck")])
    assert "restored generation=0 step=5" in capsys.readouterr().out
    assert {r: t.tolist() for r, t in got.items()} == {
        r: t.tolist() for r, t in want.items()}
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        cli.main([*argv, "--checkpoint-dir", str(tmp_path / "none")])


def test_cli_and_engine_refuse_without_cuda(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config", "tiny"])
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatchingEngine(setup.pcfg, setup.params)
