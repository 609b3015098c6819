"""The port's disaggregated serving (``serve/disagg.py``) and fleet prefix
store (``serve/kvstore.py``) against the JAX package's, on the CPU.

The reference's own tests (``tests/test_serve_disagg.py``), each run as one
scenario through the JAX plane over JAX engines and through the port's
plane over the port's engines (the harness of ``test_torch_serve_gateway.py``:
a tiny fp32 model carried across with ``from_jax_params``, seeded prompts,
greedy decoding, injected fake clocks). The two runs must agree exactly:
each request's tokens and final state, the fleet's ``stats`` and
``event_log`` line for line, the prefix store's ``stats`` and
``snapshot()``, the engines' counters, the per-pool autoscaler's
``decision_log`` line for line (each plane's own ``FleetAutoscaler``
driving its own fleet), the observation lines, and the
``FleetMetrics`` exposition text (``render_text``). Tolerances: none.

The store's control-plane cases run over a stub engine whose exported
payloads are torch tensors on the port's side (numpy arrays on the
reference's); ``test_prefix_store_page_chunks_match_over_real_engines``
adds what the reference's tiny prompts never reach, prefixes longer than
a page chunk, so that the port slices, deduplicates and re-joins real
torch payloads. The per-pool autoscaler cases drive the port's fleet
through the port's ``FleetAutoscaler`` on the port's ``InferenceService``
and cluster, and the reference's fleet through the reference's.

Direct cross-checks: ``prefix_hash`` on seeded token arrays, and
``pool_observation_line`` parsed by the reference's ``sample_from_line``.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_serve_gateway import (
    FakeClock,
    both,
    engine_counts,
    make_setup,
    outcome,
    result,
    text,
)
import tpu_on_k8s.api.core as jcore
import tpu_on_k8s.api.inference_types as jit
import tpu_on_k8s.client.cluster as jcluster
import tpu_on_k8s.controller.fleetautoscaler as jfleetautoscaler
import tpu_on_k8s_torch.api.core as pcore
import tpu_on_k8s_torch.api.inference_types as pit
import tpu_on_k8s_torch.client.cluster as pcluster
import tpu_on_k8s_torch.controller.fleetautoscaler as pfleetautoscaler
from tpu_on_k8s.autoscale.signals import sample_from_line
from tpu_on_k8s.serve.kvstore import prefix_hash as j_prefix_hash
from tpu_on_k8s_torch.serve.kvstore import prefix_hash as p_prefix_hash

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    return make_setup({"v1": 1})


class TickingClock(FakeClock):
    def __call__(self) -> float:
        self.t += 0.25
        return self.t


def _factory(plane, n_slots=2, **kw):
    def make(name):
        return plane.engine(n_slots=n_slots, **kw)
    return make


def _prompt(rng, n):
    return rng.integers(0, 256, size=int(n)).astype(np.int32)


def _prompts(rng, prefix, n, lo=3, hi=9):
    """n prompts sharing ``prefix`` with distinct random suffixes."""
    return [np.concatenate([prefix, _prompt(rng, lo + i % (hi - lo))])
            for i in range(n)]


def _disagg(plane, *, prefill=1, decode=2, clock=None, **kw):
    return plane.serve.DisaggFleet(
        _factory(plane), prefill_replicas=prefill, decode_replicas=decode,
        prefix_bucket_len=8, clock=clock or FakeClock(), **kw)


def results(out):
    return {r: result(v) for r, v in out.items()}


def disagg_view(plane, fleet):
    return {"stats": dict(fleet.stats), "events": list(fleet.event_log),
            "store": (dict(fleet.store.stats), fleet.store.snapshot()),
            "replicas": {n: (r.pool, r.state.value,
                             None if r.engine is None
                             else engine_counts(r.engine))
                         for n, r in fleet.replicas.items()},
            "metrics": (None if fleet.metrics is None
                        else text(plane, fleet.metrics))}


def flip_first_byte(plane, cache):
    """A copy of a handoff payload with one byte of its first leaf
    flipped."""
    if plane.name == "port":
        bad = {k: v.clone() for k, v in cache.items()}
        bad[sorted(bad)[0]].reshape(-1).view(torch.uint8)[0] ^= 0xFF
    else:
        bad = jax.tree.map(np.array, cache)
        jax.tree.leaves(bad)[0].reshape(-1).view(np.uint8)[0] ^= 0xFF
    return bad


# ------------------------------------------------------------ KV oracle tests
def test_kv_handoff_roundtrip_oracle(setup):
    def scenario(plane):
        prompt = _prompt(np.random.default_rng(0), 12)
        a, b = plane.engine(n_slots=2), plane.engine(n_slots=2)
        job = a.start_prefill(prompt)
        while not job.advance():
            pass
        ho = job.handoff()
        assert ho.verify() and ho.pos == prompt.size and ho.base == 0
        rid = b.submit_kv(ho, max_new_tokens=8)
        out = b.run()[rid]
        assert b.stats["kv_adopted"] == 1
        assert b.stats["prefill_positions"] == 0
        return out.tolist(), engine_counts(b)
    both(setup, scenario)


def test_kv_handoff_chunked_prefill_oracle(setup):
    def scenario(plane):
        prompt = _prompt(np.random.default_rng(1), 20)
        a = plane.engine(n_slots=2, prefill_chunk=4)
        b = plane.engine(n_slots=2)
        job = a.start_prefill(prompt)
        steps = 0
        while not job.advance():
            steps += 1
        assert steps >= 3
        rid = b.submit_kv(job.handoff(), max_new_tokens=6)
        return steps, b.run()[rid].tolist()
    both(setup, scenario)


def test_kv_handoff_suffix_only_oracle(setup):
    def scenario(plane):
        rng = np.random.default_rng(2)
        prefix, suffix = _prompt(rng, 8), _prompt(rng, 6)
        a, b = plane.engine(n_slots=2), plane.engine(n_slots=2)
        job = a.start_prefill(suffix, a.register_prefix(prefix))
        while not job.advance():
            pass
        ho = job.handoff(suffix_only=True,
                         prefix_hash=plane.serve.prefix_hash(prefix))
        assert ho.base == 8 and ho.pos == 14
        rid = b.submit_kv(ho, max_new_tokens=6,
                          prefix_id=b.register_prefix(prefix))
        return ho.prefix_hash, b.run()[rid].tolist()
    both(setup, scenario)


def test_export_import_prefix_roundtrip(setup):
    def scenario(plane):
        rng = np.random.default_rng(3)
        prefix, suffix = _prompt(rng, 8), _prompt(rng, 5)
        a, b = plane.engine(n_slots=2), plane.engine(n_slots=2)
        host, lp = a.export_prefix(a.register_prefix(prefix))
        pid = b.import_prefix(host, lp)
        rid = b.submit(suffix, max_new_tokens=5, prefix_id=pid)
        out = b.run()[rid].tolist()
        assert b.stats["prefix_prefills"] == 0
        return lp, out
    both(setup, scenario)


def test_export_kv_mid_decode_migration_oracle(setup):
    def scenario(plane):
        prompt = _prompt(np.random.default_rng(4), 10)
        a, b = plane.engine(n_slots=2), plane.engine(n_slots=2)
        rid = a.submit(prompt, max_new_tokens=8)
        for _ in range(4):
            a.step()
        ho = a.export_kv(rid)
        assert ho is not None and ho.verify() and len(ho.emitted) >= 2
        a.abort(rid)
        rid2 = b.submit_kv(ho, max_new_tokens=8)
        return list(ho.emitted), b.run()[rid2].tolist()
    both(setup, scenario)


def test_submit_kv_validation_and_checksum(setup):
    def scenario(plane):
        KVHandoff = plane.serving.KVHandoff
        prompt = _prompt(np.random.default_rng(5), 8)
        a, b = plane.engine(n_slots=2), plane.engine(n_slots=2)
        job = a.start_prefill(prompt)
        while not job.advance():
            pass
        ho = job.handoff()
        corrupt = KVHandoff(cache=flip_first_byte(plane, ho.cache),
                            pos=ho.pos, first_token=ho.first_token,
                            emitted=ho.emitted, checksum=ho.checksum)
        assert not corrupt.verify()
        assert ho.verify()
        errors = []
        sfx = KVHandoff(cache=ho.cache, pos=ho.pos,
                        first_token=ho.first_token, emitted=ho.emitted,
                        base=4).seal()
        empty = KVHandoff(cache=ho.cache, pos=ho.pos, first_token=0,
                          emitted=()).seal()
        for handoff, kw in ((ho, {"max_new_tokens": 0}),
                            (ho, {"max_new_tokens": 64}),
                            (empty, {"max_new_tokens": 4}),
                            (sfx, {"max_new_tokens": 4}),
                            (sfx, {"max_new_tokens": 4, "prefix_id": 99})):
            with pytest.raises(ValueError) as ei:
                b.submit_kv(handoff, **kw)
            errors.append(str(ei.value))
        return errors
    both(setup, scenario)


# ---------------------------------------------------------- FleetPrefixStore
class _StubEngine:
    """Control-plane stand-in: the store's bookkeeping without a model.
    Payloads are two byte leaves of a controllable size, torch tensors on
    the port's plane and numpy arrays on the reference's."""

    def __init__(self, plane, leaf_bytes: int = 1024) -> None:
        self.port = plane.name == "port"
        self.leaf_bytes = leaf_bytes
        self.next_pid = 0
        self.registered = {}
        self.dropped = []

    def register_prefix(self, tokens) -> int:
        pid = self.next_pid
        self.next_pid += 1
        self.registered[pid] = np.asarray(tokens)
        return pid

    def export_prefix(self, pid):
        n = len(self.registered[pid])
        zeros = ((lambda: torch.zeros(self.leaf_bytes, dtype=torch.uint8))
                 if self.port
                 else (lambda: np.zeros(self.leaf_bytes, np.uint8)))
        return {"k": zeros(), "v": zeros()}, n

    def import_prefix(self, cache, lp) -> int:
        assert all(isinstance(v, torch.Tensor) == self.port
                   for v in cache.values())
        pid = self.next_pid
        self.next_pid += 1
        self.registered[pid] = np.zeros(lp, np.int32)
        return pid

    def drop_prefix(self, pid) -> bool:
        self.dropped.append(pid)
        return self.registered.pop(pid, None) is not None


def store_view(store):
    return dict(store.stats), store.snapshot(), store.overflow_bytes


def test_prefix_store_hit_promote_miss_ladder(setup):
    def scenario(plane):
        store = plane.serve.FleetPrefixStore(clock=FakeClock())
        e1, e2 = _StubEngine(plane), _StubEngine(plane)
        h = store.register([1, 2, 3, 4])
        assert store.register([1, 2, 3, 4]) == h
        pid1 = store.ensure("r1", e1, h)
        assert store.stats["misses"] == 1 and store.overflow_bytes == 2048
        pid2 = store.ensure("r2", e2, h)
        assert store.stats["promotes"] == 1 and store.stats["misses"] == 1
        assert store.ensure("r1", e1, h) == pid1
        assert store.ensure("r2", e2, h) == pid2
        assert store.stats["hits"] == 2
        assert store.resident_on(h) == ["r1", "r2"]
        store.forget_replica("r2")
        assert store.resident_on(h) == ["r1"]
        return h, store_view(store)
    both(setup, scenario)


def test_prefix_store_lru_eviction_never_evicts_pinned(setup):
    def scenario(plane):
        store = plane.serve.FleetPrefixStore(overflow_budget_bytes=5000,
                                             clock=FakeClock())
        e = _StubEngine(plane, leaf_bytes=1024)
        ha, hb, hc = (store.register([i, i]) for i in (1, 2, 3))
        store.ensure("r", e, ha)
        store.pin(ha)
        store.ensure("r", e, hb)
        assert store.stats["evictions"] == 0
        store.ensure("r", e, hc)
        snap = store.snapshot()
        assert snap[ha]["in_overflow"]
        assert not snap[hb]["in_overflow"]
        assert snap[hc]["in_overflow"]
        assert store.stats["evictions"] == 1
        assert store.stats["pinned_eviction_skips"] >= 1
        mid = store_view(store)
        store.unpin(ha)
        store.ensure("r", e, store.register([4, 4]))
        assert not store.snapshot()[ha]["in_overflow"]
        assert store.overflow_bytes <= 5000
        return mid, store_view(store)
    both(setup, scenario)


def test_prefix_store_demotes_over_device_cap(setup):
    def scenario(plane):
        store = plane.serve.FleetPrefixStore(max_device_prefixes=2,
                                             clock=FakeClock())
        e = _StubEngine(plane)
        hs = [store.register([i, i]) for i in range(1, 4)]
        pids = [store.ensure("r", e, h) for h in hs]
        snap = store.snapshot()
        assert snap[hs[0]]["residency"] == []
        assert snap[hs[1]]["residency"] == ["r"]
        assert snap[hs[2]]["residency"] == ["r"]
        assert e.dropped == [pids[0]]
        assert store.stats["demotes"] == 1
        store.ensure("r", e, hs[0])
        assert store.stats["promotes"] == 1
        return pids, e.dropped, store_view(store)
    both(setup, scenario)


def test_prefix_store_deterministic_under_injectable_clock(setup):
    def scenario(plane):
        def run(skew):
            clock = FakeClock()
            store = plane.serve.FleetPrefixStore(
                overflow_budget_bytes=5000, max_device_prefixes=2,
                clock=clock)
            e = _StubEngine(plane)
            hs = [store.register([i, i, i]) for i in range(1, 5)]
            for i, h in enumerate(hs):
                clock.advance(skew * (i + 1))
                store.ensure("r1", e, h)
            store.pin(hs[2])
            store.ensure("r2", e, hs[0])
            store.ensure("r1", e, hs[3])
            return store.stats.copy(), store.snapshot()
        assert run(0.0) == run(7.3)
        return run(0.0)
    both(setup, scenario)


def test_prefix_store_match_longest(setup):
    def scenario(plane):
        store = plane.serve.FleetPrefixStore(clock=FakeClock())
        h_short = store.register([5, 6])
        h_long = store.register([5, 6, 7, 8])
        assert store.match([5, 6, 7, 8, 9]) == (h_long, 4)
        assert store.match([5, 6, 9]) == (h_short, 2)
        assert store.match([5, 6]) is None
        assert store.match([1, 2, 3]) is None
        return h_short, h_long
    both(setup, scenario)


def test_prefix_store_page_chunks_match_over_real_engines(setup):
    """Prefixes of 13-29 tokens over a 4-token chunk granule, nested so
    that descendants share full-page chunks with their ancestors: a miss
    on a dense engine stores the chunks, promotes onto a second dense
    engine and a paged one (aliasing a resident ancestor's pages) re-join
    them, an over-budget store evicts, and requests decode through every
    promoted prefix. Stats, snapshots and tokens equal the reference's,
    and the port's re-joined payloads equal the exported ones bit for
    bit."""
    def scenario(plane):
        rng = np.random.default_rng(61)
        store = plane.serve.FleetPrefixStore(
            clock=FakeClock(), page_tokens=4, max_device_prefixes=3,
            overflow_budget_bytes=120_000)
        a, b = plane.engine(n_slots=2), plane.engine(n_slots=2)
        paged = plane.engine(n_slots=2, kv_pages=24, page_tokens=16)
        base = _prompt(rng, 13)
        heads = [base, np.concatenate([base, _prompt(rng, 8)]),
                 np.concatenate([base, _prompt(rng, 16)]), _prompt(rng, 17)]
        hs = [store.register(h) for h in heads]
        tokens = []
        for name, eng in (("a", a), ("b", b), ("paged", paged),
                          ("b", b), ("a", a)):
            for h, head in zip(hs, heads):
                pid = store.ensure(name, eng, h)
                rid = eng.submit(_prompt(rng, 5), 4, prefix_id=pid)
                tokens.append(eng.run()[rid].tolist())
        if plane.name == "port":
            for h in hs:
                e = store._entries[h]
                if e.host is None:
                    continue
                joined = store._materialize_locked(e.host)
                pid = e.residency.get("a")
                if pid is not None and pid in a._prefixes:
                    exported, _ = a.export_prefix(pid)
                    assert all(torch.equal(joined[k], exported[k])
                               for k in exported)
        return tokens, store_view(store), engine_counts(paged)
    got = both(setup, scenario)
    stats = got[1][0]
    assert stats["page_chunks_stored"] > 0 and stats["page_chunk_reuses"] > 0
    assert stats["base_aliased_promotes"] > 0 and stats["promotes"] > 0


# ------------------------------------------------------- router satellite fix
def test_router_prefix_content_affinity(setup):
    def scenario(plane):
        r = plane.serve.Router(prefix_bucket_len=8)
        for i in range(4):
            r.add_replica(f"r{i}", "v1")
        ready = [f"r{i}" for i in range(4)]
        prefix = np.arange(100, 105, dtype=np.int32)
        p1 = np.concatenate([prefix, np.full(3, 7, np.int32)])
        p2 = np.concatenate([prefix, np.full(9, 9, np.int32)])
        r.note_prefix(prefix)
        assert r.match_prefix(p1) == (r.bucket_key(p1), 5)
        assert r.bucket_key(p1) == r.bucket_key(p2)
        assert r.route(p1, ready, {}) == r.route(p2, ready, {})
        longer = np.concatenate([prefix, np.full(4, 7, np.int32)])
        r.note_prefix(longer)
        p3 = np.concatenate([longer, np.full(2, 1, np.int32)])
        assert r.match_prefix(p3) == (r.bucket_key(p3), 9)
        head = np.arange(8, dtype=np.int32)
        raw = r.bucket_key(np.concatenate([head, head]))
        r.note_prefix(head)
        assert r.bucket_key(np.concatenate([head, head])) == raw
        return r.route(p1, ready, {}), r.bucket_key(p3), raw
    both(setup, scenario)


def test_fleet_short_noted_prefix_never_splices_bucket_kv(setup):
    def scenario(plane):
        S = plane.serve
        fleet = S.ServingFleet(_factory(plane), 1,
                               probe=S.ProbeConfig(slow_start_steps=1),
                               router=S.Router(prefix_bucket_len=8),
                               clock=FakeClock())
        for _ in range(2):
            fleet.step()
        short = np.arange(50, 55, dtype=np.int32)
        fleet.router.note_prefix(short)
        a = np.concatenate([short, np.full(6, 3, np.int32)])
        b = np.concatenate([short, np.full(6, 9, np.int32)])
        assert fleet.router.bucket_key(a) == fleet.router.bucket_key(b)
        ra = fleet.submit(a, max_new_tokens=5)
        rb = fleet.submit(b, max_new_tokens=5)
        res = fleet.run()
        return result(res[ra]), result(res[rb]), dict(fleet.stats)
    got = both(setup, scenario)
    assert got[0] != got[1]


# ------------------------------------------------------------ DisaggFleet e2e
def test_disagg_fleet_token_identical(setup):
    def scenario(plane):
        rng = np.random.default_rng(6)
        prefix = _prompt(rng, 8)
        fleet = _disagg(plane)
        rids = []
        for p in _prompts(rng, prefix, 5):
            rid = fleet.submit(p, max_new_tokens=5)
            assert isinstance(rid, int)
            rids.append(rid)
        res = fleet.run()
        assert set(res) == set(rids)
        assert all(rr.state is plane.serve.RequestState.DONE
                   for rr in res.values())
        assert fleet.store.stats["misses"] == 1
        assert fleet.stats["handoffs_adopted"] == 5
        for rep in fleet.replicas.values():
            if rep.pool == "decode":
                assert rep.engine.stats["prefill_positions"] == 0
        return results(res), disagg_view(plane, fleet)
    both(setup, scenario)


def test_handoff_adoption_deferred_on_engine_overload(setup):
    def scenario(plane):
        fleet = plane.serve.DisaggFleet(
            _factory(plane, queue_cap=1), prefill_replicas=1,
            decode_replicas=1, prefix_bucket_len=8, clock=FakeClock())
        rng = np.random.default_rng(3)
        rids = [fleet.submit(_prompt(rng, 4), max_new_tokens=4)
                for _ in range(3)]
        res = fleet.run()
        assert any(ln.startswith("adopt_deferred") for ln in fleet.event_log)
        assert all(res[r].state is plane.serve.RequestState.DONE
                   for r in rids)
        return results(res), disagg_view(plane, fleet)
    both(setup, scenario)


def test_auto_register_capped(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(9)
        fleet = _disagg(plane, decode=1, max_auto_prefixes=2)
        prompts = [_prompt(rng, 12) for _ in range(4)]
        rids = [fleet.submit(p, max_new_tokens=3) for p in prompts]
        res = fleet.run()
        assert len(fleet.store) == 2
        assert all(res[r].state is S.RequestState.DONE for r in rids)
        f2 = _disagg(plane, decode=1, max_auto_prefixes=2)
        f2.stop_accepting()
        rejected = [f2.submit(p, max_new_tokens=3) for p in prompts]
        assert all(isinstance(r, S.Rejected) for r in rejected)
        assert len(f2.store) == 0
        return (results(res), disagg_view(plane, fleet),
                [outcome(r) for r in rejected])
    both(setup, scenario)


def test_disagg_event_log_deterministic(setup):
    def scenario(plane):
        def run():
            rng = np.random.default_rng(7)
            prefix = _prompt(rng, 8)
            fleet = _disagg(plane)
            for p in _prompts(rng, prefix, 6):
                fleet.submit(p, max_new_tokens=4)
            fleet.run()
            return "\n".join(fleet.event_log)
        first = run()
        assert first == run()
        return first
    both(setup, scenario)


def test_handoff_backpressure_stages_on_replica(setup):
    def scenario(plane):
        rng = np.random.default_rng(8)
        fleet = plane.serve.DisaggFleet(
            _factory(plane, n_slots=1), prefill_replicas=2,
            decode_replicas=1, prefix_bucket_len=8, handoff_capacity=1,
            clock=FakeClock())
        rids = [fleet.submit(_prompt(rng, 6 + i), max_new_tokens=6)
                for i in range(4)]
        depths = []
        for _ in range(60):
            fleet.step()
            depths.append(fleet.pool_queue_depth("decode"))
            if not fleet.has_live_requests:
                break
        res = fleet._claim_all()
        assert max(depths) > 1
        assert set(res) == set(rids)
        assert all(rr.state is plane.serve.RequestState.DONE
                   for rr in res.values())
        return depths, results(res), disagg_view(plane, fleet)
    both(setup, scenario)


def test_disagg_handoff_chaos_zero_silent_loss(setup):
    def scenario(plane):
        rng = np.random.default_rng(9)
        prefix = _prompt(rng, 8)
        inj = plane.scenarios.disagg_handoff_chaos(
            lose_at=(2,), corrupt_at=(4,)).injector()
        plane.chaos.install(inj)
        try:
            fleet = _disagg(plane, decode=1,
                            replay=plane.serve.ReplayPolicy(max_replays=3))
            rids = [fleet.submit(p, max_new_tokens=5)
                    for p in _prompts(rng, prefix, 5)]
            res = fleet.run()
        finally:
            plane.chaos.uninstall()
        assert set(res) == set(rids)
        assert all(rr.state is plane.serve.RequestState.DONE
                   for rr in res.values())
        assert fleet.stats["handoffs_lost"] == 1
        assert fleet.stats["handoffs_corrupt"] == 1
        assert fleet.stats["replayed"] == 2
        assert fleet.stats["retry_exhausted"] == 0
        assert inj.fired_total() == 2
        return inj.events, results(res), disagg_view(plane, fleet)
    both(setup, scenario)


def test_handoff_loss_replay_budget_exhausts_typed(setup):
    def scenario(plane):
        chaos = plane.chaos
        prompt = _prompt(np.random.default_rng(10), 10)
        inj = chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_KV_HANDOFF, chaos.every(1), chaos.HandoffLoss())],
            seed=0)
        chaos.install(inj)
        try:
            fleet = _disagg(plane, decode=1,
                            replay=plane.serve.ReplayPolicy(max_replays=2))
            rid = fleet.submit(prompt, max_new_tokens=4)
            res = fleet.run()
        finally:
            chaos.uninstall()
        assert res[rid].state is plane.serve.RequestState.RETRY_EXHAUSTED
        assert fleet.stats["replayed"] == 2
        assert fleet.stats["retry_exhausted"] == 1
        return inj.events, results(res), disagg_view(plane, fleet)
    both(setup, scenario)


def test_cancel_and_deadline_each_phase(setup):
    def scenario(plane):
        RS = plane.serve.RequestState
        clock = FakeClock()
        fleet = _disagg(plane, decode=1, clock=clock)
        p = _prompt(np.random.default_rng(11), 10)
        r1 = fleet.submit(p, max_new_tokens=4)
        assert fleet.cancel(r1)
        r2 = fleet.submit(p, max_new_tokens=4, deadline_s=0.5)
        clock.advance(1.0)
        fleet.step()
        assert fleet.state(r1) is RS.CANCELLED
        assert fleet.state(r2) is RS.DEADLINE_EXCEEDED
        r3 = fleet.submit(p, max_new_tokens=8)
        for _ in range(30):
            fleet.step()
            if fleet.state(r3) is RS.DECODING:
                break
        assert fleet.state(r3) is RS.DECODING
        fleet.step()
        fleet.cancel(r3)
        rr = fleet.run()[r3]
        assert rr.state is RS.CANCELLED
        assert 0 < len(rr.tokens) < 8
        return result(rr), disagg_view(plane, fleet)
    both(setup, scenario)


def test_scale_pool_drains_zero_loss(setup):
    def scenario(plane):
        rng = np.random.default_rng(12)
        fleet = _disagg(plane, prefill=2, decode=2)
        rids = [fleet.submit(_prompt(rng, 8 + i), max_new_tokens=5)
                for i in range(6)]
        fleet.step()
        assert fleet.scale_pool("prefill", 1) == -1
        assert fleet.scale_pool("decode", 1) == -1
        res = fleet.run()
        for _ in range(3):
            fleet.step()
        assert set(res) == set(rids)
        assert all(rr.state is plane.serve.RequestState.DONE
                   for rr in res.values())
        stopped = [r for r in fleet.replicas.values()
                   if r.state.value == "stopped"]
        assert len(stopped) == 2 and all(r.engine is None for r in stopped)
        view = disagg_view(plane, fleet)
        assert fleet.scale_pool("decode", 2) == 1
        return results(res), view
    both(setup, scenario)


# ------------------------------------------------------ per-pool autoscaling
#: each plane's control plane: API types, cluster and fleet autoscaler
CONTROL = {"jax": (jcore, jit, jcluster, jfleetautoscaler),
           "port": (pcore, pit, pcluster, pfleetautoscaler)}


def _pool_svc(plane):
    core, it, _, _ = CONTROL[plane.name]
    return it.InferenceService(
        metadata=core.ObjectMeta(name="svc", namespace="default"),
        spec=it.InferenceServiceSpec(
            model_name="m", replicas=2,
            pools=it.PoolsSpec(
                prefill=it.PoolSpec(replicas=1, autoscale=it.AutoscalePolicy(
                    min_replicas=1, max_replicas=4,
                    target_queue_wait_s=0.05, slice_legal=False,
                    scale_up_cooldown_s=0.0, scale_down_cooldown_s=0.0)),
                decode=it.PoolSpec(replicas=1, autoscale=it.AutoscalePolicy(
                    min_replicas=1, max_replicas=4, target_tpot_s=0.01,
                    slice_legal=False, scale_up_cooldown_s=0.0,
                    scale_down_cooldown_s=0.0)))))


def _run_pool_autoscale(plane, seed):
    _, it, cl, fa = CONTROL[plane.name]
    clock = FakeClock()
    fleet = _disagg(plane, decode=1, clock=clock)
    cluster = cl.InMemoryCluster()
    svc = _pool_svc(plane)
    cluster.create(svc)
    scaler = fa.FleetAutoscaler(cluster, clock=clock)
    scaler.register(svc)
    scaler.attach_fleet("default", "svc", fleet)
    rng = np.random.default_rng(seed)
    prefix = _prompt(rng, 8)
    for p in _prompts(rng, prefix, 8):
        fleet.submit(p, max_new_tokens=5)
    for _ in range(3):
        clock.advance(0.2)
        fleet.step()
    scaler.run_once()
    clock.advance(1.0)
    scaler.run_once()
    res = fleet.run()
    svc = cluster.get(it.InferenceService, "default", "svc")
    return list(scaler.decision_log), svc, fleet, res


def test_per_pool_autoscaler_scales_prefill_on_queue_wait(setup):
    def scenario(plane):
        log, svc, fleet, res = _run_pool_autoscale(plane, seed=13)
        assert any("pool=prefill" in ln and "action=up" in ln for ln in log)
        assert svc.spec.pools.prefill.replicas > 1
        assert (svc.status.pool_desired_replicas["prefill"]
                == svc.spec.pools.prefill.replicas)
        ready = [r for r in fleet.replicas.values()
                 if r.pool == "prefill" and r.routable]
        assert len(ready) == svc.spec.pools.prefill.replicas
        assert svc.spec.pools.decode.replicas == 1
        assert all("action=hold" in ln for ln in log if "pool=decode" in ln)
        return log, results(res), disagg_view(plane, fleet)
    both(setup, scenario)


def test_per_pool_autoscaler_decision_logs_byte_identical(setup):
    def scenario(plane):
        log1 = _run_pool_autoscale(plane, seed=14)[0]
        log2 = _run_pool_autoscale(plane, seed=14)[0]
        assert log1 and log1 == log2
        return log1
    both(setup, scenario)


def test_pool_observation_line_parses(setup):
    """The port's lines parse with the reference's ``sample_from_line``."""
    def scenario(plane):
        rng = np.random.default_rng(15)
        fleet = _disagg(plane, decode=1, clock=TickingClock())
        for p in _prompts(rng, _prompt(rng, 8), 3):
            fleet.submit(p, max_new_tokens=4)
        fleet.run()
        lines = []
        for pool in ("prefill", "decode"):
            line = fleet.pool_observation_line(pool)
            s = sample_from_line(line, seq=1)
            assert s is not None, line
            lines.append(line)
        assert s.tpot
        return lines
    both(setup, scenario)


# ------------------------------------------------- acceptance: disagg vs mono
_STEP_BASE = 1.0
_PREFILL_COST = 0.05


def _drive_cost_model(fleet, engines, decode_names):
    """Step the fleet to completion under the reference's device-time cost
    model; returns the decode-phase TPOT samples."""
    last = {n: (e.stats["emitted"], e.stats["admitted"],
                e.stats["prefill_positions"]) for n, e in engines.items()}
    tpot = []
    for _ in range(400):
        fleet.step()
        for n, e in engines.items():
            em0, ad0, pp0 = last[n]
            em, ad, pp = (e.stats["emitted"], e.stats["admitted"],
                          e.stats["prefill_positions"])
            last[n] = (em, ad, pp)
            if n not in decode_names:
                continue
            cost = _STEP_BASE + _PREFILL_COST * (pp - pp0)
            tpot.extend([cost] * max((em - em0) - (ad - ad0), 0))
        if not fleet.has_live_requests:
            break
    assert not fleet.has_live_requests
    return tpot


def _p95(vals):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(0.95 * len(vals)))]


def test_acceptance_disagg_beats_monolithic_control(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(16)
        burst = _prompts(rng, _prompt(rng, 8), 10)
        mono = S.ServingFleet(
            _factory(plane), 2, probe=S.ProbeConfig(slow_start_steps=1),
            router=S.Router(prefix_bucket_len=8, spill_tokens=8),
            clock=FakeClock())
        for _ in range(2):
            mono.step()
        mono_rids = [mono.submit(p, max_new_tokens=6) for p in burst]
        mono_engines = {n: r.engine for n, r in mono.replicas.items()}
        mono_tpot = _drive_cost_model(mono, mono_engines, set(mono_engines))
        mono_recompute = sum(e.stats["prefix_prefills"]
                             for e in mono_engines.values())
        dis = _disagg(plane, prefill=1, decode=1)
        dis_rids = [dis.submit(p, max_new_tokens=6) for p in burst]
        dis_engines = {n: r.engine for n, r in dis.replicas.items()}
        decode_names = {n for n, r in dis.replicas.items()
                        if r.pool == "decode"}
        dis_tpot = _drive_cost_model(dis, dis_engines, decode_names)
        assert _p95(dis_tpot) < _p95(mono_tpot)
        assert dis.store.stats["misses"] < mono_recompute
        mono_out = {r: result(mono.result(r)) for r in mono_rids}
        dis_out = {r: result(dis.result(r)) for r in dis_rids}
        assert all(v[0] == "done" for v in (*mono_out.values(),
                                            *dis_out.values()))
        return (mono_tpot, dis_tpot, mono_recompute, mono_out, dis_out,
                disagg_view(plane, dis))
    both(setup, scenario)


# ------------------------------------------------------------------- metrics
def test_fleet_metrics_exposition_pool_labels(setup):
    def scenario(plane):
        rng = np.random.default_rng(17)
        prefix = _prompt(rng, 8)
        metrics = plane.metrics.FleetMetrics()
        fleet = _disagg(plane, decode=1, metrics=metrics)
        for p in _prompts(rng, prefix, 4):
            fleet.submit(p, max_new_tokens=4)
        fleet.run()
        body = text(plane, metrics)
        for want in (
                'tpu_on_k8s_fleet_pool_queue_depth{pool="prefill"}',
                'tpu_on_k8s_fleet_pool_queue_depth{pool="decode"}',
                'tpu_on_k8s_fleet_pool_replicas_ready{pool="decode"} 1.0',
                'tpu_on_k8s_fleet_pool_slots{pool="decode"} 2.0',
                "tpu_on_k8s_fleet_handoff_queue_depth",
                "tpu_on_k8s_fleet_handoff_wait_seconds_count 4.0",
                "tpu_on_k8s_fleet_handoffs_enqueued_total 4.0",
                "tpu_on_k8s_fleet_handoffs_adopted_total 4.0",
                "tpu_on_k8s_fleet_prefix_store_misses_total 1.0",
                "tpu_on_k8s_fleet_prefix_store_overflow_bytes"):
            assert want in body, f"missing {want!r}"
        assert metrics.counters[("handoffs_adopted", "")] == 4
        assert metrics.gauges[("pool_replicas_ready", "decode")] == 1
        return body
    both(setup, scenario)


# ------------------------------------------------ direct cross-checks
def test_prefix_hash_matches_on_seeded_tokens():
    rng = np.random.default_rng(19)
    for n in (1, 2, 7, 64, 1000):
        toks = rng.integers(0, 32000, size=n)
        for arr in (toks, toks.astype(np.int32), toks.tolist()):
            assert p_prefix_hash(arr) == j_prefix_hash(arr)
