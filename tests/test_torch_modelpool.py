"""The port's model pool (``serve/modelpool.py``) against the JAX package's,
on the CPU.

The reference's own tests (``tests/test_modelpool.py``), each run as one
scenario through the JAX plane over a JAX engine and through the port's
plane over the port's engine (the harness of ``test_torch_serve_gateway.py``:
a tiny fp32 model with three parameter trees m-a, m-b, m-c carried across
with ``from_jax_params``, seeded prompts, greedy decoding, injected fake
clocks). The two runs must agree exactly: each request's tokens, the pool's
``stats`` and ``decision_log`` line for line, its resident set, the
decision ledger's records (loop, tick, action, reason, commit, trigger,
parent, signals), the engine's counters, and the ``ModelPoolMetrics``
exposition text (``render_text``). Tolerances: none.

``test_pool_loads_a_checkpoint_through_a_callable_loader`` adds a loader
that reads a checkpoint written by the port's ``CheckpointManager``
through ``train/checkpoint.py::load_params``, on first activation.

``test_per_model_slo_status_lands_on_crd_and_survives_reconcile`` drives
the ``InferenceService`` CRD plane (per-model SLOs fed through the port's
``FleetAutoscaler.observe_model_latency`` into ``status.models[name].slo``,
kept across a reconcile of the same entries): the reference's function and
its helpers run against the port as written, its slice literals mapped by
host count (``test_torch_api.reference_functions``; the reference's module
imports JAX at its top).

``test_broker_grant_under_replica_crash_keeps_both_domains_typed`` runs the
same way: the port's ``CapacityBroker`` with a managed batch lane and a
fleet of two of the port's engines on the CPU (the reference's tiny m-a
tree carried across) under the port's ``broker_grant_under_crash``: the
stale-bid grant rejects the whole lane transition, the crashed replica is
ejected, the next tick re-clears and every request ends typed.
"""
import numpy as np
import pytest
import torch

import tpu_on_k8s.obs.ledger as jledger
import tpu_on_k8s_torch.obs.ledger as pledger
from test_torch_serve_gateway import (
    FakeClock,
    both,
    engine_counts,
    make_setup,
    text,
)
from test_torch_api import reference_functions, slice_literals
from tpu_on_k8s_torch.api.core import ObjectMeta
from tpu_on_k8s_torch.api.inference_types import (
    InferenceService,
    InferenceServiceSpec,
    ModelRef,
    SLOObjective,
    SLOPolicy,
)
from tpu_on_k8s_torch.api.types import GPUPolicy
from tpu_on_k8s_torch.client import InMemoryCluster
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.fleetautoscaler import FleetAutoscaler
from tpu_on_k8s_torch.controller.inferenceservice import (
    setup_inferenceservice_controller,
)
from tpu_on_k8s_torch.controller.runtime import Manager
from tpu_on_k8s_torch.train.checkpoint import CheckpointManager, load_params

torch.set_num_threads(1)

LEDGERS = {"jax": jledger, "port": pledger}
MODELS = ("m-a", "m-b", "m-c")


@pytest.fixture(scope="module")
def setup():
    return make_setup({"m-a": 1, "m-b": 2, "m-c": 3})


def _prompt(rng, n):
    return rng.integers(0, 256, size=int(n)).astype(np.int32)


def _ledger(plane, clock):
    return LEDGERS[plane.name].DecisionLedger(clock)


def decisions(plane, led):
    DecisionRecord = LEDGERS[plane.name].DecisionRecord
    return [(r.loop, r.tick, r.action, r.reason, r.commit, r.trigger,
             r.parent, r.signals)
            for r in led.records if isinstance(r, DecisionRecord)]


def pool_view(plane, pool):
    return {"stats": dict(pool.stats), "log": list(pool.decision_log),
            "resident": pool.resident_models(), "active": pool.active,
            "metrics": (None if pool.metrics is None
                        else text(plane, pool.metrics))}


def tokens(out):
    return {r: t.tolist() for r, t in out.items()}


# ------------------------------------------------------- token identity
def test_pool_swaps_match_each_models_generate(setup):
    def scenario(plane):
        rng = np.random.default_rng(21)
        m = plane.metrics.ModelPoolMetrics()
        eng = plane.engine("m-a", n_slots=2)
        pool = plane.serve.ModelPool(
            eng, {k: plane.trees[k] for k in ("m-a", "m-b")}, active="m-a",
            metrics=m, clock=FakeClock())
        rids = []
        for model in ("m-a", "m-b", "m-a", "m-b"):
            p = _prompt(rng, rng.integers(3, 10))
            rids.append(pool.submit(model, p, int(rng.integers(4, 9))))
        out = pool.run()
        assert set(out) == set(rids)
        assert pool.stats["swaps"] >= 1
        assert eng.stats["param_swaps"] == pool.stats["swaps"]
        assert m.counters[("model_requests", "m-a")] == 2
        assert m.counters[("model_requests", "m-b")] == 2
        assert m.counters[("swaps", "")] == pool.stats["swaps"]
        assert m.gauges[("queued_requests", "")] == 0
        return tokens(out), pool_view(plane, pool), engine_counts(eng)
    got = both(setup, scenario)
    # the two models answer differently: each request met its own model
    assert len({tuple(t) for t in got[0].values()}) == 4


def test_pool_composes_with_int8_weights(setup):
    def scenario(plane):
        eng = plane.engine("m-a", n_slots=2, int8_weights=True)
        pool = plane.serve.ModelPool(
            eng, {k: plane.trees[k] for k in ("m-a", "m-b")}, active="m-a",
            clock=FakeClock())
        p = _prompt(np.random.default_rng(22), 6)
        first, seen = {}, []
        for model in ("m-b", "m-a", "m-b"):
            rid = pool.submit(model, p, 5)
            toks = pool.run()[rid]
            assert toks.shape == (5,)
            assert (toks >= 0).all() and (toks < 256).all()
            if model in first:
                np.testing.assert_array_equal(toks, first[model],
                                              err_msg=f"{model} drifted")
            first.setdefault(model, toks)
            seen.append((model, toks.tolist()))
        return seen, pool_view(plane, pool)
    both(setup, scenario)


# ------------------------------------------------------- surgical flush
def test_eviction_flushes_only_the_departing_models_prefixes(setup):
    def scenario(plane):
        rng = np.random.default_rng(23)
        clock = FakeClock()
        led = _ledger(plane, clock)
        eng = plane.engine("m-a", n_slots=2, kv_pages=24, page_tokens=16)
        pool = plane.serve.ModelPool(
            eng, {m: plane.trees[m] for m in MODELS}, active="m-a",
            max_resident=2, ledger=led, clock=clock, replica="replica-7")
        prefix_a, prefix_b = _prompt(rng, 16), _prompt(rng, 16)
        pid_a = pool.register_prefix("m-a", prefix_a)
        assert pool.ensure_active("m-b")
        pid_b = pool.register_prefix("m-b", prefix_b)
        in_use_before = eng._pool.in_use
        assert pid_a in eng._prefix_pages and pid_b in eng._prefix_pages
        assert pool.ensure_active("m-c")
        assert pool.resident_models() == ["m-b", "m-c"]
        assert pool.stats["evictions"] == 1
        assert pool.stats["prefix_flushes"] == 1
        assert pid_a not in eng._prefix_pages
        assert pid_b in eng._prefix_pages
        in_use_after = eng._pool.in_use
        assert in_use_after < in_use_before
        with pytest.raises(ValueError, match="does not belong") as ei:
            pool.submit("m-a", prefix_a[:4], 4, prefix_id=pid_a)
        rid = pool.submit("m-b", _prompt(rng, 5), 6, prefix_id=pid_b)
        out = pool.run()
        recs = decisions(plane, led)
        evicts = [r for r in recs if r[2] == "model_evict"]
        assert len(evicts) == 1
        assert evicts[0][0] == "modelpool/replica-7"
        assert ("model", "m-a") in evicts[0][7]
        assert "evict m-a from replica-7" in evicts[0][3]
        return (tokens(out), str(ei.value), (in_use_before, in_use_after),
                recs, pool_view(plane, pool), engine_counts(eng))
    both(setup, scenario)


# ------------------------------------------------- router multiplexing
def test_route_model_prefers_resident_and_salts_keys(setup):
    def scenario(plane):
        r = plane.serve.Router(prefix_bucket_len=8)
        for name in ("rep-a", "rep-b", "rep-c"):
            r.add_replica(name, "v1")
        ready = ["rep-a", "rep-b", "rep-c"]
        r.set_resident("rep-a", ["m-1"])
        r.set_resident("rep-b", ["m-2"])
        r.set_resident("rep-c", [])
        p = np.arange(12, dtype=np.int32)
        assert r.route_model("m-1", p, ready, {}) == "rep-a"
        assert r.route_model("m-2", p, ready, {}) == "rep-b"
        fallback = r.route_model("m-9", p, ready, {})
        assert fallback in ready
        r.add_replica("rep-d", "v1")
        assert r.route_model("m-9", p, ready + ["rep-d"], {}) == "rep-d"
        k = r.bucket_key(p)
        assert r.model_key("m-1", k) != r.model_key("m-2", k)
        r.set_resident("rep-a", ["m-3"])
        r.set_resident("rep-b", ["m-1", "m-2"])
        assert r.route_model("m-1", p, ready, {}) == "rep-b"
        return fallback, r.model_key("m-1", k), r.model_key("m-2", k)
    both(setup, scenario)


# --------------------------------------------- deterministic scheduler
class _FakeEngine:
    """Engine stand-in for scheduler-shape tests: finishes everything in
    one step, swaps by pointer, no device work."""

    def __init__(self) -> None:
        self._next = 0
        self._live = {}
        self._done = {}
        self.params = "tree:m-a"

    def submit(self, prompt, max_new_tokens, eos_id=None, prefix_id=None,
               on_token=None):
        rid = self._next
        self._next += 1
        self._live[rid] = np.asarray(prompt)
        return rid

    def step(self):
        done = list(self._live)
        for rid in done:
            self._done[rid] = self._live.pop(rid)
        return done

    def result(self, rid):
        return self._done[rid]

    def replace_params(self, params, *, quantized=False):
        prev, self.params = self.params, params
        return prev

    def drop_prefix(self, pid):
        return True


def _scripted_run(plane, seed):
    clock = FakeClock()
    led = _ledger(plane, clock)
    pool = plane.serve.ModelPool(
        _FakeEngine(), {m: f"tree:{m}" for m in MODELS}, active="m-a",
        max_resident=2, swap_batch=2, ledger=led, clock=clock)
    rng = np.random.default_rng(seed)
    for _ in range(24):
        model = MODELS[int(rng.integers(0, 3))]
        p = rng.integers(0, 50, size=int(rng.integers(1, 6)))
        pool.submit(model, p.astype(np.int32), 4)
    pool.run()
    assert pool.pending() == 0
    return pool, led


def test_swap_scheduler_decision_log_is_deterministic(setup):
    def scenario(plane):
        (p1, l1), (p2, l2) = _scripted_run(plane, 29), _scripted_run(plane, 29)
        assert p1.decision_log == p2.decision_log
        assert len(p1.decision_log) > 4
        assert decisions(plane, l1) == decisions(plane, l2)
        assert p1.stats == p2.stats and p1.stats["swaps"] > 2
        assert all("swap" in ln or "stay" in ln or "evict" in ln
                   for ln in p1.decision_log)
        p3, _ = _scripted_run(plane, 31)
        assert p3.decision_log != p1.decision_log
        return (pool_view(plane, p1), decisions(plane, l1), l1.lines(),
                pool_view(plane, p3))
    both(setup, scenario)


# ----------------------------------------------------------------- chaos
def test_swap_failure_leaves_previous_model_live_then_retries(setup):
    def scenario(plane):
        rng = np.random.default_rng(37)
        m = plane.metrics.ModelPoolMetrics()
        clock = FakeClock()
        led = _ledger(plane, clock)
        eng = plane.engine("m-a", n_slots=2)
        pool = plane.serve.ModelPool(
            eng, {k: plane.trees[k] for k in ("m-a", "m-b")}, active="m-a",
            metrics=m, ledger=led, clock=clock)
        rids = [pool.submit(model, _prompt(rng, 5), 6)
                for model in ("m-b", "m-b", "m-a")]
        inj = plane.scenarios.model_swap_failure(at_swap=1,
                                                 model="m-b").injector()
        with inj:
            out = pool.run()
        assert set(out) == set(rids)
        assert pool.stats["swap_failures"] == 1
        assert pool.stats["swap_retries"] == 1
        assert m.counters[("swap_failures", "")] == 1
        assert m.counters[("swap_retries", "")] == 1
        recs = [r for r in decisions(plane, led) if r[2] == "model_swap"]
        refused = [r for r in recs if r[4] == "conflict:SwapFailure"]
        assert len(refused) == 1
        assert refused[0][5].startswith("chaos#")
        assert "previous params stay live" in refused[0][3]
        assert any("retry after swap_failure" in r[3] for r in recs
                   if r[4] != "conflict:SwapFailure")
        assert any("REFUSED=swap_failure" in ln for ln in pool.decision_log)
        return (tokens(out), inj.events, recs, pool_view(plane, pool),
                engine_counts(eng))
    both(setup, scenario)


# ------------------------------------------------ a checkpoint loader
def test_pool_loads_a_checkpoint_through_a_callable_loader(setup, tmp_path):
    """m-b's loader is a callable that reads a checkpoint of m-b's tree
    through ``load_params``, only when m-b is first activated; its
    requests decode exactly as with the tree handed over directly."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save({"params": setup.port.trees["m-b"]}, step=3)
    mgr.close()
    reads = []

    def load_m_b():
        params, generation, step = load_params(str(tmp_path), "cpu")
        reads.append((generation, step))
        return params

    def run(loader):
        rng = np.random.default_rng(43)
        eng = setup.port.engine("m-a", n_slots=2)
        pool = setup.port.serve.ModelPool(
            eng, {"m-a": setup.port.trees["m-a"], "m-b": loader},
            active="m-a", clock=FakeClock())
        rids = [pool.submit(model, _prompt(rng, 6), 5)
                for model in ("m-a", "m-b", "m-a", "m-b")]
        assert not reads
        out = pool.run()
        return [out[r].tolist() for r in rids], pool_view(setup.port, pool)

    direct = run(setup.port.trees["m-b"])
    from_disk = run(load_m_b)
    assert reads == [(0, 3)]
    assert from_disk == direct



# ------------------------------------------------ per-model SLOs, CRD plane
_SLO_CASE = "test_per_model_slo_status_lands_on_crd_and_survives_reconcile"
test_per_model_slo_status_lands_on_crd_and_survives_reconcile = \
    reference_functions(
        "test_modelpool", ["_model_slo", "_pooled_svc", _SLO_CASE],
        dict(FakeClock=FakeClock, InMemoryCluster=InMemoryCluster,
             Manager=Manager, InferenceService=InferenceService,
             InferenceServiceSpec=InferenceServiceSpec, ModelRef=ModelRef,
             ObjectMeta=ObjectMeta, SLOObjective=SLOObjective,
             SLOPolicy=SLOPolicy, GPUPolicy=GPUPolicy,
             FleetAutoscaler=FleetAutoscaler,
             JobControllerConfig=JobControllerConfig,
             setup_inferenceservice_controller=(
                 setup_inferenceservice_controller)),
        subs=(slice_literals,))[_SLO_CASE]


# ------------------------------------- the broker's grant under a replica crash
from tpu_on_k8s_torch import chaos as pchaos  # noqa: E402
from tpu_on_k8s_torch.coordinator.broker import (  # noqa: E402
    KIND_BATCH,
    PRIORITY_BATCH,
    Bid,
    CapacityBroker,
)
from tpu_on_k8s_torch.metrics import BrokerMetrics  # noqa: E402
from tpu_on_k8s_torch.obs.ledger import (  # noqa: E402
    DecisionLedger,
    DecisionRecord,
)
from tpu_on_k8s_torch.serve import (  # noqa: E402
    ProbeConfig,
    RequestState,
    Router,
    ServingFleet,
)

_BROKER_CASE = "test_broker_grant_under_replica_crash_keeps_both_domains_typed"
test_broker_grant_under_replica_crash_keeps_both_domains_typed = \
    reference_functions(
        "test_modelpool", ["_decisions", _BROKER_CASE],
        dict(pytest=pytest, np=np, FakeClock=FakeClock,
             DecisionLedger=DecisionLedger, DecisionRecord=DecisionRecord,
             CapacityBroker=CapacityBroker, BrokerMetrics=BrokerMetrics,
             Bid=Bid, KIND_BATCH=KIND_BATCH, PRIORITY_BATCH=PRIORITY_BATCH,
             ServingFleet=ServingFleet, ProbeConfig=ProbeConfig,
             Router=Router, RequestState=RequestState, scenarios=pchaos),
        subs=(
            # the port's fixture is both planes: the case reads the tiny
            # config and builds the port's engines of the m-a tree
            (r"(?m)cfg, params = setup$", "cfg = setup.cfg"),
            (r'return ContinuousBatchingEngine\(cfg, params\["m-a"\], '
             r'n_slots=2\)',
             'return setup.port.engine("m-a", n_slots=2)'),
        ))[_BROKER_CASE]
