"""The port's serving gateway (``tpu_on_k8s_torch/serve/``) against the JAX
package's, on the CPU.

Each case is one of the reference's own gateway tests
(``tests/test_serve_gateway.py``) written as a scenario over a ``Plane``:
one package's serve modules, chaos, metrics and engine. The scenario runs
once through the JAX plane over the JAX engine and once through the port's
plane over the port's engine, on a ``TransformerConfig.tiny()`` model (fp32,
``max_seq_len`` 64) initialised by the JAX package and carried across with
``from_jax_params``, numpy-seeded prompts, greedy decoding and an injected
fake clock. The reference's assertions hold on both runs, and the two
observations must be equal exactly: each request's tokens and final state,
the rejection reasons and details, the engines' counters and the metrics'
exposition text (``render_text``, byte for byte). Tolerances: none, tokens
and text are exact. The reference's ``generate`` oracle is not re-run here:
the JAX plane's output, which its own tests hold to that oracle, is the
reference.

The pure modules get direct cross-checks on seeded inputs:
``AdmissionController``'s decisions and ``FairScheduler``'s pop order.

Left out, and why: ``test_serve_load_smoke`` drives ``tools/serve_load.py``,
whose port waits for the load driver's slice (ROADMAP Queue 1).

JAX engines compile their programs when built, so each is built once per
module and configuration and restored to its just-built state between
scenarios (``JaxEngines``).
"""
import copy
import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_on_k8s.chaos as jchaos
import tpu_on_k8s.chaos.scenarios as jscenarios
import tpu_on_k8s.metrics.metrics as jmetrics
import tpu_on_k8s.models.serving as jserving
import tpu_on_k8s.serve as jserve
import tpu_on_k8s.serve.admission as jadmission
import tpu_on_k8s.serve.lifecycle as jlifecycle
import tpu_on_k8s.serve.scheduler as jscheduler
import tpu_on_k8s_torch.chaos as pchaos
import tpu_on_k8s_torch.metrics as pmetrics
import tpu_on_k8s_torch.models.serving as pserving
import tpu_on_k8s_torch.serve as pserve
import tpu_on_k8s_torch.serve.admission as padmission
import tpu_on_k8s_torch.serve.lifecycle as plifecycle
import tpu_on_k8s_torch.serve.scheduler as pscheduler
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.transformer import TransformerConfig

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
_LOCK = type(threading.Lock())
#: engine counters both packages keep (the port's engine adds others)
ENGINE_KEYS = ("steps", "emitted", "admitted", "crashes",
               "prefill_positions", "prefix_prefills", "kv_adopted",
               "param_swaps")


def port_config(jcfg: JConfig) -> TransformerConfig:
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return TransformerConfig(**fields)


class JaxEngines:
    """JAX engines built once per configuration. A built engine's attributes
    are snapshotted; a returned engine gets them back: compiled programs,
    configs, modules and parameters are shared, everything else (slots,
    queues, caches, page pool, counters, hooks) is a deep copy of the
    snapshot, and the lock is new."""

    _SHARED = (types.FunctionType, types.BuiltinFunctionType, JConfig,
               JTransformer)

    def __init__(self, cfg, trees):
        self.cfg, self.trees = cfg, trees
        self._free = {}
        self._leased = []

    def _shared(self, name, value):
        return (name in ("_params", "sampling") or callable(value)
                or isinstance(value, self._SHARED)
                or type(value).__name__ == "_LruPrograms")

    @staticmethod
    def _copy(value):
        """A deep copy with a new lock wherever ``value`` or one of its
        attributes is a lock (the page pool holds one)."""
        memo = {id(v): threading.Lock()
                for v in (value, *getattr(value, "__dict__", {}).values())
                if isinstance(v, _LOCK)}
        return copy.deepcopy(value, memo)

    def get(self, version="v1", **kw):
        key = (version, *sorted(kw.items()))
        free = self._free.setdefault(key, [])
        if free:
            eng, snap = free.pop()
            eng.__dict__.clear()
            for name, value in snap.items():
                eng.__dict__[name] = (value if self._shared(name, value)
                                      else self._copy(value))
        else:
            eng = jserving.ContinuousBatchingEngine(
                self.cfg, self.trees[version], **kw)
            snap = {name: (value if self._shared(name, value)
                           else self._copy(value))
                    for name, value in vars(eng).items()}
        self._leased.append((key, eng, snap))
        return eng

    def release(self):
        for key, eng, snap in self._leased:
            self._free[key].append((eng, snap))
        self._leased.clear()


@dataclasses.dataclass
class Plane:
    """One package's serving plane: its modules and an engine factory."""

    name: str
    serve: object
    admission: object
    lifecycle: object
    scheduler: object
    chaos: object
    scenarios: object
    metrics: object
    serving: object
    make_engine: object
    trees: dict                      # version -> this package's params
    release: object = lambda: None

    def engine(self, version="v1", **kw):
        return self.make_engine(version, **kw)


@dataclasses.dataclass
class Setup:
    cfg: JConfig
    jax: Plane
    port: Plane


def make_setup(seeds) -> Setup:
    """The tiny fp32 model, one parameter tree per ``{version: init
    seed}``, and both planes over it. The other serving-plane test files
    build theirs here too."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               max_seq_len=64)
    tok = jax.random.randint(jax.random.key(0), (1, 8), 0, jcfg.vocab_size,
                             jnp.int32)
    model = JTransformer(jcfg)
    jtrees = {v: model.init(jax.random.key(k), tok)["params"]
              for v, k in seeds.items()}
    ptrees = {v: pparams.from_jax_params(jax.tree.map(np.asarray, t),
                                         device="cpu")
              for v, t in jtrees.items()}
    pcfg = port_config(jcfg)
    pool = JaxEngines(jcfg, jtrees)
    jplane = Plane("jax", jserve, jadmission, jlifecycle, jscheduler, jchaos,
                   jscenarios, jmetrics, jserving, pool.get, jtrees,
                   pool.release)
    pplane = Plane("port", pserve, padmission, plifecycle, pscheduler,
                   pchaos, pchaos, pmetrics, pserving,
                   lambda version, **kw: pserving.ContinuousBatchingEngine(
                       pcfg, ptrees[version], device="cpu", **kw), ptrees)
    return Setup(jcfg, jplane, pplane)


@pytest.fixture(scope="module")
def setup():
    return make_setup({"v1": 1})


def both(setup, scenario):
    """Run ``scenario(plane)`` on the JAX plane and on the port's; their
    observations must be equal. Returns the port's."""
    try:
        want = scenario(setup.jax)
    finally:
        setup.jax.release()
    got = scenario(setup.port)
    assert got == want
    return got


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class TickingClock(FakeClock):
    def __call__(self) -> float:
        self.t += 0.5
        return self.t


def result(res):
    """A ``RequestResult`` as plain values."""
    return (res.state.value, res.tokens.tolist())


def outcome(r):
    """What ``submit`` returned: an id, or a rejection's reason and
    detail."""
    return ("rejected", r.reason, r.detail) if hasattr(r, "reason") else r


def engine_counts(eng):
    return {k: eng.stats[k] for k in ENGINE_KEYS}


def text(plane, m):
    return plane.metrics.render_text(m)


def _gw(plane, n_slots=2, clock=None, admission=None, weights=None,
        metrics=None, **engine_kw):
    eng = plane.engine(n_slots=n_slots, **engine_kw)
    kw = {}
    if clock is not None:
        kw["clock"] = clock
    return eng, plane.serve.ServingGateway(eng, admission,
                                           tenant_weights=weights,
                                           metrics=metrics, **kw)


def _prompt(rng, n):
    return rng.integers(0, 256, size=int(n)).astype(np.int32)


def test_burst_rejection_deadlines_and_exactness(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(41)
        clock = FakeClock()
        n_slots, bound = 2, 6
        m = plane.metrics.ServingMetrics()
        eng, gw = _gw(plane, n_slots=n_slots, clock=clock, metrics=m,
                      admission=S.AdmissionConfig(max_queue_depth=bound))
        prompts = [_prompt(rng, n)
                   for n in rng.integers(3, 14, size=4 * n_slots)]
        rids, rejected = [], []
        for i, p in enumerate(prompts):
            r = gw.submit(p, 6, deadline_s=5.0 if i in (2, 3) else None)
            (rejected if isinstance(r, S.Rejected) else rids).append(r)
        assert len(rejected) == len(prompts) - bound
        assert all(r.reason == plane.admission.REASON_QUEUE_FULL
                   for r in rejected)
        gw.step()
        assert eng.stats["admitted"] == n_slots
        clock.advance(10.0)
        out = gw.run()
        assert gw.state(rids[2]) is None
        for i in (2, 3):
            assert out[rids[i]].state is S.RequestState.DEADLINE_EXCEEDED
            assert out[rids[i]].tokens.size == 0
        assert eng.stats["admitted"] == 4
        assert all(out[rids[i]].ok for i in (0, 1, 4, 5))
        return ([outcome(r) for r in rejected],
                {r: result(out[r]) for r in rids}, engine_counts(eng),
                text(plane, m))
    both(setup, scenario)


def test_deadline_mid_decode_aborts_and_frees_slot(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(42)
        clock = FakeClock()
        eng, gw = _gw(plane, n_slots=1, clock=clock)
        p_dead, p_wait = _prompt(rng, 6), _prompt(rng, 4)
        r_dead = gw.submit(p_dead, 30, deadline_s=5.0)
        r_wait = gw.submit(p_wait, 5)
        for _ in range(3):
            gw.step()
        assert gw.state(r_dead) is S.RequestState.DECODING
        clock.advance(10.0)
        gw.step()
        assert gw.state(r_dead) is S.RequestState.DEADLINE_EXCEEDED
        assert gw.state(r_wait) is S.RequestState.DECODING
        assert eng.stats["admitted"] == 2
        res = gw.result(r_dead)
        assert 0 < res.tokens.size < 30
        out = gw.run()
        return result(res), result(out[r_wait]), engine_counts(eng)
    both(setup, scenario)


def test_cancel_mid_decode_frees_slot_same_step(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(43)
        eng, gw = _gw(plane, n_slots=1, clock=FakeClock())
        r_a = gw.submit(_prompt(rng, 5), 25)
        r_b = gw.submit(_prompt(rng, 7), 6)
        gw.step()
        assert gw.state(r_a) is S.RequestState.DECODING
        assert gw.state(r_b) is S.RequestState.QUEUED
        assert gw.cancel(r_a)
        gw.step()
        assert gw.state(r_a) is S.RequestState.CANCELLED
        assert gw.state(r_b) is S.RequestState.DECODING
        assert not gw.cancel(r_a)
        res_a = gw.result(r_a)
        assert res_a.state is S.RequestState.CANCELLED
        assert res_a.tokens.size > 0
        out = gw.run()
        return result(res_a), result(out[r_b]), engine_counts(eng)
    both(setup, scenario)


def test_cancel_queued_is_immediate(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(44)
        eng, gw = _gw(plane, n_slots=1, clock=FakeClock())
        r_a = gw.submit(_prompt(rng, 4), 10)
        r_b = gw.submit(_prompt(rng, 4), 4)
        assert gw.cancel(r_b)
        assert gw.state(r_b) is S.RequestState.CANCELLED
        assert not gw.cancel(999)
        out = gw.run()
        assert out[r_a].ok
        assert eng.stats["admitted"] == 1
        return {r: result(v) for r, v in out.items()}, engine_counts(eng)
    both(setup, scenario)


def test_drain_finishes_inflight_rejects_new(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(45)
        eng, gw = _gw(plane, n_slots=2, clock=FakeClock())
        prompts = [_prompt(rng, n) for n in (5, 9, 3)]
        rids = [gw.submit(p, 6) for p in prompts]
        gw.step()
        gw.stop_accepting()
        rej = gw.submit(prompts[0], 4)
        assert isinstance(rej, S.Rejected)
        assert rej.reason == plane.admission.REASON_DRAINING
        out = gw.drain()
        assert all(out[r].ok for r in rids)
        return outcome(rej), {r: result(out[r]) for r in rids}
    both(setup, scenario)


def test_drain_timeout_cancels_stragglers(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(46)
        eng, gw = _gw(plane, n_slots=1, clock=TickingClock())
        r = gw.submit(_prompt(rng, 5), 50)
        gw.step()
        out = gw.drain(timeout_s=2.0)
        assert out[r].state is S.RequestState.CANCELLED
        assert out[r].tokens.size < 50
        return result(out[r]), engine_counts(eng)
    both(setup, scenario)


def test_drain_timeout_with_engine_stalled_mid_step(setup):
    def scenario(plane):
        S, chaos = plane.serve, plane.chaos
        rng = np.random.default_rng(54)
        eng, gw = _gw(plane, n_slots=1, clock=TickingClock())
        decoding = gw.submit(_prompt(rng, 5), 50)
        queued = gw.submit(_prompt(rng, 4), 10)
        gw.step()
        assert gw.state(decoding) is S.RequestState.DECODING
        stall = chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_SERVE_STEP, chaos.Trigger(every=1),
            chaos.EngineStall())])
        try:
            with stall:
                out = gw.drain(timeout_s=2.0)
        finally:
            chaos.uninstall()
        assert out[decoding].state is S.RequestState.CANCELLED
        assert 0 < out[decoding].tokens.size < 50
        assert out[queued].state is S.RequestState.CANCELLED
        assert out[queued].tokens.size == 0
        assert eng.free_slots == eng.n_slots
        return (result(out[decoding]), result(out[queued]), stall.events,
                engine_counts(eng))
    both(setup, scenario)


def test_wrr_fairness_proportions(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(47)
        eng, gw = _gw(plane, n_slots=1, clock=FakeClock(),
                      weights={"a": 2.0, "b": 1.0, "c": 1.0},
                      admission=S.AdmissionConfig(max_queue_depth=64))
        by_rid = {}
        for _ in range(8):
            for t in ("a", "b", "c"):
                by_rid[gw.submit(_prompt(rng, 4), 1, tenant=t)] = t
        order = []
        while len(order) < 12:
            order.extend(by_rid[r] for r in gw.step())
        counts = {t: order[:12].count(t) for t in "abc"}
        assert counts == {"a": 6, "b": 3, "c": 3}
        assert "aaa" not in "".join(order[:12])
        out = gw.run()
        return order, {r: result(v) for r, v in out.items()}
    both(setup, scenario)


def test_priority_lanes_preempt_order(setup):
    def scenario(plane):
        rng = np.random.default_rng(48)
        eng, gw = _gw(plane, n_slots=1, clock=FakeClock())
        gw.submit(_prompt(rng, 4), 8)
        gw.step()
        low = gw.submit(_prompt(rng, 4), 2, priority=0)
        high = gw.submit(_prompt(rng, 4), 2, priority=5)
        done = []
        while len(done) < 3:
            done.extend(gw.step())
        assert done.index(high) < done.index(low)
        gw.run()
        return done
    both(setup, scenario)


def test_load_shedding_spares_priority_lane(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(49)
        eng, gw = _gw(plane, n_slots=1, clock=FakeClock(),
                      admission=S.AdmissionConfig(
                          max_queue_depth=8, shed_threshold=2,
                          shed_keep_priority=1))
        p = _prompt(rng, 4)
        got = [gw.submit(p, 2), gw.submit(p, 2)]
        shed = gw.submit(p, 2)
        assert isinstance(shed, S.Rejected)
        assert shed.reason == plane.admission.REASON_LOAD_SHED
        kept = gw.submit(p, 2, priority=1)
        assert isinstance(kept, int)
        out = gw.run()
        return ([outcome(r) for r in (*got, shed, kept)],
                {r: result(v) for r, v in out.items()})
    both(setup, scenario)


def test_tenant_token_budget_reserve_release(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(50)
        eng, gw = _gw(plane, n_slots=2, clock=FakeClock(),
                      admission=S.AdmissionConfig(max_queue_depth=16,
                                                  default_tenant_budget=20))
        p = _prompt(rng, 6)
        a = gw.submit(p, 6, tenant="t")
        over = gw.submit(p, 6, tenant="t")
        assert isinstance(over, S.Rejected)
        assert over.reason == plane.admission.REASON_QUOTA
        other = gw.submit(p, 6, tenant="u")
        assert isinstance(other, int)
        out = gw.run()
        assert out[a].ok and out[other].ok
        again = gw.submit(p, 6, tenant="t")
        assert isinstance(again, int)
        out2 = gw.run()
        return (outcome(over), result(out[a]), result(out[other]),
                result(out2[again]))
    both(setup, scenario)


def test_oracle_exact_mixed_traffic_with_prefix(setup):
    def scenario(plane):
        rng = np.random.default_rng(51)
        eng, gw = _gw(plane, n_slots=2, clock=FakeClock())
        pid = eng.register_prefix(_prompt(rng, 9))
        prompts = [_prompt(rng, n) for n in (5, 11, 3, 7)]
        news = [8, 5, 10, 4]
        r0 = gw.submit(prompts[0], news[0])
        gw.step()
        r1 = gw.submit(prompts[1], news[1], prefix_id=pid)
        r2 = gw.submit(prompts[2], news[2])
        gw.step()
        r3 = gw.submit(prompts[3], news[3], tenant="other")
        out = gw.run()
        assert all(out[r].ok for r in (r0, r1, r2, r3))
        return {r: result(out[r]) for r in (r0, r1, r2, r3)}, \
            engine_counts(eng)
    both(setup, scenario)


def test_streaming_and_metrics_through_gateway(setup):
    def scenario(plane):
        S = plane.serve
        rng = np.random.default_rng(52)
        m = plane.metrics.ServingMetrics()
        clock = FakeClock()
        eng, gw = _gw(plane, n_slots=1, metrics=m, clock=clock,
                      admission=S.AdmissionConfig(max_queue_depth=1))
        streamed = []
        p = _prompt(rng, 5)
        rid = gw.submit(p, 6, on_token=lambda r, t: streamed.append((r, t)))
        rej = gw.submit(p, 4)
        assert isinstance(rej, S.Rejected)
        out = gw.run()
        assert [t for _, t in streamed] == out[rid].tokens.tolist()
        assert all(r == rid for r, _ in streamed)
        c = gw.submit(p, 20)
        clock.advance(0.25)
        gw.step()
        gw.cancel(c)
        gw.run()
        assert m.counters["requests_submitted"] == 2
        assert m.counters["requests_finished"] == 1
        assert m.counters["requests_rejected"] == 1
        assert m.counters["rejected_queue_full"] == 1
        assert m.counters["requests_cancelled"] == 1
        assert m.counters["tokens_emitted"] >= 7
        assert len(m.histograms["time_to_first_token_seconds"]) == 2
        assert len(m.histograms["queue_wait_seconds"]) == 2
        assert len(m.histograms["time_per_output_token_seconds"]) == 1
        assert len(m.histograms["request_latency_seconds"]) == 1
        assert m.gauges["queue_depth"] == 0
        return streamed, outcome(rej), result(out[rid]), text(plane, m)
    both(setup, scenario)


def test_validation_and_rejected_guardrails(setup):
    def scenario(plane):
        S = plane.serve
        eng, gw = _gw(plane, n_slots=1)
        errors = []
        for args, kw, match in (
                ((np.zeros(0, np.int32), 4), {}, "empty"),
                ((np.arange(4), 0), {}, "max_new_tokens"),
                ((np.arange(60), 10), {}, "exceeds"),
                ((np.arange(4), 2), {"prefix_id": 7}, "unknown prefix_id")):
            with pytest.raises(ValueError, match=match) as ei:
                gw.submit(*args, **kw)
            errors.append(str(ei.value))
        past = gw.submit(np.arange(4), 2, deadline_s=-1.0)
        assert isinstance(past, S.Rejected)
        assert past.reason == plane.admission.REASON_DEADLINE
        with pytest.raises(TypeError, match="no truth value"):
            bool(past)
        with pytest.raises(ValueError, match="one gateway per engine"):
            S.ServingGateway(eng)
        with pytest.raises(ValueError, match="weight"):
            S.ServingGateway(plane.engine(n_slots=1),
                             tenant_weights={"a": 0.0})
        return errors, outcome(past)
    both(setup, scenario)


def test_admission_controller_unit(setup):
    def scenario(plane):
        A = plane.admission
        ctl = A.AdmissionController(A.AdmissionConfig(
            max_queue_depth=4, shed_threshold=2, shed_keep_priority=1,
            default_tenant_budget=100, tenant_budgets={"vip": 1000}))
        assert ctl.admit("t", 60, 0, queue_depth=0) is None
        assert ctl.reserved("t") == 60
        quota = ctl.admit("t", 60, 0, queue_depth=0)
        assert quota.reason == A.REASON_QUOTA
        assert ctl.admit("vip", 600, 0, queue_depth=0) is None
        shed = ctl.admit("t", 1, 0, queue_depth=2)
        assert shed.reason == A.REASON_LOAD_SHED
        assert ctl.admit("t", 1, 1, queue_depth=2) is None
        full = ctl.admit("t", 1, 9, queue_depth=4)
        assert full.reason == A.REASON_QUEUE_FULL
        ctl.release("t", 60)
        assert ctl.admit("t", 60, 0, queue_depth=0) is None
        with pytest.raises(ValueError, match="never fire") as ei:
            A.AdmissionConfig(max_queue_depth=2, shed_threshold=3)
        return [outcome(r) for r in (quota, shed, full)], str(ei.value)
    both(setup, scenario)


def test_engine_typed_rejection_when_bypassing_gateway(setup):
    def scenario(plane):
        rng = np.random.default_rng(53)
        eng = plane.engine(n_slots=1, queue_cap=2)
        p = _prompt(rng, 4)
        eng.submit(p, 3)
        eng.submit(p, 3)
        with pytest.raises(plane.serving.EngineOverloadedError) as ei:
            eng.submit(p, 3)
        assert ei.value.inflight == 2 and ei.value.cap == 2
        first = {r: t.tolist() for r, t in eng.run().items()}
        rid = eng.submit(p, 3)
        assert isinstance(rid, int)
        second = {r: t.tolist() for r, t in eng.run().items()}
        return first, second, str(ei.value)
    both(setup, scenario)
    with pytest.raises(ValueError, match="queue_cap"):
        setup.port.engine(queue_cap=0)


# ------------------------------------------------ direct cross-checks
def test_admission_controller_decisions_match_on_seeded_traffic(setup):
    """2000 seeded admit/release calls over four tenants and three lanes:
    every decision (admitted, or the rejection's reason and detail) and
    every tenant's reservation equal the reference's."""
    def scenario(plane):
        A = plane.admission
        ctl = A.AdmissionController(A.AdmissionConfig(
            max_queue_depth=12, shed_threshold=8, shed_keep_priority=2,
            default_tenant_budget=400, tenant_budgets={"t0": 1200}))
        rng = np.random.default_rng(7)
        held = []
        log = []
        for _ in range(2000):
            tenant = f"t{int(rng.integers(0, 4))}"
            if held and rng.random() < 0.4:
                t, cost = held.pop(int(rng.integers(0, len(held))))
                ctl.release(t, cost)
                log.append(("release", t, ctl.reserved(t)))
                continue
            cost = int(rng.integers(1, 120))
            r = ctl.admit(tenant, cost, int(rng.integers(0, 3)),
                          queue_depth=int(rng.integers(0, 14)))
            if r is None:
                held.append((tenant, cost))
            log.append((tenant, cost, None if r is None else outcome(r),
                        ctl.reserved(tenant)))
        return log
    log = both(setup, scenario)
    assert {type(e[2]) for e in log if e[0] != "release"} == {type(None),
                                                              tuple}


def test_fair_scheduler_pop_order_matches(setup):
    """Seeded pushes over five tenants (weights 1-4) and three priority
    lanes, interleaved with pops and removals: the pop order is the
    reference's."""
    weights = {"a": 1.0, "b": 2.0, "c": 3.0, "d": 4.0}

    def scenario(plane):
        sched = plane.scheduler.FairScheduler(weights)
        rng = np.random.default_rng(11)
        reqs = {}
        order = []
        for rid in range(600):
            tenant = "abcde"[int(rng.integers(0, 5))]
            req = plane.lifecycle.GatewayRequest(
                rid=rid, tenant=tenant, priority=int(rng.integers(0, 3)),
                prompt=np.zeros(1, np.int32), max_new_tokens=1,
                eos_id=None, prefix_id=None, cost=1, deadline=None,
                submitted_at=0.0)
            sched.push(req)
            reqs[rid] = req
            draw = rng.random()
            if draw < 0.45:
                got = sched.pop()
                order.append(None if got is None else got.rid)
            elif draw < 0.55:
                victim = reqs[int(rng.integers(0, rid + 1))]
                order.append(("remove", victim.rid, sched.remove(victim)))
        while len(sched):
            order.append(sched.pop().rid)
        return order
    both(setup, scenario)
