"""The port's serving fleet (``serve/fleet.py``, ``router.py``, ``health.py``)
against the JAX package's, on the CPU.

The reference's own fleet tests (``tests/test_serve_fleet.py``), each run
as one scenario through the JAX plane over JAX engines and through the
port's plane over the port's engines (the harness of
``test_torch_serve_gateway.py``: a tiny fp32 model with two parameter
versions, v1 and v2, carried across with ``from_jax_params``; seeded
prompts; greedy decoding). Every fleet runs on an injected fake clock,
also where the reference's test left the wall clock in, so that latencies
and their histograms repeat. The two runs must agree exactly: each
request's tokens and final state, the fleet's ``stats``, the retired
replicas, the router's weights and the rollout's phases step by step, the
replicas' states and routed counts, the chaos injectors' event logs, and
the exposition text (``render_text``) of the ``FleetMetrics`` and of each
replica's ``ServingMetrics``. Tolerances: none.

Direct cross-checks: the ``Router`` on 1000 seeded prompts (affinity,
bounded-load spill, canary split, noted prefixes), the ``HealthMonitor``'s
transitions on a seeded probe sequence, and ``observation_line`` parsed by
the reference's own ``parse_observation``.

The reference's ``test_serve_load_fleet_mode_smoke`` (with its ``_factory``,
``_fleet`` and ``_warm``) runs against the port through
``test_torch_api.reference_functions`` and ``TOOLS``: the port's
``serve_load.run_fleet_load`` through a two-replica fleet of the port's
engines on the carried v1 weights.
"""
from collections import Counter

import numpy as np
import pytest
import torch

import tpu_on_k8s.serve.health as jhealth
import tpu_on_k8s.serve.router as jrouter
import tpu_on_k8s_torch.serve.health as phealth
import tpu_on_k8s_torch.serve.router as prouter
from test_torch_serve_gateway import (
    FakeClock,
    both,
    make_setup,
    outcome,
    port_config,
    result,
    text,
)
from tpu_on_k8s.chaos.injector import _substr_on_boundaries as j_boundaries
from tpu_on_k8s.controller.autoscaler import parse_observation
from tpu_on_k8s_torch.chaos import _substr_on_boundaries as p_boundaries
from tpu_on_k8s_torch.models.decode import generate

torch.set_num_threads(1)

ROUTERS = {"jax": jrouter, "port": prouter}
HEALTH = {"jax": jhealth, "port": phealth}


@pytest.fixture(scope="module")
def setup():
    return make_setup({"v1": 1, "v2": 2})


class TickingClock(FakeClock):
    def __call__(self) -> float:
        self.t += 0.25
        return self.t


def _factory(plane, version="v1", n_slots=2):
    def make(name):
        return plane.engine(version, n_slots=n_slots)
    return make


def _fleet(plane, n=2, *, bucket=8, slow_start=1, mode="affinity",
           clock=None, **kw):
    S = plane.serve
    return S.ServingFleet(
        _factory(plane), n,
        probe=S.ProbeConfig(slow_start_steps=slow_start),
        router=S.Router(prefix_bucket_len=bucket, mode=mode),
        clock=clock or FakeClock(), **kw)


def _warm(fleet, steps=3):
    for _ in range(steps):
        fleet.step()


def _prompt(rng, n=6):
    return rng.integers(0, 256, size=n).astype(np.int32)


def fleet_view(plane, fleet):
    """A fleet's bookkeeping as plain values."""
    return {"stats": dict(fleet.stats),
            "retired": [dict(r) for r in fleet.retired],
            "weights": dict(fleet.router.weights),
            "phase": fleet.rollout_phase.value,
            "replicas": {n: (r.version, r.state.value, r.routed)
                         for n, r in fleet.replicas.items()},
            "metrics": (None if fleet.metrics is None
                        else text(plane, fleet.metrics)),
            "replica_metrics": {n: text(plane, r.metrics)
                                for n, r in fleet.replicas.items()
                                if r.metrics is not None}}


def results(out):
    return {r: result(v) for r, v in out.items()}


# --------------------------------------------------------------- router units
def test_router_affinity_consistent_and_bounded(setup):
    def scenario(plane):
        r = plane.serve.Router(prefix_bucket_len=8, spill_tokens=10)
        r.add_replica("a", "v1")
        r.add_replica("b", "v1")
        p = np.arange(12, dtype=np.int32)
        pick = r.route(p, ["a", "b"], {})
        p2 = np.concatenate([p[:8], np.full(20, 7, np.int32)])
        assert r.route(p2, ["a", "b"], {}) == pick
        other = "b" if pick == "a" else "a"
        assert r.route(p, ["a", "b"], {pick: 100, other: 0}) == other
        assert r.route(p, ["a", "b"], {pick: 5, other: 0}) == pick
        assert r.route(p, ["a", "b"], {}, exclude=["a", "b"]) is None
        assert r.route(p, [pick], {}) == pick
        return pick
    both(setup, scenario)


def test_router_ring_remap_is_bounded(setup):
    def scenario(plane):
        r = plane.serve.Router(prefix_bucket_len=4)
        for i in range(4):
            r.add_replica(f"r{i}", "v1")
        rng = np.random.default_rng(3)
        keys = [_prompt(rng, 4) for _ in range(200)]
        ready = [f"r{i}" for i in range(4)]
        before = [r.route(k, ready, {}) for k in keys]
        r.remove_replica("r3")
        after = [r.route(k, ready[:3], {}) for k in keys]
        moved = sum(b != a for b, a in zip(before, after))
        assert moved == sum(b == "r3" for b in before)
        return before, after
    both(setup, scenario)


def test_router_weighted_canary_split_exact(setup):
    def scenario(plane):
        r = plane.serve.Router(prefix_bucket_len=4)
        r.add_replica("old-0", "v1")
        r.add_replica("new-0", "v2")
        r.set_weights({"v1": 0.75, "v2": 0.25})
        rng = np.random.default_rng(4)
        picks = [r.version_of(r.route(_prompt(rng), ["old-0", "new-0"], {}))
                 for _ in range(40)]
        assert Counter(picks) == {"v1": 30, "v2": 10}
        assert "v2v2" not in "".join(picks)
        return picks
    both(setup, scenario)


def test_router_validation(setup):
    def scenario(plane):
        Router = plane.serve.Router
        msgs = []
        for kw, match in (({"prefix_bucket_len": 0}, "prefix_bucket_len"),
                          ({"mode": "roundrobin"}, "mode")):
            with pytest.raises(ValueError, match=match) as ei:
                Router(**kw)
            msgs.append(str(ei.value))
        r = Router()
        r.add_replica("a", "v1")
        with pytest.raises(ValueError, match="already registered") as ei:
            r.add_replica("a", "v1")
        return msgs + [str(ei.value)]
    both(setup, scenario)


def test_chaos_replica_match_is_boundary_anchored(setup):
    for boundaries in (j_boundaries, p_boundaries):
        assert boundaries("replica-1", "replica-1")
        assert not boundaries("replica-1", "replica-10")
        assert boundaries("/pods", "/api/v1/namespaces/d/pods")
        assert boundaries("pods", "/pods?watch=true")

    def scenario(plane):
        chaos = plane.chaos
        inj = chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_FLEET_REPLICA,
            chaos.Trigger(at=(1,), match={"replica": "replica-1"}),
            chaos.ReplicaCrash())])
        assert inj.fire(chaos.SITE_FLEET_REPLICA,
                        replica="replica-10") is None
        fault = inj.fire(chaos.SITE_FLEET_REPLICA, replica="replica-1")
        assert fault is not None
        return fault.kind, inj.events, inj.counts()
    both(setup, scenario)


def test_health_monitor_slow_start_flap_and_stall(setup):
    def scenario(plane):
        H = HEALTH[plane.name]
        h = H.HealthMonitor(H.ProbeConfig(slow_start_steps=2, stall_steps=3))
        seen = [h.ready]
        h.observe_step(progressed=False, busy=False)
        seen.append(h.ready)
        h.observe_step(progressed=True, busy=True)
        assert h.ready
        h.flap(3)
        assert not h.ready
        h.observe_step(progressed=True, busy=True)
        h.observe_step(progressed=True, busy=True)
        assert not h.ready
        h.observe_step(progressed=True, busy=True)
        assert h.ready
        for _ in range(3):
            h.observe_step(progressed=False, busy=True)
        assert h.wedged
        return seen, (h.healthy_streak, h.stall_streak, h.flap_steps_left,
                      h.flaps)
    both(setup, scenario)


# ------------------------------------------------------------- fleet basics
def test_fleet_slow_start_gates_traffic(setup):
    def scenario(plane):
        fleet = _fleet(plane, 2, slow_start=2)
        rej = fleet.submit(np.arange(4, dtype=np.int32), 2)
        assert isinstance(rej, plane.serve.Rejected)
        assert rej.reason == plane.admission.REASON_UNAVAILABLE
        _warm(fleet, 2)
        rid = fleet.submit(np.arange(4, dtype=np.int32), 2)
        assert isinstance(rid, int)
        return outcome(rej), results(fleet.run()), fleet_view(plane, fleet)
    both(setup, scenario)


def test_fleet_serves_exactly_and_balances(setup):
    def scenario(plane):
        fleet = _fleet(plane, 2, bucket=8)
        _warm(fleet)
        rng = np.random.default_rng(11)
        for _ in range(10):
            rid = fleet.submit(_prompt(rng, int(rng.integers(3, 14))), 5)
            assert isinstance(rid, int)
        out = fleet.run()
        assert all(v.ok for v in out.values())
        routed = {r.name: r.routed for r in fleet.replicas.values()}
        assert all(n > 0 for n in routed.values()), routed
        return results(out), fleet_view(plane, fleet)
    both(setup, scenario)


def test_fleet_streaming_uses_fleet_ids(setup):
    def scenario(plane):
        fleet = _fleet(plane, 2)
        _warm(fleet)
        seen = []
        rid = fleet.submit(np.arange(5, dtype=np.int32), 4,
                           on_token=lambda r, t: seen.append((r, t)))
        out = fleet.run()
        assert [t for _, t in seen] == out[rid].tokens.tolist()
        assert all(r == rid for r, _ in seen)
        return seen, results(out)
    both(setup, scenario)


def test_readiness_flap_pulls_replica_from_rotation(setup):
    def scenario(plane):
        chaos, S = plane.chaos, plane.serve
        fleet = _fleet(plane, 2, slow_start=1)
        _warm(fleet)
        flap = chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_FLEET_REPLICA,
            chaos.Trigger(at=(1,), match={"replica": "replica-0"}),
            chaos.ReadinessFlap(steps=4))])
        try:
            with flap:
                fleet.step()
        finally:
            chaos.uninstall()
        assert fleet.replicas["replica-0"].state is S.ReplicaState.STARTING
        routed0 = fleet.replicas["replica-0"].routed
        rng = np.random.default_rng(12)
        for _ in range(6):
            assert isinstance(fleet.submit(_prompt(rng), 2), int)
        assert fleet.replicas["replica-0"].routed == routed0
        out = fleet.run()
        for _ in range(6):
            fleet.step()
        assert fleet.replicas["replica-0"].state is S.ReplicaState.READY
        assert fleet.stats["readiness_flaps"] == 1
        return flap.events, results(out), fleet_view(plane, fleet)
    both(setup, scenario)


# --------------------------------------------------------------- chaos: crash
def test_replica_crash_mid_decode_zero_silent_loss(setup):
    def scenario(plane):
        S = plane.serve
        fleet = _fleet(plane, 2, metrics=plane.metrics.FleetMetrics())
        _warm(fleet)
        rng = np.random.default_rng(13)
        rids = [fleet.submit(_prompt(rng), 8) for _ in range(8)]
        assert all(isinstance(r, int) for r in rids)
        fleet.step()
        inj = plane.scenarios.replica_crash_mid_decode(
            "replica-1", at_steps=(1,)).injector()
        try:
            with inj:
                fleet.step()
        finally:
            plane.chaos.uninstall()
        assert inj.events == ["seq=1 replica_crash note=crash replica-1 "
                              "mid-decode"]
        out = fleet.run()
        assert set(out) == set(rids)
        assert all(out[r].state is S.RequestState.DONE for r in rids)
        assert fleet.stats["ejected"] == 1
        assert fleet.stats["rerouted"] > 0
        assert fleet.replicas["replica-1"].state is S.ReplicaState.EJECTED
        assert fleet.metrics.counters[("replicas_ejected", "")] == 1
        return results(out), fleet_view(plane, fleet)
    both(setup, scenario)


def test_replica_of_names_the_replica_that_served(setup):
    """The port's ``replica_of`` accessor names, for each finished and
    unclaimed request, the replica that the JAX fleet's own request record
    names (before a crash, and after the crash rerouted replica-1's
    requests); None once claimed and for an unknown id."""
    def scenario(plane):
        fleet = _fleet(plane, 2)
        _warm(fleet)
        rng = np.random.default_rng(17)
        rids = [fleet.submit(_prompt(rng), 6) for _ in range(6)]

        def owners():
            if plane.name == "port":
                return {r: fleet.replica_of(r) for r in rids}
            return {r: fleet._requests[r].replica for r in rids}

        fleet.step()
        before = owners()
        inj = plane.scenarios.replica_crash_mid_decode(
            "replica-1", at_steps=(1,)).injector()
        try:
            with inj:
                fleet.step()
        finally:
            plane.chaos.uninstall()
        while fleet.has_live_requests:
            fleet.step()
        after = owners()
        assert set(before.values()) == {"replica-0", "replica-1"}
        assert set(after.values()) == {"replica-0"}
        out = fleet.run()
        if plane.name == "port":
            assert fleet.replica_of(rids[0]) is None
            assert fleet.replica_of(10_000) is None
        return before, after, results(out)
    both(setup, scenario)


def test_replica_crash_budget_exhausted_is_typed(setup):
    def scenario(plane):
        S, chaos = plane.serve, plane.chaos
        fleet = _fleet(plane, 2, replay=S.ReplayPolicy(max_replays=0))
        _warm(fleet)
        rng = np.random.default_rng(14)
        rids = [fleet.submit(_prompt(rng), 8) for _ in range(8)]
        fleet.step()
        victim = next(r.name for r in fleet.replicas.values()
                      if r.outstanding > 0)
        inj = chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_FLEET_REPLICA,
            chaos.Trigger(at=(1,), match={"replica": victim}),
            chaos.ReplicaCrash())])
        try:
            with inj:
                fleet.step()
        finally:
            chaos.uninstall()
        out = fleet.run()
        states = [out[r].state for r in rids]
        assert S.RequestState.RETRY_EXHAUSTED in states
        assert all(s in (S.RequestState.DONE, S.RequestState.RETRY_EXHAUSTED)
                   for s in states)
        assert len(out) == len(rids)
        return victim, results(out), fleet_view(plane, fleet)
    both(setup, scenario)


# ------------------------------------------------------------------- rollout
def _run_rollout(plane, *, seed, policy, load_per_step=1, max_new=4):
    """Continuous seeded load while v1 rolls to v2."""
    S = plane.serve
    fleet = S.ServingFleet(
        _factory(plane), 2, probe=S.ProbeConfig(slow_start_steps=2),
        router=S.Router(prefix_bucket_len=8),
        metrics=plane.metrics.FleetMetrics(), clock=FakeClock())
    _warm(fleet)
    rng = np.random.default_rng(seed)
    prompts = {}

    def feed(n):
        for _ in range(n):
            p = _prompt(rng)
            r = fleet.submit(p, max_new)
            if isinstance(r, int):
                prompts[r] = p
    feed(3)
    fleet.start_rollout(_factory(plane, "v2"), "v2", policy)
    weights_seen, phases = [], []
    for _ in range(200):
        feed(load_per_step)
        fleet.step()
        weights_seen.append(dict(fleet.router.weights))
        phases.append(fleet.rollout_phase.value)
        if fleet.rollout_phase is S.RolloutPhase.COMPLETE:
            break
    assert fleet.rollout_phase is S.RolloutPhase.COMPLETE
    return fleet, prompts, fleet.run(), weights_seen, phases


def test_rollout_zero_loss_under_continuous_load(setup):
    def scenario(plane):
        S = plane.serve
        policy = S.FleetRolloutPolicy(max_surge=1, canary_weight=0.25,
                                      drain_timeout_s=None)
        fleet, prompts, out, weights_seen, phases = _run_rollout(
            plane, seed=21, policy=policy)
        rids = list(prompts)
        assert set(out) == set(rids)
        assert all(out[r].state is S.RequestState.DONE for r in rids)
        old_retired = [r for r in fleet.retired if r["version"] == "v1"]
        assert len(old_retired) == 2
        assert all(r["drained_clean"] for r in old_retired)
        assert fleet.router.weights == {"v2": 1.0}
        canary = [w["v2"] for w in weights_seen if 0 < w.get("v2", 0) < 1]
        assert canary and min(canary) == policy.canary_weight
        assert fleet.stats["rollouts_completed"] == 1
        late = max(rids)
        return (results(out), weights_seen, phases, fleet_view(plane, fleet),
                prompts[late].tolist(), out[late].tokens.tolist())
    got = both(setup, scenario)
    # the last request ran on v2: the port's own generate from its v2
    # tree gives its tokens
    prompt, tokens = got[-2:]
    want = generate(port_config(setup.cfg), setup.port.trees["v2"],
                    torch.tensor([prompt], dtype=torch.int32), 4,
                    device="cpu")
    assert want[0].tolist() == tokens


def test_rollout_is_deterministic(setup):
    def scenario(plane):
        policy = plane.serve.FleetRolloutPolicy(
            max_surge=1, canary_weight=0.25, drain_timeout_s=None)
        runs = []
        for _ in range(2):
            fleet, rids, out, _, phases = _run_rollout(plane, seed=22,
                                                       policy=policy)
            runs.append((sorted((r, out[r].state.value) for r in rids),
                         fleet.stats["steps"], phases))
        assert runs[0] == runs[1]
        return runs[0]
    both(setup, scenario)


def test_rollout_drain_timeout_cancels_stragglers(setup):
    def scenario(plane):
        S = plane.serve
        clock = FakeClock()
        fleet = S.ServingFleet(
            _factory(plane), 2, probe=S.ProbeConfig(slow_start_steps=1),
            router=S.Router(prefix_bucket_len=8), clock=clock)
        _warm(fleet)
        rng = np.random.default_rng(23)
        long_rid = fleet.submit(_prompt(rng), 50)
        assert isinstance(long_rid, int)
        fleet.step()
        fleet.start_rollout(_factory(plane, "v2"), "v2",
                            S.FleetRolloutPolicy(max_surge=2,
                                                 canary_weight=0.5,
                                                 drain_timeout_s=5.0))
        for _ in range(100):
            fleet.step()
            clock.advance(0.5)
            if fleet.rollout_phase is S.RolloutPhase.COMPLETE:
                break
        assert fleet.rollout_phase is S.RolloutPhase.COMPLETE
        out = fleet.run()
        assert out[long_rid].state is S.RequestState.CANCELLED
        assert 0 < out[long_rid].tokens.size < 50
        assert len([r for r in fleet.retired if not r["drained_clean"]]) == 1
        return results(out), fleet_view(plane, fleet)
    both(setup, scenario)


def test_rollout_interrupt_still_converges(setup):
    def scenario(plane):
        S = plane.serve
        fleet = S.ServingFleet(
            _factory(plane), 2, probe=S.ProbeConfig(slow_start_steps=2),
            router=S.Router(prefix_bucket_len=8), clock=FakeClock())
        _warm(fleet)
        rng = np.random.default_rng(24)
        rids = []

        def feed(n=1):
            for _ in range(n):
                r = fleet.submit(_prompt(rng), 3)
                if isinstance(r, int):
                    rids.append(r)
        feed(3)
        fleet.start_rollout(_factory(plane, "v2"), "v2",
                            S.FleetRolloutPolicy(max_surge=1,
                                                 canary_weight=0.2,
                                                 drain_timeout_s=None))
        inj = plane.scenarios.fleet_rollout_chaos().injector()
        try:
            with inj:
                for _ in range(200):
                    feed(1)
                    fleet.step()
                    if fleet.rollout_phase is S.RolloutPhase.COMPLETE:
                        break
        finally:
            plane.chaos.uninstall()
        assert fleet.rollout_phase is S.RolloutPhase.COMPLETE
        assert fleet.stats["rollout_interrupts"] >= 1
        assert fleet.stats["readiness_flaps"] >= 1
        out = fleet.run()
        assert set(out) == set(rids)
        assert all(out[r].state is S.RequestState.DONE for r in rids)
        return inj.events, results(out), fleet_view(plane, fleet)
    both(setup, scenario)


# ----------------------------------------------------------- prefix affinity
def _prefix_workload(rng, n_prefixes=4, repeats=10, bucket=8):
    prefixes = [_prompt(rng, bucket) for _ in range(n_prefixes)]
    return [np.concatenate([pf, _prompt(rng, 4)])
            for _ in range(repeats) for pf in prefixes]


def test_prefix_affinity_beats_random_routing(setup):
    def scenario(plane):
        work = _prefix_workload(np.random.default_rng(31))
        rates, views = {}, {}
        for mode in ("affinity", "random"):
            fleet = _fleet(plane, 2, bucket=8, mode=mode)
            _warm(fleet)
            for p in work:
                assert isinstance(fleet.submit(p, 3), int)
            out = fleet.run()
            assert all(v.ok for v in out.values())
            hits = fleet.stats["prefix_hits"]
            misses = fleet.stats["prefix_misses"]
            assert hits + misses == len(work)
            rates[mode] = hits / (hits + misses)
            views[mode] = (results(out), fleet_view(plane, fleet))
            if mode == "affinity":
                assert misses == 4
        assert rates["affinity"] > rates["random"], rates
        return rates, views
    both(setup, scenario)


# ------------------------------------------------------------- observability
def test_observation_line_feeds_autoscaler_format(setup):
    """The line parses with the reference's own ``parse_observation``."""
    def scenario(plane):
        fleet = _fleet(plane, 2, clock=TickingClock())
        _warm(fleet)
        rng = np.random.default_rng(41)
        for _ in range(4):
            fleet.submit(_prompt(rng), 3)
        fleet.run()
        line = fleet.observation_line()
        obs = parse_observation(line)
        assert obs is not None
        assert obs.latency > 0.0
        assert obs.batch == fleet.stats["steps"]
        return line
    both(setup, scenario)


def test_prometheus_exposition_with_per_replica_labels(setup):
    def scenario(plane):
        fm = plane.metrics.FleetMetrics()
        fleet = _fleet(plane, 2, metrics=fm)
        _warm(fleet)
        rng = np.random.default_rng(42)
        for _ in range(6):
            assert isinstance(fleet.submit(_prompt(rng), 3), int)
        fleet.run()
        body = text(plane, fm)
        for want in (
                'tpu_on_k8s_fleet_requests_routed_total{replica="replica-0"}',
                'tpu_on_k8s_fleet_requests_routed_total{replica="replica-1"}',
                'tpu_on_k8s_fleet_in_flight{replica="replica-0"}',
                'tpu_on_k8s_fleet_queue_depth{replica="replica-1"}',
                "tpu_on_k8s_fleet_replicas_ready 2.0",
                "tpu_on_k8s_fleet_rollout_phase 0.0"):
            assert want in body, want
        rep_text = plane.metrics.exposition(fleet.replicas["replica-0"].metrics)
        assert "tpu_on_k8s_serving_requests_submitted_total" in rep_text
        assert ("tpu_on_k8s_serving_time_to_first_token_seconds_bucket"
                in rep_text)
        assert fm.counters[("requests_routed", "replica-0")] > 0
        assert fm.gauges[("replicas_ready", "")] == 2
        return fleet_view(plane, fleet)
    both(setup, scenario)


def test_drain_after_ejection_is_typed_and_survives_retired_gateways(setup):
    def scenario(plane):
        S, chaos = plane.serve, plane.chaos
        fleet = _fleet(plane, 2, clock=TickingClock())
        _warm(fleet)
        rng = np.random.default_rng(55)
        rids = [fleet.submit(_prompt(rng), 40) for _ in range(4)]
        fleet.step()
        assert fleet.cancel(rids[0])
        inj = chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_FLEET_REPLICA, chaos.Trigger(at=(1,)),
            chaos.ReplicaCrash())])
        try:
            with inj:
                fleet.step()
        finally:
            chaos.uninstall()
        assert fleet.stats["ejected"] == 1
        ejected = next(r for r in fleet.replicas.values()
                       if r.state is S.ReplicaState.EJECTED)
        assert ejected.engine is None and ejected.gateway is None
        out = fleet.drain(timeout_s=3.0)
        assert set(out) == set(rids)
        assert all(out[r].state in (S.RequestState.DONE,
                                    S.RequestState.CANCELLED,
                                    S.RequestState.RETRY_EXHAUSTED)
                   for r in rids)
        assert out[rids[0]].state is S.RequestState.CANCELLED
        return results(out), fleet_view(plane, fleet)
    both(setup, scenario)


def test_fleet_drain_timeout_is_typed(setup):
    def scenario(plane):
        S = plane.serve
        fleet = _fleet(plane, 2, clock=TickingClock())
        _warm(fleet)
        rng = np.random.default_rng(43)
        long_rid = fleet.submit(_prompt(rng), 50)
        short_rid = fleet.submit(_prompt(rng), 3)
        fleet.step()
        out = fleet.drain(timeout_s=3.0)
        assert out[short_rid].state in (S.RequestState.DONE,
                                        S.RequestState.CANCELLED)
        assert out[long_rid].state is S.RequestState.CANCELLED
        assert 0 < out[long_rid].tokens.size < 50
        rej = fleet.submit(np.arange(4, dtype=np.int32), 2)
        assert isinstance(rej, S.Rejected)
        return results(out), outcome(rej), fleet_view(plane, fleet)
    both(setup, scenario)


# ------------------------------------------------ direct cross-checks
def test_router_routes_1000_seeded_prompts_as_the_reference(setup):
    """Four replicas over two versions at a 0.7/0.3 split, seeded
    outstanding-token loads, noted prefixes shorter and longer than the
    bucket, model-keyed routing on half the prompts, and a replica that
    leaves halfway: every pick equals the reference router's."""
    def scenario(plane):
        r = ROUTERS[plane.name].Router(prefix_bucket_len=8, spill_tokens=12)
        names = [f"replica-{i}" for i in range(4)]
        for i, n in enumerate(names):
            r.add_replica(n, "v1" if i < 2 else "v2")
        r.set_weights({"v1": 0.7, "v2": 0.3})
        r.set_resident("replica-0", ["m-0"])
        r.set_resident("replica-2", ["m-1"])
        rng = np.random.default_rng(5)
        heads = [_prompt(rng, int(n)) for n in (5, 8, 11)]
        for h in heads:
            r.note_prefix(h)
        picks = []
        for i in range(1000):
            if i == 500:
                r.remove_replica("replica-3")
                names = names[:3]
            head = heads[int(rng.integers(0, 3))]
            p = (np.concatenate([head, _prompt(rng, int(rng.integers(1, 9)))])
                 if rng.random() < 0.6 else _prompt(rng, int(rng.integers(2, 20))))
            load = {n: int(rng.integers(0, 40)) for n in names}
            if rng.random() < 0.5:
                picks.append(r.route_model(f"m-{int(rng.integers(0, 3))}",
                                           p, names, load))
            else:
                picks.append(r.route(p, names, load))
            picks.append((r.bucket_key(p), r.match_prefix(p)))
        return picks
    picks = both(setup, scenario)
    assert len({p for p in picks[::2]}) > 1


def test_health_monitor_transitions_match_on_a_seeded_probe_sequence(setup):
    def scenario(plane):
        H = HEALTH[plane.name]
        h = H.HealthMonitor(H.ProbeConfig(slow_start_steps=3, stall_steps=2))
        rng = np.random.default_rng(9)
        seen = []
        for _ in range(400):
            if rng.random() < 0.05:
                h.flap(int(rng.integers(1, 5)))
            h.observe_step(progressed=bool(rng.random() < 0.7),
                           busy=bool(rng.random() < 0.8))
            seen.append((h.ready, h.wedged, h.healthy_streak,
                         h.stall_streak, h.flap_steps_left, h.flaps))
        return seen
    seen = both(setup, scenario)
    assert {s[:2] for s in seen} >= {(True, False), (False, False),
                                     (False, True)}


def test_serve_load_fleet_mode_smoke(setup):
    """The reference's ``test_serve_load_fleet_mode_smoke`` on the port:
    the seeded trace through the fleet, zero-silent-loss accounting and the
    per-replica TTFT and queue-wait breakdown in the summary."""
    import tpu_on_k8s_torch.serve as pserve
    from test_torch_api import TOOLS, reference_functions
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine

    cpu = (r"ContinuousBatchingEngine\(cfg, params, n_slots=n_slots\)",
           'ContinuousBatchingEngine(cfg, params, n_slots=n_slots, '
           'device="cpu")')
    ns = reference_functions(
        "test_serve_fleet",
        ["_factory", "_fleet", "_warm", "test_serve_load_fleet_mode_smoke"],
        {"np": np, "ContinuousBatchingEngine": ContinuousBatchingEngine,
         "ServingFleet": pserve.ServingFleet,
         "ProbeConfig": pserve.ProbeConfig, "Router": pserve.Router},
        subs=(*TOOLS, cpu))
    ns["test_serve_load_fleet_mode_smoke"]((
        port_config(setup.cfg), setup.port.trees["v1"],
        setup.port.trees["v2"]))
