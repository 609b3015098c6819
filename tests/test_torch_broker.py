"""The port's capacity broker (``coordinator/broker.py``) and batch lane
(``serve/batchlane.py``) against the reference on the CPU.

* ``tests/test_broker.py`` runs against the port through
  ``test_torch_api.reference_cases``, every case from ``TestAdmission`` to
  ``TestPricedBids``, ``TestBatchLane`` and ``TestFleetBrokerGate``
  included; its ``TPUPolicy`` slice is the GPU flavour's ``GPUPolicy``
  with the same host count (``slice_literals``).
* A seeded differential: random consumers (serving, training, batch and
  warm lanes, self-scaling and broker-managed, with floors, units, degrade
  variants, honest and lying applies), capacities and request sequences
  over 200 ticks go through both packages' brokers, each on its own
  ``DecisionLedger`` and ``BrokerMetrics``, under a stale-bid schedule at
  ``SITE_BROKER_GRANT`` on some seeds. The decision logs are byte-identical,
  the ledgers equal record for record (their dumps byte for byte), and the
  admission verdicts, applies, degrades, metrics and chaos logs equal.
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_api import reference_cases, slice_literals
from test_torch_autoscale import CHAOS, METRICS

globals().update(reference_cases("test_broker",
                                 subs=(slice_literals, METRICS, CHAOS)))


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestAdmission", "TestLadderRungs", "TestLadderSequence",
            "TestBrokerChaos", "TestFleetBrokerGate", "TestBatchLane",
            "TestBrokerPolicy", "TestPricedBids"} <= names


# ---- a seeded differential of both packages' brokers -------------------------

from tpu_on_k8s import chaos as rchaos  # noqa: E402
from tpu_on_k8s.coordinator import broker as rbroker  # noqa: E402
from tpu_on_k8s.metrics import metrics as rmetrics  # noqa: E402
from tpu_on_k8s.obs import ledger as rledger  # noqa: E402
from tpu_on_k8s_torch import chaos as pchaos  # noqa: E402
from tpu_on_k8s_torch import metrics as pmetrics  # noqa: E402
from tpu_on_k8s_torch.coordinator import broker as pbroker  # noqa: E402
from tpu_on_k8s_torch.obs import ledger as pledger  # noqa: E402

TICKS = 200
KINDS = ("serving", "training", "batch", "warm")


def _market(seed: int) -> dict:
    """The market as plain data, drawn once with numpy: the capacity, the
    consumers and, for every tick, what each self-scaling consumer asks
    and whether it scales into a grant."""
    rng = np.random.default_rng(seed)
    consumers = []
    for i in range(int(rng.integers(3, 7))):
        kind = str(rng.choice(KINDS))
        unit = int(rng.choice((1, 2, 4, 8)))
        current = int(rng.integers(0, 5))
        consumers.append(dict(
            name=f"{kind}-{i}", kind=kind, unit=unit, current=current,
            floor=int(rng.integers(0, current + 1)) if kind != "batch" else 0,
            desired=current + int(rng.integers(0, 5)),
            priority=(None if rng.random() < 0.7
                      else int(rng.integers(1, 120))),
            cost=float(rng.integers(0, 4)), util=float(rng.integers(0, 4)),
            variants=[f"v{k}" for k in range(int(rng.integers(0, 3)))]
            if kind == "serving" else [],
            honest=bool(rng.random() < 0.85),
            managed=kind in ("batch", "warm"),
            degrade=kind == "serving" and rng.random() < 0.7))
    used = sum(c["current"] * c["unit"] for c in consumers)
    capacity = used + int(rng.integers(-4, 24))
    ticks = []
    for _ in range(TICKS):
        asks = []
        for c in consumers:
            if c["managed"] or rng.random() < 0.6:
                continue
            asks.append(dict(name=c["name"], up=int(rng.integers(-1, 4)),
                             urgent=bool(rng.random() < 0.2),
                             trigger=(f"slo_page:{c['name']}#"
                                      f"{int(rng.integers(1, 9))}"
                                      if rng.random() < 0.3 else ""),
                             scale=bool(rng.random() < 0.7)))
        wants = {c["name"]: int(rng.integers(0, 9)) for c in consumers
                 if c["managed"] and rng.random() < 0.15}
        ticks.append(dict(asks=asks, wants=wants,
                          leave=(str(rng.choice([c["name"]
                                                 for c in consumers]))
                                 if rng.random() < 0.01 else "")))
    stale = ([int(x) for x in rng.choice(np.arange(1, 60), size=3,
                                         replace=False)]
             if seed % 2 else [])
    return dict(capacity=capacity, consumers=consumers, ticks=ticks,
                stale=sorted(stale))


class _Lane:
    """A scripted consumer over one package's ``Bid``."""

    def __init__(self, mod, spec: dict) -> None:
        self.mod, self.spec = mod, dict(spec)
        self.current, self.desired = spec["current"], spec["desired"]
        self.variants = list(spec["variants"])
        self.applied, self.flips = [], []

    def bid(self):
        s, mod = self.spec, self.mod
        prio = s["priority"] if s["priority"] is not None else {
            "serving": mod.PRIORITY_SERVING, "training": mod.PRIORITY_TRAINING,
            "batch": mod.PRIORITY_BATCH, "warm": mod.PRIORITY_WARM}[s["kind"]]
        return mod.Bid(name=s["name"], kind=s["kind"], priority=prio,
                       current=self.current, desired=self.desired,
                       floor=min(s["floor"], self.current), unit=s["unit"],
                       marginal_utility=s["util"], preemption_cost=s["cost"])

    def apply(self, target, reason):
        self.applied.append((target, reason))
        if self.spec["honest"]:
            self.current = target
        return self.spec["honest"] or len(self.applied) % 3 != 0

    def degrade(self, do_apply):
        if not self.variants:
            return ""
        v = self.variants[0]
        if do_apply:
            self.variants.pop(0)
            self.flips.append(v)
        return v


def _run_market(port: bool, seed: int) -> dict:
    mod, chaos, metrics, ledger = (
        (pbroker, pchaos, pmetrics, pledger) if port else
        (rbroker, rchaos, rmetrics, rledger))
    market = _market(seed)
    t = {"now": 0.0}
    led = ledger.DecisionLedger(lambda: t["now"])
    m = metrics.BrokerMetrics()
    broker = mod.CapacityBroker(market["capacity"], ledger=led, metrics=m,
                                max_pressure_ticks=6, max_grant_ticks=5)
    lanes = {}
    for spec in market["consumers"]:
        lane = lanes[spec["name"]] = _Lane(mod, spec)
        broker.register(spec["name"], lane.bid, apply_fn=lane.apply,
                        degrade_fn=lane.degrade if spec["degrade"] else None,
                        managed=spec["managed"])
    inj = chaos.FaultInjector([chaos.FaultRule(
        chaos.SITE_BROKER_GRANT, chaos.Trigger(at=tuple(market["stale"])),
        chaos.StaleBid(), note="stale-bid the grant apply")], seed=seed) \
        if market["stale"] else None
    verdicts = []
    if inj is not None:
        chaos.install(inj)
    try:
        for tick in market["ticks"]:
            for ask in tick["asks"]:
                lane = lanes.get(ask["name"])
                if lane is None:
                    continue
                target = max(0, lane.current + ask["up"])
                ok = broker.request_capacity(
                    ask["name"], lane.current, target, urgent=ask["urgent"],
                    trigger=ask["trigger"])
                verdicts.append((ask["name"], lane.current, target, ok))
                if ok and ask["scale"]:
                    lane.current = target
                    lane.desired = max(lane.desired, target)
            for name, want in tick["wants"].items():
                if name in lanes:
                    lanes[name].desired = want
            if tick["leave"] and tick["leave"] in lanes:
                broker.deregister(tick["leave"])
                del lanes[tick["leave"]]
            broker.run_once()
            t["now"] += 0.25
    finally:
        if inj is not None:
            chaos.uninstall(inj)
    return dict(
        log=list(broker.decision_log), lines=led.lines(), led=led,
        verdicts=verdicts, counters=dict(m.counters), gauges=dict(m.gauges),
        lanes={n: (lane.current, lane.applied, lane.flips)
               for n, lane in lanes.items()},
        chaos=list(inj.events) if inj is not None else [],
        consumers=broker.consumers(), tick=broker.tick_count())


@pytest.mark.parametrize("seed", range(8))
def test_brokers_agree_on_seeded_markets(seed, tmp_path):
    ref, port = _run_market(False, seed), _run_market(True, seed)
    assert "\n".join(port["log"]).encode() == "\n".join(ref["log"]).encode()
    assert port["lines"] == ref["lines"]
    ref["led"].dump(str(tmp_path / "r.json"))
    port["led"].dump(str(tmp_path / "p.json"))
    assert (tmp_path / "r.json").read_bytes() == \
        (tmp_path / "p.json").read_bytes()
    for key in ("verdicts", "counters", "gauges", "lanes", "chaos",
                "consumers", "tick"):
        assert port[key] == ref[key], key
    assert port["tick"] == TICKS and len(port["log"]) > TICKS


def test_the_seeded_markets_climb_the_whole_ladder():
    """Across the seeds the differential covers every rung, the fill, the
    pressure's lapse and timeout, grant expiry and the stale-bid rejection."""
    reasons, commits = set(), set()
    for seed in range(8):
        run = _run_market(True, seed)
        for line in run["log"]:
            for f in line.split():
                if f.startswith("reason="):
                    reasons.add(f[len("reason="):].split(":")[0])
        commits |= {r.commit for r in run["led"].records
                    if getattr(r, "commit", "")}
    assert {"degrade", "harvest", "preempt", "grant", "fill",
            "refuse", "pressure_wait"} <= reasons, reasons
    assert "conflict:StaleBidError" in commits, commits


# ---- chip_smoke.py phase 16's drivers on their CPU twin ---------------------

def _twin():
    import dataclasses

    import torch

    import chip_smoke
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.transformer import TransformerConfig

    cfg = dataclasses.replace(
        TransformerConfig.tiny(), max_seq_len=chip_smoke.FLEET_MAX_LEN,
        vocab_size=chip_smoke.GPT2_HF_CONFIG["vocab_size"],
        dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            dtype=torch.float32)


def test_the_card_market_on_its_cpu_twin():
    """``chip_smoke.py`` phase 16 (a)'s market (``brokered_burst``: the
    operator's entry with the coordinator and the broker, phase 15's burst
    over a fleet, the batch lane over its own gateway, the elastic job of
    two tenant queues) at its CPU twin: ``market_gates`` hold, the ladder
    climbs harvest -> preempt -> grant after two refused scale-ups, the
    harvest yields the lane's in-flight items, and two runs log
    identically (what the card's run is held to, byte for byte)."""
    import chip_smoke

    cfg, params = _twin()
    env = chip_smoke.brokered_burst(cfg, params, "cpu",
                                    seed=chip_smoke.FLEET_SEED)
    chip_smoke.market_gates("(a)", env)
    moved = [r for r in chip_smoke.broker_rungs(env["broker"].decision_log)
             if r[2] != "steady"]
    assert moved == [
        ("batch", "up", "fill:idle_capacity"),
        ("batch", "down", "harvest:serve/default/svc"),
        ("train/default/train", "down", "preempt:serve/default/svc"),
        ("serve/default/svc", "hold", "pressure_relieved"),
        ("serve/default/svc", "up", "grant:+3"),
        ("batch", "up", "fill:idle_capacity")]
    assert [(o, n) for _, o, n in env["transitions"]] == [(1, 4), (4, 2),
                                                          (2, 1)]
    assert len(env["refusals"]) == 2
    assert env["holdings"][0][1] == {"serve": 1, "train": 4, "batch": 1}
    assert env["holdings"][-1][1] == {"serve": 1, "train": 2, "batch": 1}
    assert list(env["op"].autoscaler.decision_log) == [
        "job=default/train seq=1 action=hold replicas=4->4 "
        "reason=ReachMaxReplicas"]
    again = chip_smoke.brokered_burst(cfg, params, "cpu",
                                      seed=chip_smoke.FLEET_SEED)
    for key in ("broker", "scaler"):
        assert list(again[key].decision_log) == list(env[key].decision_log)
    assert {iid: res.tokens.tolist()
            for iid, (_, res) in again["lane_done"].items()} == {
        iid: res.tokens.tolist() for iid, (_, res) in env["lane_done"].items()}


def test_the_card_broker_crash_on_its_cpu_twin(tmp_path):
    """Phase 16 (b), ``broker_grant_crash``, on two replicas of the twin:
    its gates (the reference's) hold, and the flight recorder's one dump
    loads with the reference's ``load_trace``."""
    import chip_smoke
    from tpu_on_k8s.obs.export import load_trace

    cfg, params = _twin()
    out = chip_smoke.broker_grant_crash(cfg, params, "cpu", tmp_path / "fr")
    [dump] = out["dumps"]
    assert load_trace(dump)
    assert out["fleet"].stats["ejected"] == 1
