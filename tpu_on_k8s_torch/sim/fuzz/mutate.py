"""The mutation engine: seeded perturbations over every `Scenario`
knob.

Each mutator is a named pure function ``(rng, scenario, config) ->
Scenario | None`` — ``None`` means "not applicable here" (e.g. you
cannot drop a burst from a burstless profile). `mutate` draws the
mutator *names* and every random number from one caller-owned
``random.Random``, so a (base, seed) pair always produces the same
mutant: the whole fuzz campaign replays from its seed.

Mutations are CLAMPED, not open-ended: amplitudes stay in the DSL's
legal [0,1], durations stay inside ``[min_virtual_s, max_virtual_s]``
(an unbounded fuzzer that doubles `million_diurnal` twice would spend
its whole budget inside one scenario), and cost-model constants stay
inside the calibrated bounds (`sim/calibrate.CostBounds`) — a twin
whose decode step costs a virtual hour finds nothing real.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Callable, List, Optional, Tuple

from tpu_on_k8s_torch.sim.calibrate import CostBounds
from tpu_on_k8s_torch.sim.scenario import (
    CHAOS_REPLICA_PREEMPT,
    CHAOS_SIGNAL_OUTAGE,
    ChaosWindow,
    Scenario,
)
from tpu_on_k8s_torch.sim.traffic import DiurnalProfile, TenantMix


@dataclasses.dataclass(frozen=True)
class MutationConfig:
    """The fuzzer's guard rails (see module doc)."""

    min_virtual_s: float = 60.0
    max_virtual_s: float = 3600.0
    max_base_rate: float = 64.0
    max_replica_band: int = 16
    #: bounds for cost-constant mutations; None derives symmetric
    #: bounds around the scenario's own cost model (spread 0.5)
    cost_bounds: Optional[CostBounds] = None
    cost_spread: float = 0.5


Mutator = Callable[[random.Random, Scenario, MutationConfig],
                   Optional[Scenario]]


def _clamp(v: float, lo: float, hi: float) -> float:
    return min(max(v, lo), hi)


def _rep(sc: Scenario, **kw) -> Scenario:
    return dataclasses.replace(sc, **kw)


def _rep_profile(sc: Scenario, **kw) -> Scenario:
    return _rep(sc, profile=dataclasses.replace(sc.profile, **kw))


# -------------------------------------------------------------- traffic
def _m_amplitude(rng, sc, cfg):
    a = _clamp(sc.profile.amplitude + rng.uniform(-0.3, 0.3), 0.0, 1.0)
    return _rep_profile(sc, amplitude=round(a, 4))


def _m_phase(rng, sc, cfg):
    p = sc.profile
    shift = rng.uniform(-0.25, 0.25) * p.period_s
    return _rep_profile(sc, peak_at_s=round((p.peak_at_s + shift)
                                            % p.period_s, 3))


def _m_base_rate(rng, sc, cfg):
    mult = rng.choice((0.5, 0.75, 1.25, 1.5, 2.0))
    r = _clamp(sc.profile.base_rate * mult, 0.5, cfg.max_base_rate)
    return _rep_profile(sc, base_rate=round(r, 4))


def _m_burst_add(rng, sc, cfg):
    d = sc.duration_s
    start = round(rng.uniform(0.0, 0.8 * d), 3)
    length = round(rng.uniform(0.05, 0.3) * d, 3)
    mult = round(rng.uniform(2.0, 10.0), 3)
    bursts = sc.profile.bursts + ((start, length, mult),)
    return _rep_profile(sc, bursts=bursts)


def _m_burst_drop(rng, sc, cfg):
    if not sc.profile.bursts:
        return None
    i = rng.randrange(len(sc.profile.bursts))
    bursts = (sc.profile.bursts[:i] + sc.profile.bursts[i + 1:])
    return _rep_profile(sc, bursts=bursts)


def _m_burst_shift(rng, sc, cfg):
    if not sc.profile.bursts:
        return None
    i = rng.randrange(len(sc.profile.bursts))
    start, length, mult = sc.profile.bursts[i]
    start = round(_clamp(start + rng.uniform(-0.2, 0.2) * sc.duration_s,
                         0.0, 0.9 * sc.duration_s), 3)
    bursts = (sc.profile.bursts[:i] + ((start, length, mult),)
              + sc.profile.bursts[i + 1:])
    return _rep_profile(sc, bursts=bursts)


def _m_burst_scale(rng, sc, cfg):
    if not sc.profile.bursts:
        return None
    i = rng.randrange(len(sc.profile.bursts))
    start, length, mult = sc.profile.bursts[i]
    mult = round(_clamp(mult * rng.choice((0.5, 1.5, 2.0)), 1.1, 12.0), 3)
    length = round(_clamp(length * rng.choice((0.5, 1.0, 1.5)),
                          1.0, sc.duration_s), 3)
    bursts = (sc.profile.bursts[:i] + ((start, length, mult),)
              + sc.profile.bursts[i + 1:])
    return _rep_profile(sc, bursts=bursts)


def _m_duration(rng, sc, cfg):
    d = _clamp(sc.duration_s * rng.choice((0.5, 0.75, 1.5)),
               cfg.min_virtual_s, cfg.max_virtual_s)
    return _rep(sc, duration_s=round(d, 3))


def _m_tenants(rng, sc, cfg):
    t = sc.tenants
    weights = tuple(round(rng.uniform(0.5, 4.0), 3) for _ in t.names)
    return _rep(sc, tenants=TenantMix(names=t.names, weights=weights))


def _m_request_shape(rng, sc, cfg):
    lo = rng.randrange(2, 16)
    hi = lo + rng.randrange(4, 32)
    if rng.random() < 0.5:
        return _rep(sc, prompt_lens=(lo, hi))
    return _rep(sc, new_tokens=(lo, hi))


# ---------------------------------------------------------------- models
def _m_models(rng, sc, cfg):
    if sc.n_models <= 0:
        return None
    n = max(1, min(64, sc.n_models + rng.choice((-16, -8, 8, 16))))
    s = round(_clamp(sc.model_zipf_s + rng.uniform(-0.2, 0.4),
                     0.8, 1.8), 4)
    return _rep(sc, n_models=n, model_zipf_s=s)


# ----------------------------------------------------------------- chaos
def _m_chaos_add_outage(rng, sc, cfg):
    at = round(rng.uniform(0.0, 0.9 * sc.duration_s), 3)
    dur = round(rng.uniform(sc.scrape_period_s, 60.0), 3)
    w = ChaosWindow(at_s=at, kind=CHAOS_SIGNAL_OUTAGE, duration_s=dur,
                    note="fuzz:outage")
    return _rep(sc, chaos=sc.chaos + (w,))


def _m_chaos_add_preempt(rng, sc, cfg):
    at = round(rng.uniform(0.0, 0.9 * sc.duration_s), 3)
    w = ChaosWindow(at_s=at, kind=CHAOS_REPLICA_PREEMPT,
                    note="fuzz:preempt")
    return _rep(sc, chaos=sc.chaos + (w,))


def _m_chaos_shift(rng, sc, cfg):
    if not sc.chaos:
        return None
    i = rng.randrange(len(sc.chaos))
    w = sc.chaos[i]
    at = round(_clamp(w.at_s + rng.uniform(-0.2, 0.2) * sc.duration_s,
                      0.0, 0.95 * sc.duration_s), 3)
    moved = ChaosWindow(at_s=at, kind=w.kind, duration_s=w.duration_s,
                        note=w.note)
    return _rep(sc, chaos=sc.chaos[:i] + (moved,) + sc.chaos[i + 1:])


def _m_chaos_drop(rng, sc, cfg):
    if not sc.chaos:
        return None
    i = rng.randrange(len(sc.chaos))
    return _rep(sc, chaos=sc.chaos[:i] + sc.chaos[i + 1:])


# --------------------------------------------------------- control plane
def _m_band(rng, sc, cfg):
    if rng.random() < 0.5:
        mx = max(sc.min_replicas,
                 min(cfg.max_replica_band,
                     sc.max_replicas + rng.choice((-2, -1, 1, 2))))
        return _rep(sc, max_replicas=mx)
    mn = max(1, min(sc.max_replicas,
                    sc.min_replicas + rng.choice((-1, 1))))
    return _rep(sc, min_replicas=mn)


def _m_cooldowns(rng, sc, cfg):
    up = round(_clamp(sc.up_cooldown_s * rng.choice((0.25, 0.5, 2.0)),
                      5.0, 1200.0), 3)
    down = round(_clamp(sc.down_cooldown_s * rng.choice((0.25, 0.5, 2.0)),
                        5.0, 2400.0), 3)
    guard = round(_clamp(sc.flap_guard_s * rng.choice((0.25, 0.5, 2.0)),
                         1.0, 600.0), 3)
    return _rep(sc, up_cooldown_s=up, down_cooldown_s=down,
                flap_guard_s=guard)


def _m_slo_window(rng, sc, cfg):
    w = round(_clamp(sc.slo_window_s * rng.choice((0.25, 0.5, 2.0, 4.0)),
                     30.0, 4.0 * sc.duration_s), 3)
    return _rep(sc, slo_window_s=w)


def _m_slo_targets(rng, sc, cfg):
    mult = rng.choice((0.5, 0.75, 1.5))
    target = round(_clamp(sc.target_ttft_s * mult, 0.05, 5.0), 4)
    slo = round(_clamp(sc.slo_ttft_s * mult, target, 6.0), 4)
    return _rep(sc, target_ttft_s=target, slo_ttft_s=slo)


def _m_queue_depth(rng, sc, cfg):
    return _rep(sc, max_queue_depth=rng.choice((50, 200, 1000, 5000,
                                                50_000)))


# ---------------------------------------------------------------- broker
def _m_broker(rng, sc, cfg):
    if sc.broker_capacity_chips <= 0:
        return None
    cap = max(4, min(32, sc.broker_capacity_chips
                     + rng.choice((-4, -2, 2, 4))))
    backlog = max(0, sc.batch_backlog + rng.choice((-200, -100, 100, 200)))
    units = max(0, min(12, sc.batch_max_units + rng.choice((-2, -1, 1, 2))))
    return _rep(sc, broker_capacity_chips=cap, batch_backlog=backlog,
                batch_max_units=units)


# ------------------------------------------------------------ cost model
def _m_cost(rng, sc, cfg):
    bounds = cfg.cost_bounds or CostBounds.around(sc.cost, cfg.cost_spread)
    jig = dataclasses.replace(
        sc.cost,
        step_s=round(sc.cost.step_s * rng.uniform(0.6, 1.6), 6),
        prefill_cost=round(sc.cost.prefill_cost * rng.uniform(0.6, 1.6), 6),
        compile_s=round(sc.cost.compile_s * rng.uniform(0.6, 1.6), 6))
    return _rep(sc, cost=bounds.clamp(jig))


def _m_seed(rng, sc, cfg):
    return _rep(sc, seed=rng.randrange(1, 1_000_000))


#: name -> mutator, in the fixed order the engine draws from. Append
#: only — reordering reshuffles every existing fuzz seed's campaign.
MUTATORS: Tuple[Tuple[str, Mutator], ...] = (
    ("amplitude", _m_amplitude),
    ("phase", _m_phase),
    ("base_rate", _m_base_rate),
    ("burst_add", _m_burst_add),
    ("burst_drop", _m_burst_drop),
    ("burst_shift", _m_burst_shift),
    ("burst_scale", _m_burst_scale),
    ("duration", _m_duration),
    ("tenants", _m_tenants),
    ("request_shape", _m_request_shape),
    ("models", _m_models),
    ("chaos_add_outage", _m_chaos_add_outage),
    ("chaos_add_preempt", _m_chaos_add_preempt),
    ("chaos_shift", _m_chaos_shift),
    ("chaos_drop", _m_chaos_drop),
    ("band", _m_band),
    ("cooldowns", _m_cooldowns),
    ("slo_window", _m_slo_window),
    ("slo_targets", _m_slo_targets),
    ("queue_depth", _m_queue_depth),
    ("broker", _m_broker),
    ("cost", _m_cost),
    ("seed", _m_seed),
)


def mutator_names() -> List[str]:
    return [name for name, _ in MUTATORS]


def mutate(rng: random.Random, base: Scenario, n: int,
           cfg: Optional[MutationConfig] = None
           ) -> Tuple[Scenario, Tuple[str, ...]]:
    """Apply ``n`` randomly drawn applicable mutators to ``base``.
    Returns the mutant and the names applied (in application order).
    A draw whose mutator is inapplicable or produces an invalid
    Scenario is retried (bounded), so the caller always gets at least
    one applied mutation for n >= 1 on any sane base."""
    cfg = cfg or MutationConfig()
    sc = base
    applied: List[str] = []
    attempts = 0
    while len(applied) < n and attempts < 8 * max(n, 1):
        attempts += 1
        i = rng.randrange(len(MUTATORS))
        name, fn = MUTATORS[i]
        try:
            cand = fn(rng, sc, cfg)
        except ValueError:
            cand = None
        if cand is None:
            continue
        # global guard rails, whatever the mutator touched
        if cand.duration_s > cfg.max_virtual_s:
            cand = _rep(cand, duration_s=cfg.max_virtual_s)
        sc = cand
        applied.append(name)
    return sc, tuple(applied)
