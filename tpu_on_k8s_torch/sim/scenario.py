"""Scenario DSL: one frozen description of everything a twin run does (a
copy of ``tpu_on_k8s/sim/scenario.py``; the training slice's default
topology is the GPU flavour's ``2x8``, two 8-GPU hosts, where the
reference has two TPU hosts).

A `Scenario` composes the traffic phases (`sim/traffic.DiurnalProfile`
curve + burst windows), the virtual hardware (`sim/devices.DeviceCostModel`),
the serving control-plane knobs (autoscale band, SLO objective and its
scaled burn windows — the same ``window/60`` … ``window/4`` ratios
`serve_load --autoscale-slo` uses), the elastic-training side, and a
chaos schedule. Chaos windows are declared in VIRTUAL TIME and compiled
onto the existing `chaos.FaultRule` machinery, which triggers
by site-hit ordinal: the autoscaler fires ``SITE_AUTOSCALE_SIGNAL``
exactly once per service tick, so a window ``[at_s, at_s+duration_s)``
maps to the tick ordinals inside it — no new chaos sites (the
``SITE_REGISTRY`` gate stays untouched), no new trigger semantics.

``replica_preempt`` windows have no production chaos site (the device
layer is the twin's own); the twin schedules `SimFleet.preempt_replica`
directly at ``at_s`` and logs it into the same chaos event list.

Presets: `smoke()` is the seconds-scale tier-1 scenario;
`million_diurnal()` is the 24-virtual-hour ≥1M-request acceptance
scenario ``twin_soak million_diurnal`` replays twice and byte-compares.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

from tpu_on_k8s_torch.chaos import (
    SITE_AUTOSCALE_SIGNAL,
    FaultRule,
    SignalOutage,
    Trigger,
)
from tpu_on_k8s_torch.sim.devices import DeviceCostModel
from tpu_on_k8s_torch.sim.traffic import DiurnalProfile, ModelMix, TenantMix

SCENARIO_FORMAT = "tpu-on-k8s-scenario/v1"

CHAOS_SIGNAL_OUTAGE = "signal_outage"
CHAOS_REPLICA_PREEMPT = "replica_preempt"


@dataclasses.dataclass(frozen=True)
class ChaosWindow:
    """One chaos phase, in virtual time. ``kind`` is
    ``signal_outage`` (the autoscaler's scrape goes dark for
    ``duration_s``) or ``replica_preempt`` (the highest-named live
    replica is killed at ``at_s``; duration ignored)."""

    at_s: float
    kind: str = CHAOS_SIGNAL_OUTAGE
    duration_s: float = 0.0
    note: str = ""

    def __post_init__(self):
        if self.kind not in (CHAOS_SIGNAL_OUTAGE, CHAOS_REPLICA_PREEMPT):
            raise ValueError(f"unknown chaos kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """The whole rehearsal, declaratively. Everything downstream —
    trace, ledger, budget log, summary — is a pure function of this
    object plus its ``seed``."""

    name: str
    seed: int
    duration_s: float
    profile: DiurnalProfile
    tenants: TenantMix = TenantMix()
    prompt_lens: Tuple[int, int] = (4, 24)
    new_tokens: Tuple[int, int] = (4, 16)
    tick_s: float = 1.0
    cost: DeviceCostModel = DeviceCostModel()

    # serving control plane
    min_replicas: int = 2
    max_replicas: int = 8
    min_warm: int = 0
    target_ttft_s: float = 0.5
    slo_ttft_s: float = 0.6
    slo_window_s: float = 600.0
    scrape_period_s: float = 5.0
    reconcile_period_s: float = 15.0
    max_queue_depth: int = 50_000
    max_step: int = 2
    up_cooldown_s: float = 60.0
    down_cooldown_s: float = 600.0
    flap_guard_s: float = 30.0

    # elastic training side (0 workers disables it); the latency plan
    # maps worker count -> the [elastic-metrics] latency the virtual job
    # reports at that size, scripting the grow/grow/regress-freeze story
    train_workers: int = 2
    train_topology: str = "2x8"
    train_max_hosts: int = 8
    train_obs_period_s: float = 30.0
    train_scale_period_s: float = 60.0
    train_latency_plan: Tuple[Tuple[int, float], ...] = (
        (2, 1.0), (4, 0.6), (8, 2.0))

    # chaos
    chaos: Tuple[ChaosWindow, ...] = ()

    # tracer retention knob for the run (1 = keep everything)
    sample_every: int = 1

    # capacity broker + batch lane (0 capacity disables the market and
    # the lane entirely — the presets above stay byte-identical). The
    # capacity counts the market's units: one serving replica or one
    # training host a unit, an 8-GPU host in the GPU flavour
    broker_capacity_chips: int = 0
    broker_period_s: float = 10.0
    batch_backlog: int = 0
    batch_max_units: int = 0
    batch_work: int = 2

    # multi-model density (0 models disables: no model column is drawn
    # from the rng, no spec.models, every earlier preset byte-identical).
    # The catalog is zipf-weighted — a few hot models, a long cold tail.
    # ``model_slo_ttft_s`` > 0 gives EVERY catalog model a per-model
    # TTFT objective on the CRD; ``target_swap_s`` > 0 arms the
    # autoscaler's swap-latency cold-start signal.
    n_models: int = 0
    model_zipf_s: float = 1.05
    model_slo_ttft_s: float = 0.0
    target_swap_s: float = 0.0

    def model_mix(self) -> ModelMix:
        """The zipf catalog (call only when ``n_models`` > 0)."""
        return ModelMix.zipf(self.n_models, s=self.model_zipf_s)

    def __post_init__(self):
        if self.duration_s <= 0 or self.tick_s <= 0:
            raise ValueError("duration_s and tick_s must be > 0")
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")

    # ---------------------------------------------------------- compilation
    def signal_tick_of(self, at_s: float) -> int:
        """The 1-based ``SITE_AUTOSCALE_SIGNAL`` hit ordinal of the
        service tick at or after virtual time ``at_s`` (ticks fire at
        ``scrape_period_s, 2*scrape_period_s, …``)."""
        return max(1, int(math.ceil(at_s / self.scrape_period_s)))

    def fault_rules(self) -> List[FaultRule]:
        """Compile the ``signal_outage`` windows onto the production
        FaultRule machinery (see module doc for the time→ordinal map)."""
        rules: List[FaultRule] = []
        for w in self.chaos:
            if w.kind != CHAOS_SIGNAL_OUTAGE:
                continue
            first = self.signal_tick_of(w.at_s)
            last = max(first, self.signal_tick_of(w.at_s + w.duration_s) - 1)
            rules.append(FaultRule(
                SITE_AUTOSCALE_SIGNAL,
                Trigger(at=tuple(range(first, last + 1))),
                SignalOutage(),
                note=w.note or f"{self.name}:outage@{w.at_s:g}s"))
        return rules

    def preempt_times(self) -> List[Tuple[float, str]]:
        """(virtual time, note) of every ``replica_preempt`` window."""
        return [(w.at_s, w.note or f"{self.name}:preempt@{w.at_s:g}s")
                for w in self.chaos if w.kind == CHAOS_REPLICA_PREEMPT]


# ---------------------------------------------------------------- presets
# Named registry: soak drivers select a base with --scenario=<name> and
# the fuzzer enumerates these as mutation bases. Registration order is
# definition order, which keeps any "iterate all presets" loop seeded
# deterministically.
PRESETS: Dict[str, Callable[..., Scenario]] = {}


def register_preset(fn: Callable[..., Scenario]) -> Callable[..., Scenario]:
    """Class the function as a named scenario preset (key = its name)."""
    PRESETS[fn.__name__] = fn
    return fn


def preset(name: str, seed: int = None) -> Scenario:
    """Build the named preset, optionally overriding its default seed."""
    try:
        fn = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown scenario preset {name!r}; "
                         f"known: {', '.join(PRESETS)}") from None
    return fn() if seed is None else fn(seed=seed)


def preset_names() -> List[str]:
    return list(PRESETS)


@register_preset
def smoke(seed: int = 2468) -> Scenario:
    """The tier-1 smoke scenario: ~10 virtual minutes, a few thousand
    requests, one burst that pages the TTFT budget and scales the fleet,
    a mid-burst signal outage, and one replica preemption — every twin
    mechanism exercised in well under a wall second."""
    return Scenario(
        name="smoke",
        seed=seed,
        duration_s=600.0,
        tick_s=0.25,
        profile=DiurnalProfile(base_rate=6.0, amplitude=0.3,
                               period_s=600.0, peak_at_s=300.0,
                               bursts=((180.0, 90.0, 6.0),)),
        cost=DeviceCostModel(step_s=0.05, compile_s=20.0, n_slots=8),
        min_replicas=2, max_replicas=8,
        # window << duration: the burst must SLIDE OUT of the budget
        # window before the run ends, or the budget stays exhausted and
        # the why-chain never closes with burn_recovered
        target_ttft_s=0.5, slo_ttft_s=0.6, slo_window_s=150.0,
        scrape_period_s=5.0, flap_guard_s=20.0,
        train_obs_period_s=20.0, train_scale_period_s=40.0,
        chaos=(ChaosWindow(at_s=120.0, kind=CHAOS_SIGNAL_OUTAGE,
                           duration_s=15.0, note="smoke:scrape-dark"),
               ChaosWindow(at_s=420.0, kind=CHAOS_REPLICA_PREEMPT,
                           note="smoke:preempt")),
    )


@register_preset
def broker_contention(seed: int = 1357) -> Scenario:
    """The capacity-market rehearsal: a 12-host cluster where everyone
    wants the same slices at once. At rest the market is nearly full —
    serving holds 2, training holds 2, and the broker fills the batch
    lane's 400-item backlog into the remaining idle hosts (up to 6
    units). Then the burst pages the TTFT budget (serving demands up to
    8 via urgent scale-ups), the training job's latency plan scripts a
    grow to 4, and the escalation ladder has to arbitrate: degrade
    first, harvest the batch lane within one tick, shrink training
    toward its floor of 2, refuse only when the market is truly dry.
    A mid-burst scrape outage and a replica preemption ride along so
    the ladder clears under chaos too. Every grant/preempt/refusal is
    one ledger record; ``broker_soak`` replays this twice and
    byte-compares the artifact set."""
    return Scenario(
        name="broker_contention",
        seed=seed,
        duration_s=600.0,
        tick_s=0.25,
        profile=DiurnalProfile(base_rate=6.0, amplitude=0.3,
                               period_s=600.0, peak_at_s=300.0,
                               bursts=((180.0, 90.0, 6.0),)),
        cost=DeviceCostModel(step_s=0.05, compile_s=20.0, n_slots=8),
        min_replicas=2, max_replicas=8,
        target_ttft_s=0.5, slo_ttft_s=0.6, slo_window_s=150.0,
        scrape_period_s=5.0, flap_guard_s=20.0,
        train_obs_period_s=20.0, train_scale_period_s=40.0,
        chaos=(ChaosWindow(at_s=200.0, kind=CHAOS_SIGNAL_OUTAGE,
                           duration_s=15.0,
                           note="broker:mid-burst-scrape-dark"),
               ChaosWindow(at_s=420.0, kind=CHAOS_REPLICA_PREEMPT,
                           note="broker:preempt")),
        broker_capacity_chips=12,
        broker_period_s=5.0,
        batch_backlog=400,
        batch_max_units=6,
        batch_work=2,
    )


@register_preset
def multi_model_density(seed: int = 7531) -> Scenario:
    """The model-pool rehearsal: 50 small models behind one fleet,
    zipf-weighted traffic (a few hot heads, a long cold tail), and a
    residency cap that forces real swap churn — every cold-tail request
    risks a ``swap_cold_s`` load that evicts the LRU resident, exactly
    the `serve/modelpool.ModelPool` economics. Every model carries a
    per-model TTFT objective (looser than the fleet SLO — the swap tax
    is priced in), the autoscaler's ``target_swap_s`` cold-start signal
    is armed, and a mid-run burst plus a replica preemption stress the
    pool under churn. The acceptance question is density: the warm
    chip floor must come in far under the one-replica-per-model control
    arm (50 models x one ``REPLICA_TOPOLOGY`` slice each) while the
    per-model budgets hold. ``multimodel_soak`` replays this twice and
    byte-compares the artifact set."""
    return Scenario(
        name="multi_model_density",
        seed=seed,
        duration_s=600.0,
        tick_s=0.25,
        profile=DiurnalProfile(base_rate=8.0, amplitude=0.3,
                               period_s=600.0, peak_at_s=300.0,
                               bursts=((240.0, 90.0, 4.0),)),
        cost=DeviceCostModel(step_s=0.05, compile_s=20.0, n_slots=8,
                             swap_s=0.05, swap_cold_s=0.25,
                             max_resident_models=8),
        min_replicas=3, max_replicas=8,
        target_ttft_s=0.6, slo_ttft_s=0.8, slo_window_s=150.0,
        scrape_period_s=5.0, flap_guard_s=20.0,
        train_workers=0,
        chaos=(ChaosWindow(at_s=420.0, kind=CHAOS_REPLICA_PREEMPT,
                           note="multimodel:preempt"),),
        n_models=50,
        model_zipf_s=1.05,
        model_slo_ttft_s=1.5,
        target_swap_s=0.4,
    )


@register_preset
def million_diurnal(seed: int = 97) -> Scenario:
    """The acceptance scenario: 24 virtual hours, ≥1M requests across
    three tenants on a diurnal curve, two flash-crowd bursts (the
    second one pages the budget and forces an urgent scale-up whose
    burn recovery closes the why-chain), a scrape outage riding the
    first burst, and an afternoon replica preemption. 1-in-64 trace
    sampling keeps the span dump at report scale; breach/chaos traces
    are pinned, so every cited exemplar still resolves."""
    return Scenario(
        name="million_diurnal",
        seed=seed,
        duration_s=86_400.0,
        tick_s=0.25,
        profile=DiurnalProfile(
            base_rate=12.5, amplitude=0.6, period_s=86_400.0,
            peak_at_s=0.6 * 86_400.0,
            bursts=((4.0 * 3600.0, 1200.0, 6.0),
                    (15.0 * 3600.0, 1800.0, 3.0))),
        tenants=TenantMix(names=("tenant-a", "tenant-b", "tenant-c"),
                          weights=(3.0, 2.0, 1.0)),
        cost=DeviceCostModel(step_s=0.05, compile_s=30.0, n_slots=8),
        min_replicas=2, max_replicas=10,
        target_ttft_s=0.5, slo_ttft_s=0.6, slo_window_s=1800.0,
        scrape_period_s=5.0, flap_guard_s=60.0,
        train_obs_period_s=30.0, train_scale_period_s=60.0,
        chaos=(ChaosWindow(at_s=4.0 * 3600.0 + 300.0,
                           kind=CHAOS_SIGNAL_OUTAGE, duration_s=30.0,
                           note="million:burst1-scrape-dark"),
               ChaosWindow(at_s=13.0 * 3600.0,
                           kind=CHAOS_REPLICA_PREEMPT,
                           note="million:afternoon-preempt")),
        sample_every=64,
    )


@register_preset
def slo_regression(seed: int = 6151) -> Scenario:
    """The deliberately planted failing scenario: a pinned replica band
    (min == max, so the autoscaler cannot add capacity) under a long 8x
    flash crowd, with a budget window wider than the run — the TTFT
    budget exhausts and can never recover. The fuzz smoke run keeps this
    base in its enumeration precisely so the oracle always has one
    genuine failure to find, shrink, and pin into the corpus."""
    return Scenario(
        name="slo_regression",
        seed=seed,
        duration_s=240.0,
        tick_s=0.25,
        profile=DiurnalProfile(base_rate=8.0, amplitude=0.2,
                               period_s=240.0, peak_at_s=120.0,
                               bursts=((60.0, 150.0, 8.0),)),
        cost=DeviceCostModel(step_s=0.05, compile_s=20.0, n_slots=8),
        min_replicas=2, max_replicas=2,
        # window >> duration: once the burst exhausts the budget it
        # stays exhausted through the end of the run
        target_ttft_s=0.5, slo_ttft_s=0.6, slo_window_s=600.0,
        scrape_period_s=5.0, flap_guard_s=20.0,
        train_workers=0,
    )


# ---------------------------------------------------------- serialization
# A Scenario is the unit the fuzzer mutates, shrinks, and checks into a
# corpus directory — so it needs a stable JSON round trip. Docs are
# tolerant of MISSING fields (they take the dataclass default), which
# lets old corpus entries keep replaying after the DSL grows a knob;
# unknown fields are an error (a corpus entry that spells a knob wrong
# must not silently replay a different scenario).

def _plain(v: Any) -> Any:
    """Tuples -> lists, recursively (JSON has no tuple)."""
    if isinstance(v, tuple):
        return [_plain(x) for x in v]
    return v


def _tupled(v: Any) -> Any:
    """Lists -> tuples, recursively (dataclass fields are tuples)."""
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def _sub_doc(obj: Any) -> Dict[str, Any]:
    return {f.name: _plain(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _sub_from(cls: type, doc: Dict[str, Any]) -> Any:
    known = {f.name for f in dataclasses.fields(cls)}
    bad = sorted(set(doc) - known)
    if bad:
        raise ValueError(f"unknown {cls.__name__} fields {bad}")
    return cls(**{k: _tupled(v) for k, v in doc.items()})


def scenario_to_doc(sc: Scenario) -> Dict[str, Any]:
    """The scenario as a JSON-ready dict (format-stamped)."""
    doc: Dict[str, Any] = {"format": SCENARIO_FORMAT}
    for f in dataclasses.fields(Scenario):
        v = getattr(sc, f.name)
        if f.name in ("profile", "tenants", "cost"):
            doc[f.name] = _sub_doc(v)
        elif f.name == "chaos":
            doc[f.name] = [_sub_doc(w) for w in v]
        else:
            doc[f.name] = _plain(v)
    return doc


def scenario_from_doc(doc: Dict[str, Any]) -> Scenario:
    """Rebuild a Scenario from `scenario_to_doc` output."""
    fmt = doc.get("format")
    if fmt != SCENARIO_FORMAT:
        raise ValueError(f"not a scenario doc (format={fmt!r})")
    fields = {f.name for f in dataclasses.fields(Scenario)}
    bad = sorted(set(doc) - fields - {"format"})
    if bad:
        raise ValueError(f"unknown Scenario fields {bad}")
    kw: Dict[str, Any] = {}
    for name in fields & set(doc):
        v = doc[name]
        if name == "profile":
            kw[name] = _sub_from(DiurnalProfile, v)
        elif name == "tenants":
            kw[name] = _sub_from(TenantMix, v)
        elif name == "cost":
            kw[name] = _sub_from(DeviceCostModel, v)
        elif name == "chaos":
            kw[name] = tuple(_sub_from(ChaosWindow, w) for w in v)
        else:
            kw[name] = _tupled(v)
    return Scenario(**kw)
