"""FleetAutoscaler: close the fleet-load → ``InferenceService.replicas`` loop
(the counterpart of ``tpu_on_k8s/controller/fleetautoscaler.py``).

The serving twin of `controller/autoscaler.ElasticAutoscaler` — a second
control loop over the ``InferenceService`` CRD that *decides* replica
counts from observed serving load, while the existing reconciler
(`controller/inferenceservice.py`) *executes* the resulting spec change
with its surge/drain machinery:

* per registered service (``spec.autoscale`` set), every tick: collect
  one ``FleetSample`` — from an attached in-process ``ServingFleet``
  (`autoscale/signals.FleetScraper` delta-reads its per-replica
  histograms) or by tailing replica pod logs for the extended
  ``[elastic-metrics]`` observation line the fleet prints
  (`serve/fleet.ServingFleet.observation_line`);
* fold the window into a ``FleetObservation``
  (`autoscale/signals.SignalAggregator` — dead scrapes mark the window
  stale, never zero);
* run the deterministic target-tracking policy
  (`autoscale/policy.Recommender`: SLO targets, utilization band,
  slice-legal steps, hysteresis, cooldowns, flap damping, warm floor);
* execute: patch ``spec.replicas`` through the cluster client (the
  reconciler and/or an attached fleet's ``scale_to`` do the rest), write
  the decision into ``status.desired_replicas`` / ``autoscale_message``,
  and append one stable line to ``decision_log`` — the byte-comparable
  artifact two runs of one seeded trace must reproduce.

Failure discipline: a chaos/genuine scrape failure records a dead sample
(staleness holds last-known-good); a failed patch
(``SITE_AUTOSCALE_PATCH``) burns NO cooldown — ``Recommender.commit``
runs only after the write lands — so the loop retries at full speed next
tick instead of sulking through a cooldown it never used.

``run_once()`` is the deterministic unit tests and soak drive; ``run()``
wraps it in a thread at ``serving_autoscale_period_seconds`` cadence,
wired in `main.py` beside the elastic autoscaler.

Both the service loop and the per-pool loops ride the shared
observe→decide→commit kernel (`controller/loopkernel.LoopKernel`): the
kernel's ``run_tick`` template drives the hooks on ``_ServiceState`` /
``_PoolState`` and lands one decision-ledger record per decision
(`obs/ledger.py` — signals + trace exemplars, SLO-page/chaos triggers,
commit outcome, effect horizon), while the decision_log bytes stay
identical to the pre-kernel format.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Pod
from tpu_on_k8s_torch.api.inference_types import (
    DecodePolicy,
    InferenceService,
    ModelStatus,
    SLOObjectiveStatus,
)
from tpu_on_k8s_torch.autoscale.policy import (
    ACTION_DOWN,
    ACTION_UP,
    Recommender,
)
from tpu_on_k8s_torch.autoscale.signals import (
    FleetObservation,
    FleetSample,
    FleetScraper,
    SignalAggregator,
    dead_sample,
    line_watermark,
    sample_from_line,
)
from tpu_on_k8s_torch.client.cluster import InMemoryCluster, NotFoundError
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.loopkernel import (
    LoopKernel,
    OpenHorizon,
    format_commit_failure_line,
)
from tpu_on_k8s_torch.metrics import AutoscaleMetrics
from tpu_on_k8s_torch.obs.ledger import (
    COMMIT_LANDED,
    HORIZON_BURN_RECOVERED,
    HORIZON_REPLICAS_READY,
    HORIZON_ROLLOUT_COMPLETE,
    committed,
)
from tpu_on_k8s_torch.obs.slo import SLOEngine, SLOSpec, page_onsets
from tpu_on_k8s_torch.obs.trace import ensure as ensure_tracer
from tpu_on_k8s_torch.utils.logging import get_logger

_log = get_logger("fleetautoscaler")


def _fmt_signal(v: Optional[float]) -> str:
    return "none" if v is None else f"{v:.6f}"


@dataclasses.dataclass(frozen=True)
class _TickPack:
    """Everything one loop tick observed — the value the kernel's
    ``observe`` hook hands to ``decide``/``commit`` and the provenance
    hooks (`controller/loopkernel.LoopKernel`)."""

    sample: FleetSample
    obs: FleetObservation
    cur: int
    now: float
    urgent: bool = False


class _AutoscaleLoop(LoopKernel):
    """The shared anatomy of the service and per-pool decision loops,
    riding the observe→decide→commit kernel: the recommender owns the
    policy + tempo gate, the aggregator owns the signal window, the
    scraper owns delta-read positions, and the kernel owns the tick
    counter, ledger emission, and the effect horizon."""

    #: the owning controller, TYPED (set by its tick before run_tick):
    #: the concurrency analyzer's call graph follows hook→controller
    #: edges through this attribute — an untyped ctx-dict hop would
    #: sever the autoscaler thread root from its cluster-mutation paths
    owner: Optional["FleetAutoscaler"] = None

    def __init__(self) -> None:
        super().__init__()
        self.recommender: Optional[Recommender] = None
        self.policy_key: Optional[Tuple] = None
        self.aggregator: Optional[SignalAggregator] = None
        self.scraper = FleetScraper()
        #: chaos event seq drawn THIS tick's collect (0 = none) — the
        #: ledger's ``chaos#N`` trigger join key
        self.tick_chaos_seq = 0

    def bind_owner(self, owner: "FleetAutoscaler") -> None:
        self.owner = owner

    # ------------------------------------------------------------ kernel hooks
    def decide(self, pack: _TickPack, ctx):
        decision = self.recommender.decide(pack.obs, pack.cur, pack.now,
                                           urgent=pack.urgent)
        ctx["span"].set(action=decision.action, current=pack.cur,
                        target=decision.target, stale=pack.obs.stale,
                        queue_depth=pack.obs.queue_depth)
        return decision

    def record(self, pack: _TickPack, decision, ctx) -> None:
        self.owner._record(ctx["key"], ctx["svc"], pack.obs, decision,
                           pool=ctx.get("pool"))

    def commit(self, pack: _TickPack, decision, ctx) -> str:
        return self.owner._execute(ctx["key"], ctx["svc"], ctx["state"],
                                   self.recommender, decision, pack.now,
                                   pool=ctx.get("pool"))

    # -------------------------------------------------------- provenance hooks
    def tick_of(self, pack: _TickPack) -> int:
        return pack.obs.seq

    def signals_of(self, pack: _TickPack) -> Tuple[Tuple[str, str], ...]:
        o = pack.obs
        return (("ttft_p95", _fmt_signal(o.ttft_p95)),
                ("queue_wait_p95", _fmt_signal(o.queue_wait_p95)),
                ("tpot_p95", _fmt_signal(o.tpot_p95)),
                ("swap_p95", _fmt_signal(o.swap_p95)),
                ("queue_depth", str(o.queue_depth)),
                ("inflight", str(o.inflight_tokens)),
                ("slots", str(o.slots)),
                ("ready", str(o.ready_replicas)),
                ("stale", str(int(o.stale))))

    def exemplars_of(self, pack: _TickPack) -> Tuple[int, ...]:
        return pack.sample.exemplars

    def trigger_of(self, pack: _TickPack, ctx) -> str:
        if self.tick_chaos_seq:
            return f"chaos#{self.tick_chaos_seq}"
        return ""

    def horizon_events(self, h: OpenHorizon, pack: _TickPack, ctx):
        """The observable effect ends: a committed scale-up's replicas
        going ready, a committed scale-down's drain completing. A stale
        window proves nothing either way."""
        obs = pack.obs
        out = []
        if obs.stale:
            return out
        if h.action == ACTION_UP and obs.ready_replicas >= h.target:
            out.append((HORIZON_REPLICAS_READY, True))
        elif h.action == ACTION_DOWN and obs.ready_replicas <= h.target:
            out.append((HORIZON_ROLLOUT_COMPLETE, True))
        return out


class _PoolState(_AutoscaleLoop):
    """One pool's decision loop (disaggregated services run two of
    these — prefill and decode — instead of one service-level loop).
    The scraper is per pool: the pools' replicas are disjoint, and a
    shared scraper would interleave their sequence numbers."""

    def observe(self, ctx) -> Optional[_TickPack]:
        a, key, state = self.owner, ctx["key"], ctx["state"]
        sample = a._collect_pool(key, state, ctx["pool"], self)
        a._feed_slo(state, sample)
        now = a.clock()
        obs = self.aggregator.record(sample, now=now)
        cur = max(int(ctx["pspec"].replicas), 1)
        return _TickPack(sample=sample, obs=obs, cur=cur, now=now)


class _ServiceState(_AutoscaleLoop):
    """Per-service loop state: the policy's tempo gate lives in the
    recommender; the aggregator owns the signal window; ``fleet`` is the
    optional in-process execution target (single-binary serving)."""

    def __init__(self) -> None:
        super().__init__()
        self.fleet = None
        self.apply_to_fleet = True
        #: per-pool loops (``spec.pools.<pool>.autoscale`` present)
        self.pools: Dict[str, _PoolState] = {}
        #: newest observation-line batch consumed, PER POD — every pod's
        #: fleet runs its own step counter, so one shared watermark would
        #: permanently blind the scrape to any pod that started later
        self.watermark: Dict[str, int] = {}
        # --- SLO evaluation (``spec.slo`` present; `obs/slo.py`) ---
        self.slo_engine: Optional[SLOEngine] = None
        self.slo_key: Optional[Tuple] = None
        #: one cooldown bypass per page episode: set when a paging
        #: objective's urgency executed a scale-up, cleared when no
        #: objective pages — "bypass the up-cooldown ONCE", dead-banded
        #: by the budget-state hysteresis
        self.slo_bypass_used = False
        #: last rendered status.slo (avoids a status write per tick)
        self.slo_written: Optional[Dict] = None
        #: whether any non-stale objective currently pages, whether the
        #: last evaluation had a LIVE (non-stale) objective at all, and
        #: the 1-based page-episode ordinal (the count of page-onset
        #: transition lines in the budget log — by construction the
        #: ledger's ``slo_page:<svc>#N`` trigger resolves to a real
        #: line, even when paging resumes after a stale gap)
        self.slo_paging = False
        self.slo_live = False
        self.page_episode = 0
        #: ledger seq of the committed scale-UP that answered the
        #: current page episode — the decision the episode's
        #: ``burn_recovered`` event will reference, whether or not its
        #: effect horizon is still open (the capacity loop typically
        #: moves on — scales down, re-scales — before the backward-
        #: looking budget window formally refills; recovery belongs to
        #: the EPISODE, not to one horizon surviving long enough)
        self.page_up_seq: Optional[int] = None
        # --- per-model SLO evaluation (``spec.models[].slo``) ---
        #: model name → its own SLOEngine, fed through the autoscaler's
        #: ``observe_model_latency`` and published to
        #: ``status.models[name].slo`` — a model can burn its budget
        #: while the service-level aggregate looks healthy (zipf
        #: traffic: the head models drown the tail in every aggregate)
        self.model_slo: Dict[str, SLOEngine] = {}
        self.model_slo_key: Optional[Tuple] = None
        self.model_slo_written: Optional[Dict] = None

    # ------------------------------------------------------------ kernel hooks
    def observe(self, ctx) -> Optional[_TickPack]:
        a, svc, key = self.owner, ctx["svc"], ctx["key"]
        sample = a._collect(key, svc, self)
        now = a.clock()
        obs = self.aggregator.record(sample, now=now)
        cur = max(int(svc.spec.replicas), 0)
        # SLO evaluation rides the same tick: feed the fresh scrape,
        # evaluate burn rates, publish status.slo, and derive the
        # severity hint. ``spec.slo`` absent → all of this is a no-op
        # and the decision path is byte-identical.
        urgent = a._tick_slo(key, svc, self, sample, ctx["span"])
        return _TickPack(sample=sample, obs=obs, cur=cur, now=now,
                         urgent=urgent)

    def commit(self, pack: _TickPack, decision, ctx) -> str:
        outcome = super().commit(pack, decision, ctx)
        if committed(outcome) and pack.urgent \
                and decision.action == ACTION_UP \
                and decision.reason.startswith("slo_page"):
            # the bypass is spent only when it actually pierced a
            # cooldown (the policy marks those ``slo_page``) AND the
            # commit landed — a patch the chaos layer or the capacity
            # broker refused never scaled anything, so the episode
            # keeps its one escape hatch and retries at full urgency
            # next tick (the cooldown twin of the failed-patch
            # no-burn rule); it re-arms after the page episode clears
            self.slo_bypass_used = True
        return outcome

    def trigger_of(self, pack: _TickPack, ctx) -> str:
        decision = ctx.get("decision")
        if self.slo_paging and (decision is None
                                or decision.action != ACTION_DOWN):
            # downs during a lingering page are signal-driven (the
            # queue drained; the backward-looking budget just hasn't
            # refilled yet) — attributing them to the page would make
            # why_report claim the page CAUSED a scale-down
            return f"slo_page:{ctx['key']}#{self.page_episode}"
        return super().trigger_of(pack, ctx)

    def on_committed(self, rec, decision, outcome: str, ctx) -> None:
        if decision.action == ACTION_UP and self.slo_paging:
            # the decision that answered the page: the episode's
            # burn_recovered event will reference it (latest wins — the
            # last urgent escalation is the one that held)
            self.page_up_seq = rec.seq

    def horizon_events(self, h: OpenHorizon, pack: _TickPack, ctx):
        """On top of the shared ready/drain ends: an SLO-paged scale-up
        notes ``replicas_ready`` as PROGRESS — the
        page→decision→patch→recovery chain `tools/why_report.py`
        renders ends at the burn recovery, which the SLO tick emits as
        an episode-level event (see ``_evaluate_slo``) so it lands even
        when a later commit superseded this horizon first."""
        out = []
        slo_paged = h.trigger.startswith("slo_page")
        for event, closing in super().horizon_events(h, pack, ctx):
            if slo_paged and event == HORIZON_REPLICAS_READY:
                closing = False
            out.append((event, closing))
        return out


class FleetAutoscaler:
    """See module doc. One instance watches every autoscaled
    ``InferenceService`` in the cluster."""

    def __init__(self, cluster: InMemoryCluster,
                 config: Optional[JobControllerConfig] = None,
                 metrics: Optional[AutoscaleMetrics] = None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None, slo_metrics=None, ledger=None,
                 broker=None) -> None:
        self.cluster = cluster
        self.config = config or JobControllerConfig()
        self.metrics = metrics
        # the capacity broker (`coordinator/broker.CapacityBroker`):
        # set, every scale-UP asks for chips BEFORE the spec patch —
        # a refusal returns ``conflict:BrokerRefused`` from the same
        # pre-patch position as a chaos fault, so no cooldown is ever
        # burned on capacity the market would not grant. Each
        # registered service also becomes a bidder (``serve/<key>``):
        # its standing bid is what the broker's ladder degrades
        # (DecodePolicy valves) or — for lower-priority services —
        # harvests. None → market-free operation, byte-identical.
        self.broker = broker
        # the decision ledger (`obs/ledger.DecisionLedger`): every
        # service/pool loop tick lands one provenance record through the
        # loop kernel. None → NOOP (bit-for-bit the ledger-free
        # behavior — decision logs and soak byte-compares see nothing).
        self.ledger = ledger
        # the SLO telemetry plane (`metrics.SLOMetrics`): burn-rate /
        # budget gauges + transition counters for every service whose
        # spec carries an ``slo`` block. None → mirror-free evaluation
        # (status.slo still gets written).
        self.slo_metrics = slo_metrics
        self.clock = clock
        # span producer (`obs/trace.py`): one
        # ``autoscale.tick`` span per (service|pool) decision, carrying
        # the observed signal and the action — the control-plane rows of
        # the same timeline the per-request spans populate. None → NOOP
        # (the decision_log byte-compare sees zero difference).
        self._tracer = ensure_tracer(tracer)
        #: stable one-line-per-decision record (byte-identical across two
        #: runs of the same seeded trace — the autoscale-soak contract).
        #: Bounded: one line per service per tick accrues forever on a
        #: long-lived operator, and a soak fits well inside the cap.
        self.decision_log: Deque[str] = deque(maxlen=10_000)
        self._lock = threading.Lock()
        self._services: Dict[str, _ServiceState] = {}
        # the bid price board for ``spec.broker.priced`` services:
        # ``key -> {"burn": ..., "queue": ...}``, written by the tick
        # thread (burn from `_evaluate_slo`, queue-per-slot from
        # `_record`), read by `_serving_bid` on the BROKER's tick
        # thread. Guarded by its own LEAF lock — always acquired alone,
        # so the bid path still never touches this autoscaler's `_lock`
        # (no lock-order edge between the two control loops)
        self._price_lock = threading.Lock()
        self._bid_prices: Dict[str, Dict[str, float]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ registration
    @staticmethod
    def _autoscaled(svc: InferenceService) -> bool:
        """A service participates when its service-level autoscale block
        is set, when it declares SLOs (``spec.slo`` — the tick is what
        evaluates them and writes ``status.slo``, scaling or not), or —
        disaggregated — when either pool carries an autoscale block."""
        if svc.spec.autoscale is not None or svc.spec.slo is not None:
            return True
        if any(m.slo is not None for m in svc.spec.models):
            return True   # per-model SLOs: the tick evaluates them too
        pools = svc.spec.pools
        return pools is not None and (
            pools.prefill.autoscale is not None
            or pools.decode.autoscale is not None)

    def register(self, svc: InferenceService) -> None:
        if not self._autoscaled(svc):
            return
        key = f"{svc.metadata.namespace}/{svc.metadata.name}"
        with self._lock:
            self._services.setdefault(key, _ServiceState())
        self._broker_register(key)

    def deregister(self, svc: InferenceService) -> None:
        key = f"{svc.metadata.namespace}/{svc.metadata.name}"
        with self._lock:
            state = self._services.pop(key, None)
        if state is not None:
            self._abandon_loops(state)
            self._broker_deregister(key)

    @staticmethod
    def _abandon_loops(state: "_ServiceState") -> None:
        """A retired service's loops close their open effect horizons
        (service AND pools) — a deleted-mid-scale service must not pin
        the shared ledger's open_effect_horizons gauge forever."""
        state.abandon()
        for ps in state.pools.values():
            ps.abandon()

    def observe_event(self, event) -> None:
        """Watch glue: register on ADDED/MODIFIED (the autoscale block
        may be added to an existing service), deregister on DELETED."""
        if event.kind != constants.KIND_INFERENCESERVICE:
            return
        if event.type in ("ADDED", "MODIFIED"):
            self.register(event.obj)
        elif event.type == "DELETED":
            self.deregister(event.obj)

    def registered(self) -> List[str]:
        with self._lock:
            return sorted(self._services)

    def attach_fleet(self, namespace: str, name: str, fleet, *,
                     apply: bool = True) -> None:
        """Bind an in-process ``ServingFleet`` as both the signal source
        (scraped directly, no log round-trip) and — with ``apply`` — the
        execution target (``fleet.scale_to`` after each committed
        patch). Single-binary deployments and the deterministic
        end-to-end tests use this; the CRD-only path tails pod logs."""
        key = f"{namespace}/{name}"
        with self._lock:
            state = self._services.setdefault(key, _ServiceState())
            state.fleet = fleet
            state.apply_to_fleet = apply
        self._broker_register(key)

    def _fleet_binding(self, state: _ServiceState):
        """Snapshot ``(fleet, apply_to_fleet)`` under the lock — the
        tick thread reads them while ``attach_fleet`` (main/watch
        thread) rebinds them; a torn read could scrape fleet A and
        apply the decision to fleet B."""
        with self._lock:
            return state.fleet, state.apply_to_fleet

    # --------------------------------------------------------- capacity market
    def _broker_register(self, key: str) -> None:
        """Make the service a bidder on the capacity market (idempotent
        — re-registering would reset the lane's ledger loop). The
        bid/apply/degrade closures run on the BROKER's tick thread and
        touch only the cluster client (its own lock) and the
        ``_price_lock`` leaf — never this autoscaler's lock, so no
        lock-order edge exists between the two control loops."""
        broker = self.broker
        if broker is None:
            return
        name = f"serve/{key}"
        if name in broker.consumers():
            return
        broker.register(
            name,
            lambda: self._serving_bid(key),
            apply_fn=lambda target, reason: self._broker_apply(
                key, target, reason),
            degrade_fn=lambda apply: self._broker_degrade(key, apply))

    def _broker_deregister(self, key: str) -> None:
        if self.broker is not None:
            self.broker.deregister(f"serve/{key}")
        with self._price_lock:
            self._bid_prices.pop(key, None)

    def _serving_bid(self, key: str):
        """The service's standing bid: hold what the spec holds (it
        expresses no future want — growth arrives through the
        ``request_capacity`` gate in ``_execute``), floored at the
        autoscale minimum plus the warm floor so a harvest can never
        cut below what ``warm_floor`` scale-downs already protect.

        With ``spec.broker.priced``, ``marginal_utility`` is the live
        price off the board: SLO fast-burn rate plus queue depth per
        slot, as of this autoscaler's last tick. The broker's victim
        sort already orders equal-priority victims by ascending
        utility, so a burning service keeps its chips while an idle
        equal-priority one is harvested first. Unpriced bids keep the
        static 0.0 — broker decisions for all-static configs are
        byte-identical with or without this feature."""
        from tpu_on_k8s_torch.coordinator.broker import (
            KIND_SERVING, PRIORITY_SERVING, Bid)
        ns, svc_name = key.split("/", 1)
        svc = self.cluster.try_get(InferenceService, ns, svc_name)
        if svc is None:
            return None
        if svc.spec.pools is not None:
            sp = svc.spec.pools.normalized()
            cur = max(int(sp.prefill.replicas), 0) \
                + max(int(sp.decode.replicas), 0)
            floors = [max(p.autoscale.min_replicas, p.autoscale.min_warm)
                      for p in (sp.prefill, sp.decode)
                      if p.autoscale is not None]
            floor = sum(floors) if floors else cur
        else:
            cur = max(int(svc.spec.replicas), 0)
            ap = svc.spec.autoscale
            floor = (max(ap.min_replicas, ap.min_warm)
                     if ap is not None else cur)
        bp = svc.spec.broker
        utility = 0.0
        if bp is not None and bp.priced:
            with self._price_lock:
                price = dict(self._bid_prices.get(key) or ())
            utility = round(price.get("burn", 0.0)
                            + price.get("queue", 0.0), 6)
        return Bid(
            name=f"serve/{key}", kind=KIND_SERVING,
            priority=bp.priority if bp is not None else PRIORITY_SERVING,
            current=cur, desired=cur, floor=min(floor, cur) if cur else 0,
            unit=bp.unit_chips if bp is not None else 1,
            marginal_utility=utility,
            preemption_cost=(bp.preemption_cost if bp is not None
                             else float(cur)))

    def _broker_apply(self, key: str, target_units: int,
                      reason: str) -> bool:
        """Execute a broker-pushed harvest: patch ``spec.replicas``
        down and let the reconciler's drain machinery do the rest. The
        broker never pushes below the bid's floor, and only ever
        harvests a serving lane to feed a HIGHER-priority one."""
        ns, svc_name = key.split("/", 1)

        def mutate(s: InferenceService) -> None:
            if s.spec.pools is not None:
                raise NotFoundError("pooled service: harvest unsupported")
            s.spec.replicas = max(0, int(target_units))
        try:
            self.cluster.update_with_retry(
                InferenceService, ns, svc_name, mutate)
        except NotFoundError:
            return False
        if self.metrics is not None:
            self.metrics.inc("broker_harvests")
        return True

    def _broker_degrade(self, key: str, apply: bool) -> str:
        """The rung-1 pressure valve: flip the service onto a cheaper
        ``DecodePolicy`` variant instead of taking anyone's chips —
        first int8 weights (~half the weight bytes per decode step),
        then deeper speculation when a draft model is configured (more
        accepted tokens per target verify). ``apply=False`` peeks the
        next variant without flipping; '' = nothing left to flip. The
        spec patch rides the same rolling-update machinery as any
        decode-policy edit."""
        ns, svc_name = key.split("/", 1)
        svc = self.cluster.try_get(InferenceService, ns, svc_name)
        if svc is None:
            return ""
        bp = svc.spec.broker
        if bp is not None and not bp.degrade:
            return ""
        dp = (svc.spec.decode or DecodePolicy()).normalized()
        if not dp.int8_weights:
            variant, spec_k = "int8", dp.spec_k
        elif dp.draft_model and dp.spec_k < 8:
            spec_k = min(dp.spec_k * 2, 8)
            variant = f"spec_k:{spec_k}"
        else:
            return ""
        if not apply:
            return variant

        def mutate(s: InferenceService) -> None:
            d = (s.spec.decode or DecodePolicy()).normalized()
            s.spec.decode = DecodePolicy(
                draft_model=d.draft_model, spec_k=spec_k,
                int8_weights=True)
        try:
            self.cluster.update_with_retry(
                InferenceService, ns, svc_name, mutate)
        except NotFoundError:
            return ""
        if self.metrics is not None:
            self.metrics.inc("broker_degrades")
        return variant

    # ------------------------------------------------------------ decision loop
    def run_once(self) -> None:
        with self._lock:
            items = sorted(self._services.items())
        for key, state in items:
            ns, name = key.split("/", 1)
            svc = self.cluster.try_get(InferenceService, ns, name)
            if svc is None or not self._autoscaled(svc):
                if svc is not None:
                    # the service left the autoscaler's care entirely
                    # (autoscale AND slo blocks gone): a lingering
                    # status.slo would be a frozen budget state nobody
                    # will ever update again
                    self._clear_slo_status(svc)
                with self._lock:
                    self._services.pop(key, None)
                self._abandon_loops(state)
                self._broker_deregister(key)
                continue
            try:
                if svc.spec.pools is not None:
                    self._tick_pools(key, svc, state)
                else:
                    self._tick(key, svc, state)
            except NotFoundError:
                continue

    def _tick(self, key: str, svc: InferenceService,
              state: _ServiceState) -> None:
        self._tick_model_slo(key, svc, state)
        if svc.spec.autoscale is None:
            # SLO-only service (``spec.slo`` without ``spec.autoscale``):
            # the tick still scrapes and evaluates — status.slo is the
            # product — but no scaling decision exists to make
            with self._tracer.span("autoscale.tick", svc=key) as sp:
                sample = self._collect(key, svc, state)
                self._tick_slo(key, svc, state, sample, sp)
            return
        self._ensure_policy(svc, state)
        if self.metrics is not None:
            self.metrics.inc("ticks")
        # the kernel template (`controller/loopkernel.py`) drives the
        # observe→decide→commit anatomy and lands one ledger record per
        # decision; the hooks live on _ServiceState above
        state.bind(f"fleetautoscaler/{key}", self.ledger)
        state.bind_owner(self)
        with self._tracer.span("autoscale.tick", svc=key) as sp:
            state.run_tick({"svc": svc, "key": key,
                            "state": state, "span": sp})

    # ------------------------------------------------------------- SLO plane
    @staticmethod
    def _slo_specs(pol) -> List[SLOSpec]:
        """``spec.slo`` (api ``SLOPolicy``) → engine ``SLOSpec``s. The
        api layer's ``normalized()`` already dropped dead objectives, so
        this conversion cannot raise."""
        return [SLOSpec(
            name=o.name, objective=o.objective, target=o.target,
            window_s=o.window_s, fast_short_s=o.fast_short_s,
            fast_long_s=o.fast_long_s, slow_short_s=o.slow_short_s,
            slow_long_s=o.slow_long_s, page_burn=o.page_burn,
            warn_burn=o.warn_burn, hysteresis=o.hysteresis)
            for o in pol.objectives]

    def _clear_slo_status(self, svc: InferenceService) -> None:
        """Blank ``status.slo``: a removed (or normalized-to-nothing)
        policy must not leave a frozen budget state on the CRD — a
        dashboard reading a months-old ``page`` is the exact
        frozen-last-known failure mode the engine's staleness bit
        exists to prevent."""
        if not svc.status.slo:
            return

        def mutate(s: InferenceService) -> None:
            s.status.slo = {}
        try:
            self.cluster.update_with_retry(
                InferenceService, svc.metadata.namespace,
                svc.metadata.name, mutate, subresource="status")
        except NotFoundError:
            pass

    def _ensure_slo(self, key: str, svc: InferenceService,
                    state: _ServiceState) -> bool:
        """(Re)build the service's SLO engine when its ``spec.slo``
        block changes; tear it down — and clear ``status.slo`` — when
        the block is removed or normalizes to zero live objectives.
        Returns whether an engine is live. Window contents do not
        survive a policy edit — stale thresholds interpreting old
        windows would manufacture transitions no event caused."""
        pol = svc.spec.slo
        if pol is None:
            if state.slo_engine is not None or svc.status.slo:
                self._clear_slo_status(svc)
                state.slo_engine = None
                state.slo_key = None
                state.slo_bypass_used = False
                state.slo_written = None
                state.slo_paging = False
                state.slo_live = False
                state.page_up_seq = None
            return False
        norm = pol.normalized()
        skey = tuple(tuple(sorted(vars(o).items()))
                     for o in norm.objectives)
        if state.slo_key != skey:
            state.slo_key = skey
            state.slo_engine = SLOEngine(
                self._slo_specs(norm), clock=self.clock,
                metrics=self.slo_metrics, service=key)
            state.slo_bypass_used = False
            state.slo_written = None
            state.slo_paging = False
            state.slo_live = False
            state.page_up_seq = None
        if not state.slo_engine.evaluators:
            # every objective was junk: nothing will ever evaluate, so
            # any previously-published budget state is dead — clear it
            self._clear_slo_status(svc)
            return False
        return True

    def _feed_slo(self, state: _ServiceState, sample: FleetSample) -> None:
        """One scrape's fresh latency observations into the windows (a
        dead scrape feeds nothing — its absence is what ages the
        windows into staleness)."""
        engine = state.slo_engine
        if engine is None or not sample.ok:
            return
        for kind, values in (("ttft", sample.ttft),
                             ("queue_wait", sample.queue_wait),
                             ("tpot", sample.tpot)):
            for v in values:
                engine.observe_latency(kind, v)

    def _tick_slo(self, key: str, svc: InferenceService,
                  state: _ServiceState, sample: FleetSample,
                  span) -> bool:
        """The SLO half of a tick: feed → evaluate → publish status.slo
        → derive the severity hint. Returns True when a non-stale
        objective is paging AND this page episode has not yet spent its
        one cooldown bypass."""
        if not self._ensure_slo(key, svc, state):
            return False
        self._feed_slo(state, sample)
        return self._evaluate_slo(key, svc, state, span)

    def _evaluate_slo(self, key: str, svc: InferenceService,
                      state: _ServiceState, span) -> bool:
        """Evaluate every objective, publish ``status.slo`` when it
        changed, and return the severity hint (see ``_tick_slo``)."""
        statuses = state.slo_engine.evaluate(span=span)
        burn = max((st.burn_fast for st in statuses.values()
                    if st.burn_fast is not None and not st.stale),
                   default=0.0)
        with self._price_lock:
            self._bid_prices.setdefault(key, {})["burn"] = round(
                max(burn, 0.0), 6)
        rendered = {
            name: SLOObjectiveStatus(
                objective=st.objective, target=st.target, state=st.state,
                burn_fast=(-1.0 if st.burn_fast is None
                           else round(st.burn_fast, 4)),
                burn_slow=(-1.0 if st.burn_slow is None
                           else round(st.burn_slow, 4)),
                budget_remaining=round(st.budget_remaining, 4),
                stale=st.stale)
            for name, st in statuses.items()}
        if rendered != state.slo_written:
            def mutate(s: InferenceService) -> None:
                s.status.slo = rendered
            try:
                self.cluster.update_with_retry(
                    InferenceService, svc.metadata.namespace,
                    svc.metadata.name, mutate, subresource="status")
                state.slo_written = rendered
            except NotFoundError:
                pass
        paging = state.slo_engine.paging(statuses)
        state.slo_live = any(not st.stale for st in statuses.values())
        if paging and not state.slo_paging:
            # paging onset: the episode ordinal is the COUNT of page
            # onsets in the budget log itself, so the ledger's
            # ``slo_page:<svc>#N`` trigger resolves to a real transition
            # line by construction (a resume after a stale gap — no new
            # transition — keeps the original episode's ordinal)
            state.page_episode = len(
                page_onsets(state.slo_engine.event_log)) or 1
        if not paging and state.slo_live \
                and state.page_up_seq is not None:
            # LIVE burn recovery: a non-stale evaluation shows the burn
            # cleared while a page episode is still unanswered (the
            # ``page_up_seq`` marker persists through stale flaps — a
            # signal that merely went dark proves nothing and emits
            # nothing). The event references the scale-up that answered
            # the page — closing its horizon if still open, annotating
            # it otherwise.
            closing = (state.open_horizon is not None
                       and state.open_horizon.seq == state.page_up_seq)
            state.ledger.horizon(state.page_up_seq, loop=state.loop_id,
                                 event=HORIZON_BURN_RECOVERED,
                                 closing=closing)
            if closing:
                state.open_horizon = None
            state.page_up_seq = None
        state.slo_paging = paging
        if not paging:
            state.slo_bypass_used = False   # episode over: re-arm
            return False
        return not state.slo_bypass_used

    # --------------------------------------------------------- per-model SLOs
    def observe_model_latency(self, namespace: str, name: str, model: str,
                              kind: str, seconds: float) -> None:
        """Feed one per-MODEL latency observation (``ttft`` /
        ``queue_wait`` / ``tpot``, seconds) into that model's SLO engine
        — the in-process wiring for multi-model replicas: the pool/twin
        attributes each request to its model and calls this per
        completion. The pod-log scrape plane carries no per-model lines
        yet, so unfed engines age into STALENESS (never zero — the same
        no-data discipline as every other signal here)."""
        key = f"{namespace}/{name}"
        # the engine map AND the engine's windows are guarded by _lock:
        # feeds arrive on caller threads while the tick thread rebuilds
        # the map / evaluates the windows (SLOEngine has no lock of its
        # own)
        with self._lock:
            state = self._services.get(key)
            engine = (state.model_slo.get(model)
                      if state is not None else None)
            if engine is not None:
                engine.observe_latency(kind, seconds)

    def _ensure_model_slo(self, key: str, svc: InferenceService,
                          state: _ServiceState) -> bool:
        """(Re)build the per-model SLO engines when any ref's ``slo``
        block changes — one engine per model carrying objectives, keyed
        ``<service>/<model>`` so the SLO metrics plane labels them
        apart. Same no-carryover rule as the service engine: window
        contents do not survive a policy edit."""
        refs = [m for m in svc.spec.models_normalized()
                if m.slo is not None and m.slo.objectives]
        mkey = tuple(
            (m.name, tuple(tuple(sorted(vars(o).items()))
                           for o in m.slo.objectives))
            for m in refs)
        if state.model_slo_key != mkey:
            engines = {
                m.name: SLOEngine(self._slo_specs(m.slo), clock=self.clock,
                                  metrics=self.slo_metrics,
                                  service=f"{key}/{m.name}")
                for m in refs}
            with self._lock:
                state.model_slo_key = mkey
                state.model_slo = engines
                state.model_slo_written = None
        with self._lock:
            return bool(state.model_slo)

    def _tick_model_slo(self, key: str, svc: InferenceService,
                        state: _ServiceState) -> None:
        """Evaluate every model's objectives and publish them to
        ``status.models[<model>].slo`` — write-on-change, exactly like
        the service-level ``status.slo``. The entry merge is field-
        scoped: the reconciler owns ``image``/``phase``, this tick owns
        ``slo``; neither write clobbers the other's fields."""
        if not self._ensure_model_slo(key, svc, state):
            if state.model_slo_written:
                # per-model SLOs removed: frozen budget states must not
                # linger on the CRD (the model entries themselves stay —
                # they're the reconciler's)
                def clear(s: InferenceService) -> None:
                    for entry in s.status.models.values():
                        entry.slo = {}
                try:
                    self.cluster.update_with_retry(
                        InferenceService, svc.metadata.namespace,
                        svc.metadata.name, clear, subresource="status")
                except NotFoundError:
                    pass
                state.model_slo_written = None
            return
        rendered: Dict[str, Dict[str, SLOObjectiveStatus]] = {}
        with self._lock:
            evaluated = {model: state.model_slo[model].evaluate()
                         for model in sorted(state.model_slo)}
        for model, statuses in evaluated.items():
            rendered[model] = {
                name: SLOObjectiveStatus(
                    objective=st.objective, target=st.target,
                    state=st.state,
                    burn_fast=(-1.0 if st.burn_fast is None
                               else round(st.burn_fast, 4)),
                    burn_slow=(-1.0 if st.burn_slow is None
                               else round(st.burn_slow, 4)),
                    budget_remaining=round(st.budget_remaining, 4),
                    stale=st.stale)
                for name, st in statuses.items()}
        if rendered == state.model_slo_written:
            return

        def mutate(s: InferenceService) -> None:
            for model, slo in rendered.items():
                entry = s.status.models.get(model)
                if entry is None:
                    entry = s.status.models[model] = ModelStatus(name=model)
                entry.slo = slo
        try:
            self.cluster.update_with_retry(
                InferenceService, svc.metadata.namespace,
                svc.metadata.name, mutate, subresource="status")
            state.model_slo_written = rendered
        except NotFoundError:
            pass

    # ------------------------------------------------------------ pool loops
    def _tick_pools(self, key: str, svc: InferenceService,
                    state: _ServiceState) -> None:
        """A disaggregated service runs one decision loop PER POOL —
        queue-wait p95 is the natural SLO for the prefill pool (work
        waiting for a prefill seat), TPOT p95 for the decode pool
        (decode cadence) — each with its own recommender (cooldowns,
        hysteresis, flap damping, slice-legal steps) and its own signal
        window, patching ``spec.pools.<pool>.replicas``. Signals come
        from an attached in-process ``DisaggFleet`` (``pool(name)`` is
        scraped exactly like a fleet); with none attached the window
        goes stale and the policy holds — per-pool log scraping needs
        pool-labelled pods the reconciler does not mint yet."""
        self._tick_model_slo(key, svc, state)
        spec_pools = svc.spec.pools.normalized()
        pools = [p for p in ("prefill", "decode")
                 if getattr(spec_pools, p).autoscale is not None]
        if pools and self.metrics is not None:
            # one tick per service per pass, matching _tick — NOT one
            # per pool, which would make the counter mean different
            # things for pooled vs monolithic services
            self.metrics.inc("ticks")
        # SLO evaluation in pools mode: EVERY pool's scrape feeds the
        # ONE service-level engine (the objectives are service SLOs — a
        # request's TTFT doesn't care which pool served it), evaluated
        # once per pass below. Pools without an autoscale block are
        # scraped too — an SLO-only disagg service must not read as
        # permanently stale just because nothing scales its pools. The
        # page-urgency hint stays a service-loop concern; pool
        # recommenders keep their own SLO targets.
        slo_live = self._ensure_slo(key, svc, state)
        for pool in pools:
            self._tick_one_pool(key, svc, state, pool,
                                getattr(spec_pools, pool))
        if slo_live:
            for pool in ("prefill", "decode"):
                if pool in pools:
                    continue        # its decision tick already fed us
                ps = state.pools.get(pool)
                if ps is None:
                    ps = state.pools[pool] = _PoolState()
                self._feed_slo(state,
                               self._collect_pool(key, state, pool, ps))
            with self._tracer.span("slo.evaluate", svc=key) as sp:
                self._evaluate_slo(key, svc, state, sp)
        if not pools and svc.spec.autoscale is not None:
            # the service registered on its service-level autoscale block,
            # but pools: present hands scaling to the per-pool loops — and
            # neither pool carries one. Without this, migrating a
            # monolithic autoscaled service to disagg while keeping the
            # old block silently stops ALL autoscaling.
            msg = ("pools present: service-level autoscale is ignored; "
                   "set spec.pools.<pool>.autoscale to scale the pools")
            if svc.status.autoscale_message != msg:
                _log.warning("%s for %s", msg, key)

                def mutate(s: InferenceService) -> None:
                    s.status.autoscale_message = msg
                try:
                    self.cluster.update_with_retry(
                        InferenceService, svc.metadata.namespace,
                        svc.metadata.name, mutate, subresource="status")
                except NotFoundError:
                    pass

    def _tick_one_pool(self, key: str, svc: InferenceService,
                       state: _ServiceState, pool: str, pspec) -> None:
        ps = state.pools.get(pool)
        if ps is None:
            ps = state.pools[pool] = _PoolState()
        ap = pspec.autoscale
        pkey = (tuple(sorted(vars(ap).items())),
                svc.spec.gpu_policy.accelerator)
        if ps.policy_key != pkey:
            ps.policy_key = pkey
            ps.recommender = Recommender(
                ap, accelerator=svc.spec.gpu_policy.accelerator)
            ps.aggregator = SignalAggregator(
                window=self.config.autoscale_window_scrapes,
                stale_after=self.config.autoscale_stale_scrapes,
                max_age_s=self._signal_max_age())
        ps.bind(f"fleetautoscaler/{key}/{pool}", self.ledger)
        ps.bind_owner(self)
        with self._tracer.span("autoscale.tick", svc=key, pool=pool) as sp:
            ps.run_tick({"svc": svc, "key": key,
                         "state": state, "pool": pool, "pspec": pspec,
                         "span": sp})

    def _collect_pool(self, key: str, state: _ServiceState, pool: str,
                      ps: _PoolState) -> FleetSample:
        """Pool twin of ``_collect``: scrape the attached fleet's pool
        view; no attached fleet (or a dying one) is an outage — per-pool
        log scraping needs pool-labelled pods the reconciler does not
        mint yet."""
        ps.seq += 1
        ps.tick_chaos_seq = 0
        fault, fault_seq = chaos.fire_seq(chaos.SITE_AUTOSCALE_SIGNAL,
                                          service=key, pool=pool)
        if isinstance(fault, chaos.SignalOutage):
            # the ledger's fault join key: THIS injection's event seq
            # (allocated atomically — a concurrent thread's fault can
            # never be cited by mistake)
            ps.tick_chaos_seq = fault_seq
        fleet, _ = self._fleet_binding(state)
        if not isinstance(fault, chaos.SignalOutage) \
                and fleet is not None and hasattr(fleet, "pool"):
            try:
                return ps.scraper.scrape(fleet.pool(pool), seq=ps.seq)
            # analyze: allow[silent-loss] falls through to the stale_scrapes counter + dead_sample — the outage IS counted
            except Exception:  # noqa: BLE001 — a dying fleet is an outage
                pass
        if self.metrics is not None:
            self.metrics.inc("stale_scrapes")
        return dead_sample(ps.seq)

    # ------------------------------------------------------------- execution
    def _execute(self, key: str, svc: InferenceService,
                 state: _ServiceState, recommender: Recommender,
                 decision, now: float, *, pool: Optional[str] = None
                 ) -> str:
        """The committed half of a decision loop, shared by the service
        and per-pool paths: patch the spec — the commit point, so chaos
        (and real conflicts) before it mean the scale never happened and
        no cooldown is burned; next tick retries at full speed — then
        commit cooldown stamps, publish status + event, and apply to an
        attached in-process fleet. Returns the `obs/ledger` commit
        outcome: ``landed``, ``conflict:<Type>`` (the patch never
        happened), or ``fallback:<Type>`` (the patch landed but the
        in-process fleet apply deferred to the reconciler)."""
        label = key if pool is None else f"{key}/{pool}"
        scope = ((("svc", key),) if pool is None
                 else (("svc", key), ("pool", pool)))
        if self.broker is not None and decision.action == ACTION_UP:
            # the capacity market gate: ask BEFORE the patch, from the
            # same pre-commit position as a chaos fault — a refusal
            # means the scale never happened, no cooldown is burned
            # (``recommender.commit`` below never runs), and the
            # broker's pressure ladder (degrade → harvest → preempt)
            # works the shortfall so next tick's retry can land
            if not self.broker.request_capacity(
                    f"serve/{key}", decision.current, decision.target,
                    urgent=decision.reason.startswith("slo_page"),
                    trigger=(f"slo_page:{key}#{state.page_episode}"
                             if state.slo_paging else "")):
                self.decision_log.append(format_commit_failure_line(
                    decision.seq, "BrokerRefused", scope=scope))
                if self.metrics is not None:
                    self.metrics.inc("patch_failures")
                _log.warning("broker refused %s scale %d -> %d", label,
                             decision.current, decision.target)
                return "conflict:BrokerRefused"
        fault = chaos.fire(chaos.SITE_AUTOSCALE_PATCH, service=label,
                           target=decision.target)
        try:
            if fault is not None:
                raise fault.to_exception()

            def mutate(s: InferenceService) -> None:
                if pool is None:
                    s.spec.replicas = decision.target
                elif s.spec.pools is None:
                    raise NotFoundError("pools block removed")
                else:
                    getattr(s.spec.pools, pool).replicas = decision.target

            self.cluster.update_with_retry(
                InferenceService, svc.metadata.namespace,
                svc.metadata.name, mutate)
        except Exception as e:  # noqa: BLE001 — typed below, loop survives
            self.decision_log.append(format_commit_failure_line(
                decision.seq, type(e).__name__, scope=scope))
            if self.metrics is not None:
                self.metrics.inc("patch_failures")
            _log.warning("replicas patch for %s failed: %s", label, e)
            return f"conflict:{type(e).__name__}"
        recommender.commit(decision, now)
        if self.metrics is not None:
            # the gauge tracks COMMITTED targets only — set after the
            # patch lands, so a failed write never reports a phantom
            # pending scale
            self.metrics.set_gauge("desired_replicas", decision.target,
                                   label=label)

        def mutate_status(s: InferenceService) -> None:
            if pool is None:
                s.status.desired_replicas = decision.target
                s.status.autoscale_message = (
                    f"{decision.action} {decision.current}->"
                    f"{decision.target}: {decision.reason}")
            else:
                s.status.pool_desired_replicas[pool] = decision.target
                s.status.autoscale_message = (
                    f"{pool}: {decision.action} {decision.current}->"
                    f"{decision.target}: {decision.reason}")
        try:
            self.cluster.update_with_retry(
                InferenceService, svc.metadata.namespace,
                svc.metadata.name, mutate_status, subresource="status")
        except NotFoundError:
            pass
        self.cluster.record_event(
            svc, "Normal",
            "AutoscaleReplicas" if pool is None else "AutoscalePoolReplicas",
            ("fleet autoscaler" if pool is None
             else f"fleet autoscaler[{pool}]")
            + f": {decision.current} -> {decision.target} "
            f"({decision.reason})")
        fleet, apply_to_fleet = self._fleet_binding(state)
        if fleet is not None and apply_to_fleet:
            try:
                if pool is None:
                    fleet.scale_to(decision.target)
                else:
                    fleet.scale_pool(pool, decision.target)
            except (RuntimeError, ValueError) as e:
                # a rollout owns desired_replicas right now; the spec
                # patch stands and the reconciler/fleet converge later
                _log.warning("fleet apply for %s (-> %d) deferred: %s",
                             label, decision.target, e)
                return f"fallback:{type(e).__name__}"
        return COMMIT_LANDED

    # --------------------------------------------------------------- signals
    def _signal_max_age(self) -> Optional[float]:
        """Scrape-sample age bound for the aggregators: the configured
        value, a derived default (stale_scrapes worth of tick periods —
        time-staleness engages exactly when count-staleness would have,
        had the ticks kept coming), or None (negative config) to
        disable aging."""
        cfg = self.config.autoscale_signal_max_age_s
        if cfg < 0:
            return None
        if cfg > 0:
            return cfg
        return (self.config.autoscale_stale_scrapes
                * self.config.serving_autoscale_period_seconds)

    def _ensure_policy(self, svc: InferenceService,
                       state: _ServiceState) -> None:
        """(Re)build the recommender/aggregator when the service's
        autoscale block changes — edits apply next tick, but cooldown
        stamps survive an unchanged policy."""
        ap = svc.spec.autoscale
        pkey = (tuple(sorted(vars(ap).items())),
                svc.spec.gpu_policy.accelerator)
        if state.policy_key == pkey:
            return
        state.policy_key = pkey
        state.recommender = Recommender(
            ap, accelerator=svc.spec.gpu_policy.accelerator)
        state.aggregator = SignalAggregator(
            window=self.config.autoscale_window_scrapes,
            stale_after=self.config.autoscale_stale_scrapes,
            max_age_s=self._signal_max_age())

    def _collect(self, key: str, svc: InferenceService,
                 state: _ServiceState) -> FleetSample:
        state.seq += 1   # one monotone counter: dead scrapes count too
        state.tick_chaos_seq = 0
        fault, fault_seq = chaos.fire_seq(chaos.SITE_AUTOSCALE_SIGNAL,
                                          service=key)
        if isinstance(fault, chaos.SignalOutage):
            # THIS injection's event seq (atomic): the decision made
            # under this outage carries a ``chaos#N`` ledger trigger
            state.tick_chaos_seq = fault_seq
            if self.metrics is not None:
                self.metrics.inc("stale_scrapes")
            return dead_sample(state.seq)
        fleet, _ = self._fleet_binding(state)
        if fleet is not None:
            try:
                return state.scraper.scrape(fleet, seq=state.seq)
            # (no allow needed: the handler touches the stale_scrapes
            # counter, which silent-loss accepts as accounting)
            except Exception:  # noqa: BLE001 — a dying fleet is an outage
                if self.metrics is not None:
                    self.metrics.inc("stale_scrapes")
                return dead_sample(state.seq)
        return self._scrape_logs(svc, state)

    def _scrape_logs(self, svc: InferenceService,
                     state: _ServiceState) -> FleetSample:
        """The CRD-plane signal source: tail every replica pod's log for
        observation lines strictly newer than that POD's watermark
        (``batch=`` is the emitter's own step counter — monotone per
        pod, so each line is consumed exactly once; pods start their
        counters independently, so the watermark must be per pod). Each
        pod contributes its newest unseen line; the per-pod samples
        merge into one fleet sample (latencies concatenate, load gauges
        sum). No pod with a new line = a dead scrape: the fleet may be
        gone, or just quiet — staleness, not zero."""
        pods = self.cluster.list(
            Pod, svc.metadata.namespace,
            {constants.LABEL_INFERENCESERVICE_NAME: svc.metadata.name})
        merged: List[FleetSample] = []
        listed = set()
        for pod in sorted(pods, key=lambda p: p.metadata.name):
            listed.add(pod.metadata.name)
            try:
                lines = self.cluster.read_pod_log(
                    pod.metadata.namespace, pod.metadata.name,
                    tail=self.config.autoscale_log_tail)
            except NotFoundError:
                continue
            # newest observation line in the tail = the LAST parseable
            # one (the tail is chronological; the batch counter is NOT
            # globally monotone — it resets when the container restarts)
            newest = -1
            newest_sample = None
            for line in lines:
                mark = line_watermark(line)
                if mark is None:
                    continue
                sample = sample_from_line(line, state.seq)
                if sample is not None:
                    newest, newest_sample = mark, sample
            seen = state.watermark.get(pod.metadata.name, -1)
            # newest > seen: fresh data. newest < seen (but exists): the
            # emitter RESTARTED and its step counter reset — re-anchor
            # instead of going blind until it re-passes the old mark
            # (the log-plane twin of FleetScraper's total<n reset).
            # newest == seen: quiet pod, nothing new.
            if newest_sample is not None and newest != seen:
                state.watermark[pod.metadata.name] = newest
                merged.append(newest_sample)
        # prune departed pods (rollouts mint fresh names every cycle —
        # dead entries both leak and hold poisoned marks for any future
        # pod that reuses the name)
        for name in list(state.watermark):
            if name not in listed:
                del state.watermark[name]
        if not merged:
            if self.metrics is not None:
                self.metrics.inc("stale_scrapes")
            return dead_sample(state.seq)
        return FleetSample(
            seq=state.seq,
            ttft=tuple(v for s in merged for v in s.ttft),
            queue_wait=tuple(v for s in merged for v in s.queue_wait),
            tpot=tuple(v for s in merged for v in s.tpot),
            queue_depth=sum(s.queue_depth for s in merged),
            inflight_tokens=sum(s.inflight_tokens for s in merged),
            slots=sum(s.slots for s in merged),
            ready_replicas=sum(s.ready_replicas for s in merged))

    # ------------------------------------------------------------- recording
    def _record(self, key: str, svc: InferenceService, obs,
                decision, *, pool: Optional[str] = None) -> None:
        """One decision recorded: a stable decision-log line plus the
        observed/decided gauge set — labelled ``ns/name`` for the
        service loop, ``ns/name/pool`` for a pool loop; both export the
        full signal set (every observed gauge is a valid policy input on
        either loop)."""
        label = key if pool is None else f"{key}/{pool}"
        if pool is None:
            # queue pressure per serving slot: the second term of the
            # priced bid's marginal utility (see _serving_bid)
            with self._price_lock:
                self._bid_prices.setdefault(key, {})["queue"] = round(
                    obs.queue_depth / max(obs.slots, 1), 6)
        self.decision_log.append(
            (f"svc={key} " if pool is None else f"svc={key} pool={pool} ")
            + decision.line())
        m = self.metrics
        if m is None:
            return
        m.decision(decision.action)
        if decision.target == decision.current:
            # holds confirm the current size; executed scales update the
            # gauge only once the patch commits (see _execute)
            m.set_gauge("desired_replicas", decision.target, label=label)
        m.set_gauge("current_replicas", decision.current, label=label)
        m.set_gauge("signal_stale", float(obs.stale), label=label)
        if obs.ttft_p95 is not None:
            m.set_gauge("observed_ttft_p95", obs.ttft_p95, label=label)
        if obs.queue_wait_p95 is not None:
            m.set_gauge("observed_queue_wait_p95", obs.queue_wait_p95,
                        label=label)
        if obs.tpot_p95 is not None:
            m.set_gauge("observed_tpot_p95", obs.tpot_p95, label=label)
        m.set_gauge("observed_queue_depth", obs.queue_depth, label=label)
        if obs.tokens_per_slot is not None:
            m.set_gauge("observed_tokens_per_slot", obs.tokens_per_slot,
                        label=label)

    def slo_event_lines(self) -> Dict[str, List[str]]:
        """Per-service SLO budget event logs (the transition lines
        `obs/slo.SLOEngine` appends): what ``--ledger-out`` embeds
        beside the decision records so `tools/why_report.py` can
        resolve ``slo_page:<svc>#N`` triggers to their actual
        ``state=...->page`` transition lines."""
        with self._lock:
            items = sorted(self._services.items())
        out: Dict[str, List[str]] = {}
        for key, state in items:
            engine = state.slo_engine
            if engine is not None and engine.event_log:
                out[key] = list(engine.event_log)
        return out

    # ----------------------------------------------------------------- run loop
    def run(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop() -> None:
            while not self._stop.is_set():
                try:
                    self.run_once()
                except Exception:
                    # same discipline as the elastic loop: a crashing
                    # tick surfaces in the log, never dies silently —
                    # under its own counter, not patch_failures (a
                    # scrape/status/policy crash is not an API write
                    # failure)
                    _log.exception("fleet autoscaler tick failed")
                    if self.metrics is not None:
                        self.metrics.inc("tick_errors")
                self._stop.wait(self.config.serving_autoscale_period_seconds)

        t = threading.Thread(target=loop, daemon=True,
                             name="fleet-autoscaler")
        t.start()
        self._thread = t

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2)


def setup_fleet_autoscaler(cluster: InMemoryCluster,
                           config: Optional[JobControllerConfig] = None,
                           metrics: Optional[AutoscaleMetrics] = None,
                           clock: Callable[[], float] = time.monotonic,
                           tracer=None,
                           slo_metrics=None,
                           ledger=None,
                           broker=None) -> FleetAutoscaler:
    """Wire the autoscaler's service registry to the cluster watch (the
    serving twin of ``setup_elastic_autoscaler``)."""
    scaler = FleetAutoscaler(cluster, config=config, metrics=metrics,
                             clock=clock, tracer=tracer,
                             slo_metrics=slo_metrics, ledger=ledger,
                             broker=broker)
    cluster.watch(scaler.observe_event)
    return scaler
