"""Capacity broker: one slice market, every control loop a bidder (the
counterpart of ``tpu_on_k8s/coordinator/broker.py``).

Five loops close independently — the ElasticAutoscaler over TorchJobs, the
FleetAutoscaler over InferenceServices (service + per-pool recommenders),
and the SLO-paged scale-ups riding them — and until now nothing
arbitrated when the cluster was full: a serving burst and an elastic
training job could deadlock on the same slices with no ledgered
resolution. The broker is that arbiter, built as one more
`controller/loopkernel.LoopKernel` loop so every grant, preemption,
refusal, and degrade lands on the same `obs/ledger.DecisionLedger` and
`tools/why_report.py` can answer "who took my chips".

**The market.** Every consumer registers a ``bid_fn`` returning a
:class:`Bid` — priority, current grant, desired grant, un-harvestable
floor, chips per allocation unit, marginal utility, and preemption cost
(the allocation shape from "An Optimal Resource Allocator of Elastic
Training", PAPERS.md). Two consumer styles:

* **self-scaling** (serving fleets, elastic training): they execute
  their own patches and PULL admission through the synchronous
  :meth:`CapacityBroker.request_capacity` gate *before* patching. A
  grant reserves the chips until the consumer's bid reflects them; a
  refusal registers a pressure episode the tick loop works to relieve.
  The refused caller ledgers ``conflict:BrokerRefused`` on its own loop
  and — by construction, because the gate sits before the patch — burns
  no cooldown (the same no-burn rule as a failed patch).
* **broker-managed** (the batch/offline inference lane, a `min_warm`
  headroom lane): the broker PUSHes both growth (the fill phase grants
  them idle chips) and shrink (harvest) through their ``apply_fn``.

**The escalation ladder.** Under pressure (a refused request), each
tick climbs, in order: (1) *degrade-before-take* — flip the pressured
fleet to a cheaper `DecodePolicy` variant (int8, lower spec_k; Rubick's
reconfigurability argument, PAPERS.md) once per episode; (2) *harvest*
the batch/warm lanes — they yield within one tick of a page; (3)
*shrink* elastic training toward its floor via live reshard (abort ⇒
checkpoint-restart, never corruption); (4) only
then *refuse* with a typed, ledgered reason. Freed capacity is granted
two-phase: victims shrink this tick, the requester's grant lands when
its next ``request_capacity`` sees the freed chips in the victims'
bids — the broker never promises chips that are still occupied.

Every lane transition opens an effect horizon (closed when the lane's
bid reflects the committed target) and the grant/apply path is
chaos-injectable at ``SITE_BROKER_GRANT`` (stale-bid and write-conflict
faults): a faulted apply rejects the WHOLE transition — no partial
apply, the reservation is dropped, and the market re-clears from fresh
bids next tick.

Deterministic by construction: clearing iterates sorted names, takes no
wall clock (the tick period comes from the caller's scheduler), and the
twin drives ``run_once`` from its virtual clock — two seeded runs
produce byte-identical ledgers.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.autoscale.policy import ACTION_DOWN, ACTION_UP, Decision
from tpu_on_k8s_torch.controller.loopkernel import (
    ACTION_HOLD,
    LoopKernel,
    OpenHorizon,
    format_commit_failure_line,
    format_decision_line,
)
from tpu_on_k8s_torch.obs.ledger import (
    COMMIT_LANDED,
    HORIZON_REPLICAS_READY,
    HORIZON_ROLLOUT_COMPLETE,
)

_log = logging.getLogger(__name__)

#: lane action for the degrade-before-take pressure valve (rung 1):
#: the lane keeps its chips but flips to a cheaper DecodePolicy variant
ACTION_DEGRADE = "degrade"

#: consumer kinds (victim reasons distinguish harvest vs preempt by kind)
KIND_SERVING = "serving"
KIND_TRAINING = "training"
KIND_BATCH = "batch"
KIND_WARM = "warm"

#: default priorities — strict ordering, higher outbids lower
PRIORITY_SERVING = 100
PRIORITY_WARM = 80
PRIORITY_TRAINING = 50
PRIORITY_BATCH = 10


@dataclasses.dataclass(frozen=True)
class Bid:
    """One consumer's standing bid. ``current``/``desired``/``floor``
    are in allocation units (replicas, hosts, batch slots); ``unit`` is
    chips per allocation unit — the market clears in chips but moves
    whole units. ``floor`` units can never be harvested (a training
    job's minimum gang, a fleet's min_replicas). ``marginal_utility``
    and ``preemption_cost`` break ties among equal-priority victims:
    the cheapest-to-preempt, least-useful chip goes first."""

    name: str
    kind: str
    priority: int
    current: int
    desired: int
    floor: int = 0
    unit: int = 1
    marginal_utility: float = 0.0
    preemption_cost: float = 0.0


@dataclasses.dataclass
class _Grant:
    """A reservation from `request_capacity`: chips promised to a
    self-scaling consumer whose bid does not yet reflect them. Retired
    when the bid catches up; revoked (ledgered) when it never does."""

    target_units: int
    trigger: str = ""
    urgent: bool = False
    ledgered: bool = False
    ticks: int = 0
    #: the lane's holding when the grant was admitted — what the
    #: announcement's ``grant:+N`` delta is measured from
    base_units: int = 0


@dataclasses.dataclass
class _Pressure:
    """One refused requester's open pressure episode: how many more
    units it wanted, whether an SLO page backs it, the trigger string
    its preemptions inherit, and the ladder state (``degraded`` — rung
    1 fires once per episode). ``fresh`` is re-armed by every refused
    request; an episode nobody refreshes lapses instead of preempting
    on behalf of a requester that stopped asking."""

    units: int
    urgent: bool = False
    trigger: str = ""
    degraded: bool = False
    ticks: int = 0
    idle: int = 0
    fresh: bool = True


@dataclasses.dataclass
class _LanePack:
    """One lane's cleared allocation for this tick. ``apply`` marks
    transitions the broker itself must push through the consumer's
    ``apply_fn``/``degrade_fn`` (harvest, fill, degrade); grant
    announcements are acknowledgements of a patch the requester
    executes itself."""

    bid: Bid
    action: str
    target: int
    reason: str
    trigger: str = ""
    apply: bool = False


@dataclasses.dataclass
class _Consumer:
    name: str
    bid_fn: Callable[[], Optional[Bid]]
    apply_fn: Optional[Callable[[int, str], bool]] = None
    degrade_fn: Optional[Callable[[bool], str]] = None
    managed: bool = False
    lane: Optional["_LaneState"] = None


class _LaneState(LoopKernel):
    """One consumer's slice of the market, as a LoopKernel: the broker
    clears the whole market in ``run_once`` and then drives one tick
    per lane, so every lane transition is one ledger record on loop
    ``broker/<consumer>`` with the standard horizon machinery. Lane
    state is touched ONLY by the broker tick (single thread): the
    synchronous admission gate never writes here — grants are announced
    on the next tick."""

    owner: Optional["CapacityBroker"] = None
    consumer: Optional[_Consumer] = None

    def observe(self, ctx):
        self.seq += 1
        return ctx["pack"]

    def decide(self, pack, ctx):
        decision = Decision(self.seq, pack.action, pack.bid.current,
                            pack.target, pack.reason)
        return decision

    def actionable(self, decision, ctx) -> bool:
        if ctx["pack"].apply:
            return True
        return super().actionable(decision, ctx)

    def commit(self, pack, decision, ctx) -> str:
        c = self.consumer
        fault, fseq = chaos.fire_seq(chaos.SITE_BROKER_GRANT,
                                     consumer=c.name,
                                     action=decision.action,
                                     target=decision.target)
        if fault is not None:
            ctx["chaos_seq"] = fseq
            failure = type(fault.to_exception()).__name__
            self.owner._lane_failed(c.name, decision, failure)
            return f"conflict:{failure}"
        if decision.action == ACTION_UP and not pack.apply:
            # grant acknowledgement: the requester executes its own
            # patch — the broker's commit is the reservation itself
            self.owner._grant_ledgered(c.name)
            return COMMIT_LANDED
        if decision.action == ACTION_DEGRADE:
            variant = c.degrade_fn(True) if c.degrade_fn is not None else ""
            if not variant:
                self.owner._lane_failed(c.name, decision,
                                        "DegradeExhausted")
                return "conflict:DegradeExhausted"
            return COMMIT_LANDED
        ok = bool(c.apply_fn(decision.target, decision.reason)) \
            if c.apply_fn is not None else False
        if not ok:
            self.owner._lane_failed(c.name, decision, "ApplyFailed")
            return "conflict:ApplyFailed"
        return COMMIT_LANDED

    def record(self, pack, decision, ctx) -> None:
        self.owner._record_lane(self.consumer.name, decision)

    def tick_of(self, pack) -> int:
        return self.seq

    def trigger_of(self, pack, ctx) -> str:
        fseq = ctx.get("chaos_seq")
        if fseq:
            return f"chaos#{fseq}"
        return pack.trigger

    def signals_of(self, pack) -> Tuple[Tuple[str, str], ...]:
        b = pack.bid
        return (("priority", str(b.priority)),
                ("desired", str(b.desired)),
                ("unit", str(b.unit)))

    def horizon_events(self, horizon: OpenHorizon, pack, ctx):
        if horizon.action == ACTION_DEGRADE:
            # the policy flip is pushed synchronously at commit; the
            # next observed tick proves the lane survived it
            return ((HORIZON_ROLLOUT_COMPLETE, True),)
        if horizon.action == ACTION_UP \
                and pack.bid.current >= horizon.target:
            return ((HORIZON_REPLICAS_READY, True),)
        if horizon.action == ACTION_DOWN \
                and pack.bid.current <= horizon.target:
            return ((HORIZON_REPLICAS_READY, True),)
        return ()


class CapacityBroker:
    """The slice market (see module doc). ``capacity_chips`` is the one
    budget every consumer bids against; ``<= 0`` disables arbitration
    (every request admitted, no lanes ticked — the pre-broker
    behavior). ``metrics`` is an optional `metrics.BrokerMetrics`."""

    def __init__(self, capacity_chips: int, *, ledger=None, metrics=None,
                 period_s: float = 10.0, max_pressure_ticks: int = 8,
                 max_grant_ticks: int = 8) -> None:
        self.capacity = capacity_chips
        self.ledger = ledger
        self.metrics = metrics
        self.period_s = period_s
        self.max_pressure_ticks = max_pressure_ticks
        self.max_grant_ticks = max_grant_ticks
        self.tick = 0
        self.tick_errors = 0
        #: the broker's own decision log — one `format_decision_line`
        #: per lane tick (scope ``lane=<consumer>``), byte-compared across
        #: seeded runs
        self.decision_log: List[str] = []
        self._lock = threading.Lock()
        self._consumers: Dict[str, _Consumer] = {}
        self._grants: Dict[str, _Grant] = {}
        self._pressure: Dict[str, _Pressure] = {}
        self._last_bids: Dict[str, Bid] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- registration
    def register(self, name: str, bid_fn: Callable[[], Optional[Bid]], *,
                 apply_fn: Optional[Callable[[int, str], bool]] = None,
                 degrade_fn: Optional[Callable[[bool], str]] = None,
                 managed: bool = False) -> None:
        """Register a consumer. ``bid_fn`` returns the lane's standing
        :class:`Bid` (None = not participating this tick). ``apply_fn
        (target_units, reason) -> bool`` executes a broker-pushed
        resize (harvest always; growth too when ``managed``).
        ``degrade_fn(apply) -> variant`` is the rung-1 valve: with
        ``apply=False`` it peeks the next cheaper variant without
        flipping; with ``apply=True`` it flips and returns the variant
        ('' when nothing is left to flip)."""
        lane = _LaneState(f"broker/{name}", ledger=self.ledger)
        lane.owner = self
        c = _Consumer(name=name, bid_fn=bid_fn, apply_fn=apply_fn,
                      degrade_fn=degrade_fn, managed=managed, lane=lane)
        lane.consumer = c
        with self._lock:
            self._consumers[name] = c

    def deregister(self, name: str) -> None:
        with self._lock:
            c = self._consumers.pop(name, None)
            self._grants.pop(name, None)
            self._pressure.pop(name, None)
            self._last_bids.pop(name, None)
        if c is not None and c.lane is not None:
            c.lane.abandon()

    def consumers(self) -> List[str]:
        with self._lock:
            return sorted(self._consumers)

    # ------------------------------------------------------- admission gate
    def request_capacity(self, name: str, current: int, target: int, *,
                         urgent: bool = False, trigger: str = "") -> bool:
        """The synchronous admission gate self-scaling consumers call
        BEFORE patching a scale-up. True = admitted (the chips are
        reserved until the consumer's bid reflects them); False =
        refused — the caller must not patch (and must not burn a
        cooldown), and a pressure episode now works the escalation
        ladder on its behalf. Unregistered consumers and shrinks are
        always admitted (opt-in semantics). ``trigger`` is the caller's
        provenance ref (``slo_page:<svc>#N``) — every preemption made
        on this requester's behalf inherits it, so `why_report`
        resolves the eviction to its cause."""
        if self.capacity <= 0 or target <= current:
            return True
        with self._lock:
            if name not in self._consumers:
                return True
            # delta semantics: the caller's (current, target) may be a
            # sub-view of the lane (a pool of a disaggregated service);
            # the request is for `target - current` MORE units on top of
            # whatever the lane's bid already holds
            b = self._last_bids.get(name)
            unit = b.unit if b is not None else 1
            base = b.current if b is not None else current
            expected = base + (target - current)
            g = self._grants.get(name)
            if g is not None and g.target_units >= expected:
                return True                       # already reserved
            held = max(base, g.target_units) if g is not None else base
            free = self.capacity - self._used_chips_locked()
            if (expected - held) * unit <= free:
                self._grants[name] = _Grant(target_units=expected,
                                            trigger=trigger, urgent=urgent,
                                            base_units=held)
                self._pressure.pop(name, None)
                self._inc("grants")
                return True
            p = self._pressure.get(name)
            units = expected - held
            if p is None:
                self._pressure[name] = _Pressure(
                    units=units, urgent=urgent, trigger=trigger)
            else:
                p.units = max(p.units, units)
                p.urgent = p.urgent or urgent
                p.trigger = trigger or p.trigger
                p.fresh = True
            self._inc("refusals")
            return False

    # ------------------------------------------------------------ the tick
    def run_once(self) -> None:
        """One market clearing: gather bids, work the pressure ladder,
        fill idle capacity into managed lanes, then drive one
        LoopKernel tick per lane. Consumer callbacks (bids, degrade
        peeks, applies) all run OUTSIDE the broker lock."""
        if self.capacity <= 0:
            return
        with self._lock:
            consumers = [self._consumers[k] for k in sorted(self._consumers)]
        bids: Dict[str, Bid] = {}
        for c in consumers:
            b = c.bid_fn()
            if b is not None:
                bids[c.name] = b
        with self._lock:
            self.tick += 1
            self._last_bids = dict(bids)
            plan, degrades, expired = self._clear_locked(bids)
            free = self.capacity - self._used_chips_locked()
            n_pressure = len(self._pressure)
        for name, trigger in degrades:
            c = self._consumer(name)
            variant = c.degrade_fn(False) \
                if c is not None and c.degrade_fn is not None else ""
            if variant:
                b = bids[name]
                plan[name] = _LanePack(
                    bid=b, action=ACTION_DEGRADE, target=b.current,
                    reason=f"degrade:{variant}", trigger=trigger,
                    apply=True)
        for c in consumers:
            pack = plan.get(c.name)
            if pack is None or c.lane is None:
                continue
            if c.name in expired:
                c.lane.abandon()
            c.lane.run_tick({"pack": pack})
        self._set_gauge("free_chips", max(0, free))
        self._set_gauge("pressure_lanes", n_pressure)
        self._set_gauge("capacity_chips", self.capacity)

    def run(self) -> threading.Thread:
        """Start the broker's tick thread (daemon — same lifecycle
        pattern as the autoscalers)."""
        t = threading.Thread(target=self._run, name="capacity-broker",
                             daemon=True)
        self._thread = t
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2)

    def tick_count(self) -> int:
        """Clearings run so far — locked so readers on other threads
        (the twin summary, dashboards) never race the tick."""
        with self._lock:
            return self.tick

    def decision_lines(self) -> List[str]:
        """A point-in-time copy of the broker's decision log, locked
        against concurrent lane commits."""
        with self._lock:
            return list(self.decision_log)

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.run_once()
            except Exception:
                # same discipline as the autoscaler loops: a crashing
                # clearing surfaces in the log AND a counter, never
                # dies silently
                _log.exception("capacity broker tick failed")
                self.tick_errors += 1
                if self.metrics is not None:
                    self.metrics.inc("tick_errors")

    # ------------------------------------------------------------- clearing
    def _clear_locked(self, bids: Dict[str, Bid]):
        """Pure clearing under the lock: no consumer code runs here.
        Returns (lane packs, degrade candidates, lanes whose expired
        grant horizon must be abandoned)."""
        plan: Dict[str, _LanePack] = {}
        degrades: List[Tuple[str, str]] = []
        expired: Set[str] = set()
        for name in sorted(bids):
            b = bids[name]
            plan[name] = _LanePack(bid=b, action=ACTION_HOLD,
                                   target=b.current, reason="steady")
        self._advance_grants_locked(bids, plan, expired)
        free = self.capacity - self._used_chips_locked()
        free_remaining = max(0, free)
        cuts: Dict[str, int] = {}
        order = sorted(
            self._pressure,
            key=lambda n: (-int(self._pressure[n].urgent),
                           -(bids[n].priority if n in bids else 0), n))
        for name in order:
            free_remaining = self._ladder_locked(
                name, bids, plan, degrades, cuts, free_remaining)
        if not self._pressure and free_remaining > 0:
            self._fill_locked(bids, plan, cuts, free_remaining)
        return plan, degrades, expired

    def _advance_grants_locked(self, bids, plan, expired) -> None:
        for name in sorted(self._grants):
            g = self._grants[name]
            b = bids.get(name)
            if b is None:
                continue                   # not bidding yet — hold the chips
            if b.current >= g.target_units:
                del self._grants[name]     # satisfied: the bid carries it now
                if not g.ledgered:
                    # the requester scaled into its grant before the
                    # lane could announce it — still land one ledgered
                    # acknowledgment, so "who got the chips" always has
                    # a record carrying the requester's trigger
                    plan[name] = _LanePack(
                        bid=b, action=ACTION_UP, target=g.target_units,
                        reason=(f"grant:"
                                f"+{g.target_units - g.base_units}"),
                        trigger=g.trigger)
                continue
            if not g.ledgered:
                plan[name] = _LanePack(
                    bid=b, action=ACTION_UP, target=g.target_units,
                    reason=f"grant:+{g.target_units - b.current}",
                    trigger=g.trigger)
                continue
            g.ticks += 1
            if g.ticks > self.max_grant_ticks:
                # the requester never scaled into its reservation (its
                # patch lost, the object vanished): release the chips
                del self._grants[name]
                expired.add(name)
                self._inc("grant_expired")
                plan[name] = _LanePack(bid=b, action=ACTION_HOLD,
                                       target=b.current,
                                       reason="grant_expired")

    def _ladder_locked(self, name, bids, plan, degrades, cuts,
                       free_remaining: int) -> int:
        """One pressure episode's tick of the escalation ladder:
        degrade → harvest → shrink → refuse. Returns the free chips
        left unclaimed for lower-priority episodes."""
        p = self._pressure[name]
        b = bids.get(name)
        if b is None:
            del self._pressure[name]
            return free_remaining
        if p.fresh:
            p.fresh = False
            p.idle = 0
        else:
            p.idle += 1
            if p.idle >= 2:
                # the requester stopped asking (burst over, degrade
                # worked): lapse quietly rather than evict for nobody
                del self._pressure[name]
                plan[name] = _LanePack(bid=b, action=ACTION_HOLD,
                                       target=b.current,
                                       reason="pressure_lapsed",
                                       trigger=p.trigger)
                return free_remaining
        p.ticks += 1
        needed = p.units * b.unit
        if needed <= free_remaining:
            del self._pressure[name]
            plan[name] = _LanePack(bid=b, action=ACTION_HOLD,
                                   target=b.current,
                                   reason="pressure_relieved",
                                   trigger=p.trigger)
            return free_remaining - needed
        if p.ticks > self.max_pressure_ticks:
            del self._pressure[name]
            plan[name] = _LanePack(
                bid=b, action=ACTION_HOLD, target=b.current,
                reason=f"refuse:pressure_timeout need={p.units}",
                trigger=p.trigger)
            self._inc("refuse_final")
            return free_remaining
        want_degrade = False
        if not p.degraded:
            c = self._consumers.get(name)
            if c is not None and c.degrade_fn is not None:
                p.degraded = True
                want_degrade = True
                degrades.append((name, p.trigger))
                self._inc("degrades")
        shortfall = needed - free_remaining
        victims = [v for v in sorted(bids)
                   if v != name and bids[v].priority < b.priority
                   and v not in self._pressure and v not in self._grants]
        victims.sort(key=lambda v: (bids[v].priority,
                                    bids[v].preemption_cost,
                                    bids[v].marginal_utility, v))
        planned: List[Tuple[str, int]] = []
        remaining = shortfall
        for v in victims:
            if remaining <= 0:
                break
            vb = bids[v]
            avail = vb.current - max(vb.floor, 0) - cuts.get(v, 0)
            if avail <= 0:
                continue
            take = min(avail, -(-remaining // vb.unit))
            planned.append((v, take))
            remaining -= take * vb.unit
        if remaining > 0:
            # rung 4 — unless rung 1 just fired: a degrade deserves one
            # tick to relieve the load before the refusal is final
            if not want_degrade:
                del self._pressure[name]
                plan[name] = _LanePack(
                    bid=b, action=ACTION_HOLD, target=b.current,
                    reason=f"refuse:capacity_exhausted short={remaining}",
                    trigger=p.trigger)
                self._inc("refuse_final")
            return free_remaining
        for v, take in planned:
            cuts[v] = cuts.get(v, 0) + take
            vb = bids[v]
            verb = "preempt" if vb.kind == KIND_TRAINING else "harvest"
            plan[v] = _LanePack(
                bid=vb, action=ACTION_DOWN,
                target=vb.current - cuts[v],
                reason=f"{verb}:{name}", trigger=p.trigger, apply=True)
            if verb == "preempt":
                self._inc("preempts")
            else:
                self._inc("harvests")
        if not want_degrade:
            plan[name] = _LanePack(
                bid=b, action=ACTION_HOLD, target=b.current,
                reason=f"pressure_wait short={shortfall}",
                trigger=p.trigger)
        return 0

    def _fill_locked(self, bids, plan, cuts, free_remaining: int) -> None:
        """No pressure anywhere: idle chips flow to broker-managed
        lanes (the batch lane harvesting idle decode capacity) by
        priority."""
        managed = [n for n in bids
                   if (c := self._consumers.get(n)) is not None
                   and c.managed and n not in cuts]
        managed.sort(key=lambda n: (-bids[n].priority, n))
        for name in managed:
            if free_remaining <= 0:
                break
            b = bids[name]
            want = b.desired - b.current
            if want <= 0:
                continue
            units = min(want, free_remaining // b.unit)
            if units <= 0:
                continue
            plan[name] = _LanePack(bid=b, action=ACTION_UP,
                                   target=b.current + units,
                                   reason="fill:idle_capacity", apply=True)
            # earmark the filled chips as a (pre-ledgered) reservation:
            # until the lane's NEXT bid reflects the push, admission
            # through ``request_capacity`` must already see them as
            # used — without this, a scale-up landing between the fill
            # and the bid catching up overcommits the market
            self._grants[name] = _Grant(target_units=b.current + units,
                                        ledgered=True)
            free_remaining -= units * b.unit
            self._inc("fills")

    # ------------------------------------------------------------- plumbing
    def _used_chips_locked(self) -> int:
        used = 0
        for name, b in self._last_bids.items():
            g = self._grants.get(name)
            held = max(b.current, g.target_units if g is not None else 0)
            used += held * b.unit
        for name, g in self._grants.items():
            if name not in self._last_bids:
                used += g.target_units
        return used

    def _consumer(self, name: str) -> Optional[_Consumer]:
        with self._lock:
            return self._consumers.get(name)

    def _grant_ledgered(self, name: str) -> None:
        with self._lock:
            g = self._grants.get(name)
            if g is not None:
                g.ledgered = True

    def _lane_failed(self, name: str, decision, failure: str) -> None:
        """A lane commit was rejected (chaos stale-bid/conflict, an
        apply that returned False): drop any reservation the decision
        was acknowledging — the market re-clears from fresh bids next
        tick, no partial apply."""
        with self._lock:
            if decision.action == ACTION_UP:
                self._grants.pop(name, None)
            self.decision_log.append(format_commit_failure_line(
                decision.seq, failure, scope=(("lane", name),)))
        self._inc("lane_conflicts")

    def _record_lane(self, name: str, decision) -> None:
        with self._lock:
            self.decision_log.append(format_decision_line(
                decision.seq, decision.action, decision.current,
                decision.target, decision.reason, scope=(("lane", name),)))

    def _inc(self, counter: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(counter)

    def _set_gauge(self, name: str, value: float) -> None:
        if self.metrics is not None:
            self.metrics.set_gauge(name, value)
