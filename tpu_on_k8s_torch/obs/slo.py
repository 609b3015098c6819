"""Deterministic SLO engine: declarative objectives, sliding windows,
multi-window error-budget burn rates, typed budget-state transitions (the
counterpart of ``tpu_on_k8s/obs/slo.py``).

The stack emits spans, histograms, and exemplars end-to-end (`obs/trace`,
`metrics`), but nothing *interprets* them: autoscalers react to raw p95
thresholds, and "are we inside our error budget" is not a question any
existing signal answers. This module is that interpretation layer:

* **``SLOSpec``** — one declarative objective: *what* is measured
  (``ttft_p95`` / ``tpot_p95`` / ``queue_wait_p95`` / ``availability``),
  the target, and the compliance window. A pNN latency objective grants
  an error budget of ``(100-NN)%`` breaching requests over the window; an
  availability objective grants ``1 - target`` failed requests.
* **``SLOEvaluator``** — feeds good/bad events into a pruned sliding
  window and computes **multi-window burn rates**, SRE-style: the *fast*
  pair (5m/1h at a 30-day window; both must burn ≥ ``page_burn``) catches
  a sharp regression in minutes, the *slow* pair (6h/3d at ``warn_burn``)
  catches a slow bleed days before the budget empties. A pair's burn is
  the **min** of its two windows' burns (the long window is the
  confirmation, the short window the fast-reset) — exactly the
  multiwindow, multi-burn-rate alert the SRE workbook recommends.
* **``BudgetState``** — ``ok → warn → page → exhausted``, with a
  hysteresis dead band so a burn oscillating at the page threshold does
  not flap the state. Every transition lands in one deterministic
  ``event_log`` line, a ``budget_transitions`` counter, and (when a span
  is passed to ``evaluate``) a ``slo.transition`` span event.
* **``SLOEngine``** — a named set of evaluators sharing one clock and
  one event log: what `controller/fleetautoscaler.py` runs per service
  (and per model, for a multi-model service's ``spec.models[].slo``).

Staleness is explicit, never silent: past ``stale_after_s`` without a
single observation, burn rates report ``None`` (the windows have aged
dry) and the status carries ``stale=True`` — a dead signal source must
surface as *stale*, not as a frozen last-known burn rate (the same
no-data-is-not-zero discipline as `autoscale/signals.py`).

Deterministic by construction: every timestamp comes from the injected
clock, windows prune by arithmetic on those timestamps, and iteration
orders are insertion/sorted — two runs of the same seeded trace produce
byte-identical event logs. Stdlib-only, importable from any layer, like
the rest of `obs/`.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

# ------------------------------------------------------------ budget states
BUDGET_OK = "ok"
BUDGET_WARN = "warn"
BUDGET_PAGE = "page"
BUDGET_EXHAUSTED = "exhausted"

#: stable numeric encoding for the ``budget_state`` gauge (lands in
#: dashboards — append-only)
BUDGET_STATE_CODES = {BUDGET_OK: 0, BUDGET_WARN: 1, BUDGET_PAGE: 2,
                      BUDGET_EXHAUSTED: 3}

#: latency signal kinds a pNN objective can target — the names match the
#: `autoscale/signals.FleetSample` fields and the serving histograms
LATENCY_KINDS = ("ttft", "tpot", "queue_wait")

_PCTL_RE = re.compile(r"^(?P<kind>[a-z_]+)_p(?P<pct>\d{2})$")


def objective_kind(objective: str) -> Tuple[str, float]:
    """``(signal kind, error-budget fraction)`` of an objective name.

    ``ttft_p95`` → (``"ttft"``, 0.05): a p95 target means 5% of requests
    may breach it before the budget is spent. ``availability`` keys its
    budget off the spec target instead (fraction returned is 0.0 here and
    resolved by the evaluator as ``1 - target``). Raises ``ValueError``
    on anything else — an unknown objective must fail loudly at spec
    time, not silently never-page in production.
    """
    if objective == "availability":
        return "availability", 0.0
    m = _PCTL_RE.match(objective)
    if m is not None and m.group("kind") in LATENCY_KINDS:
        return m.group("kind"), (100 - int(m.group("pct"))) / 100.0
    raise ValueError(
        f"unknown SLO objective {objective!r} — expected 'availability' "
        f"or one of {LATENCY_KINDS} with a _pNN suffix (e.g. 'ttft_p95')")


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """One declarative objective. ``window_s`` is the compliance window
    the error budget covers; the four burn windows default to the SRE
    ratios of it (at the 30-day default: 5m/1h fast pair, 6h/3d slow
    pair) and may be set explicitly for virtual-clock traces. ``target``
    is seconds for latency objectives, a fraction (e.g. 0.999) for
    availability."""

    name: str
    objective: str = "ttft_p95"
    target: float = 0.0
    window_s: float = 2_592_000.0          # 30 days
    fast_short_s: float = 0.0              # 0 → window_s / 8640   (5m)
    fast_long_s: float = 0.0               # 0 → window_s / 720    (1h)
    slow_short_s: float = 0.0              # 0 → window_s / 120    (6h)
    slow_long_s: float = 0.0               # 0 → window_s / 10     (3d)
    page_burn: float = 14.4                # SRE fast-pair threshold
    warn_burn: float = 1.0                 # slow bleed: budget-rate 1x
    hysteresis: float = 0.2                # dead band leaving warn/page
    stale_after_s: float = 0.0             # 0 → fast_long_s

    def normalized(self) -> "SLOSpec":
        """Validated, defaults-resolved copy (the engine only ever holds
        normalized specs). Raises on an unknown objective or a
        non-positive target/window — a spec that can never evaluate is a
        configuration bug, not a runtime condition."""
        objective_kind(self.objective)     # raises on junk
        w = float(self.window_s)
        if w <= 0:
            raise ValueError(f"window_s must be > 0, got {w}")
        if float(self.target) <= 0:
            raise ValueError(f"target must be > 0, got {self.target}")
        fast_long = float(self.fast_long_s) or w / 720.0
        return SLOSpec(
            name=str(self.name),
            objective=str(self.objective),
            target=float(self.target),
            window_s=w,
            fast_short_s=float(self.fast_short_s) or w / 8640.0,
            fast_long_s=fast_long,
            slow_short_s=float(self.slow_short_s) or w / 120.0,
            slow_long_s=float(self.slow_long_s) or w / 10.0,
            page_burn=max(float(self.page_burn), 1.0),
            warn_burn=max(float(self.warn_burn), 0.0),
            hysteresis=min(max(float(self.hysteresis), 0.0), 0.9),
            stale_after_s=float(self.stale_after_s) or fast_long)

    @property
    def budget_fraction(self) -> float:
        """The allowed bad-event fraction over the compliance window."""
        kind, frac = objective_kind(self.objective)
        if kind == "availability":
            return max(1.0 - float(self.target), 1e-9)
        return frac


@dataclasses.dataclass(frozen=True)
class SLOStatus:
    """One evaluation's output: the typed budget state plus the numbers
    behind it. ``burn_fast`` / ``burn_slow`` are the pair burns (min of
    each pair's two windows) — ``None`` when a window holds no events
    (no data is never a burn rate of zero). ``budget_remaining`` is the
    fraction of the window's error budget left (negative = overdrawn)."""

    name: str
    objective: str
    target: float
    state: str
    burn_fast: Optional[float]
    burn_slow: Optional[float]
    budget_remaining: float
    good: int                              # events in the full window
    bad: int
    stale: bool

    @property
    def code(self) -> int:
        return BUDGET_STATE_CODES.get(self.state, -1)


def _fmt(v: Optional[float]) -> str:
    return "none" if v is None else f"{v:.6f}"


class _EventWindow:
    """Sliding good/bad event counts, pruned to the longest horizon.
    Boundary rule: an event at exactly ``now - horizon`` is OUTSIDE the
    window (windows are half-open ``(now - h, now]``) — pinned by the
    window-boundary determinism test.

    Events coalesce into time buckets of ``bucket_s`` (the evaluator
    passes an eighth of its shortest burn window): a cell per bucket,
    not per observation, so a 30-day production window holds
    O(window/bucket) cells — bounded regardless of traffic rate — and
    the sub-window scans stay proportional to buckets, not events.
    Timestamps snap UP to the bucket edge (ceil), so a snapped event is
    never older than it really is: it can only *leave* a window late
    (by < bucket_s, ≤ 1/8 of the shortest window), never get dropped
    from one it belongs to."""

    def __init__(self, keep_s: float, bucket_s: float = 0.0) -> None:
        self.keep_s = keep_s
        self.bucket_s = bucket_s
        self._cells: Deque[Tuple[float, int, int]] = deque()
        self.good_total = 0
        self.bad_total = 0

    def add(self, t: float, good: int, bad: int) -> None:
        if self.bucket_s > 0:
            t = math.ceil(t / self.bucket_s) * self.bucket_s
        cells = self._cells
        if cells and cells[-1][0] == t:
            lt, lg, lb = cells[-1]
            cells[-1] = (lt, lg + good, lb + bad)
        else:
            cells.append((t, good, bad))
        self.good_total += good
        self.bad_total += bad

    def prune(self, now: float) -> None:
        cells = self._cells
        while cells and cells[0][0] <= now - self.keep_s:
            _, g, b = cells.popleft()
            self.good_total -= g
            self.bad_total -= b

    def counts_since(self, t0: float) -> Tuple[int, int]:
        """(good, bad) of events with ``t > t0`` — newest-first walk, so
        the cost is proportional to the sub-window, not the retention."""
        good = bad = 0
        for t, g, b in reversed(self._cells):
            if t <= t0:
                break
            good += g
            bad += b
        return good, bad


class SLOEvaluator:
    """One objective's window + burn-rate + state machine. Feed events
    with ``observe``; call ``evaluate`` at any cadence — evaluation is a
    pure function of (window contents, clock), so cadence changes move
    *when* a transition is seen, never *whether*."""

    def __init__(self, spec: SLOSpec, *, clock: Callable[[], float],
                 metrics=None, label: str = "",
                 event_log: Optional[List[str]] = None,
                 on_transition=None) -> None:
        self.spec = spec.normalized()
        self.kind, _ = objective_kind(self.spec.objective)
        self.clock = clock
        self.metrics = metrics
        self.label = label or self.spec.name
        self.event_log = event_log if event_log is not None else []
        self.on_transition = on_transition
        self.state = BUDGET_OK
        # bucket at an eighth of the shortest burn window: bounded cell
        # count over a 30-day window, ≤ 12.5% timestamp skew on the one
        # window it matters most for (and far less on the longer ones)
        self._window = _EventWindow(self.spec.window_s,
                                    bucket_s=self.spec.fast_short_s / 8)
        self._last_obs_t: Optional[float] = None

    # -------------------------------------------------------------- feeding
    def observe(self, value: Optional[float] = None,
                ok: Optional[bool] = None) -> None:
        """One event. Latency objectives take ``value`` (seconds; bad
        when above target); availability takes ``ok`` directly."""
        if ok is None:
            if value is None:
                raise ValueError("observe needs value= or ok=")
            ok = value <= self.spec.target
        t = self.clock()
        self._window.add(t, int(ok), int(not ok))
        self._last_obs_t = t

    # ------------------------------------------------------------- the math
    def _burn(self, now: float, horizon_s: float) -> Optional[float]:
        """Burn rate over one window: observed bad fraction divided by
        the budget fraction (burn 1.0 = spending exactly the budget's
        sustainable rate; ``page_burn`` multiples of it page). ``None``
        on an empty window."""
        good, bad = self._window.counts_since(now - horizon_s)
        total = good + bad
        if total == 0:
            return None
        return (bad / total) / self.spec.budget_fraction

    def _pair_burn(self, now: float, short_s: float,
                   long_s: float) -> Optional[float]:
        """The multi-window rule: a pair burns at the MIN of its two
        windows (both must exceed the threshold to alert — the short
        window resets fast once the breach stops, the long window keeps
        one spike from paging). ``None`` when either window is empty."""
        short = self._burn(now, short_s)
        long_ = self._burn(now, long_s)
        if short is None or long_ is None:
            return None
        return min(short, long_)

    def _next_state(self, burn_fast: Optional[float],
                    burn_slow: Optional[float],
                    remaining: float) -> str:
        s = self.spec
        if remaining <= 0.0:
            return BUDGET_EXHAUSTED
        if self.state == BUDGET_EXHAUSTED and remaining < s.hysteresis:
            return BUDGET_EXHAUSTED        # dead band on budget refill
        lo = 1.0 - s.hysteresis
        page_on = burn_fast is not None and burn_fast >= s.page_burn
        page_hold = (self.state == BUDGET_PAGE and burn_fast is not None
                     and burn_fast >= s.page_burn * lo)
        if page_on or page_hold:
            return BUDGET_PAGE
        warn_on = (s.warn_burn > 0 and burn_slow is not None
                   and burn_slow >= s.warn_burn)
        warn_hold = (self.state in (BUDGET_WARN, BUDGET_PAGE)
                     and s.warn_burn > 0 and burn_slow is not None
                     and burn_slow >= s.warn_burn * lo)
        if warn_on or warn_hold:
            return BUDGET_WARN
        return BUDGET_OK

    # ------------------------------------------------------------ evaluation
    def evaluate(self, span=None) -> SLOStatus:
        """Compute burns + budget, run the state machine, publish gauges,
        and record any transition (event-log line, counter, span event,
        callback). ``span`` is an open `obs/trace` span transitions land
        on as ``slo.transition`` events — the autoscaler passes its tick
        span, other callers pass their root."""
        s = self.spec
        now = self.clock()
        self._window.prune(now)
        stale = (self._last_obs_t is None
                 or now - self._last_obs_t > s.stale_after_s)
        good = self._window.good_total
        bad = self._window.bad_total
        total = good + bad
        remaining = (1.0 if total == 0
                     else 1.0 - (bad / total) / s.budget_fraction)
        if stale:
            # the signal went dark: burn rates are unknowable, not
            # whatever they last were — surface staleness, hold state
            burn_fast = burn_slow = None
            state = self.state
        else:
            burn_fast = self._pair_burn(now, s.fast_short_s, s.fast_long_s)
            burn_slow = self._pair_burn(now, s.slow_short_s, s.slow_long_s)
            state = self._next_state(burn_fast, burn_slow, remaining)
        status = SLOStatus(
            name=s.name, objective=s.objective, target=s.target,
            state=state, burn_fast=burn_fast, burn_slow=burn_slow,
            budget_remaining=remaining, good=good, bad=bad, stale=stale)
        if state != self.state:
            old, self.state = self.state, state
            line = (f"t={now:.6f} slo={self.label} state={old}->{state} "
                    f"burn_fast={_fmt(burn_fast)} "
                    f"burn_slow={_fmt(burn_slow)} "
                    f"budget_remaining={remaining:.6f}")
            self.event_log.append(line)
            if span is not None:
                span.event("slo.transition", slo=self.label,
                           frm=old, to=state,
                           burn_fast=burn_fast, burn_slow=burn_slow,
                           budget_remaining=round(remaining, 6))
            if self.metrics is not None:
                self.metrics.inc("budget_transitions", label=state)
            if self.on_transition is not None:
                self.on_transition(self.label, old, state, status)
        if self.metrics is not None:
            m = self.metrics
            if burn_fast is not None:
                m.set_gauge("burn_rate_fast", burn_fast, label=self.label)
            if burn_slow is not None:
                m.set_gauge("burn_rate_slow", burn_slow, label=self.label)
            m.set_gauge("budget_remaining", remaining, label=self.label)
            m.set_gauge("budget_state", float(status.code),
                        label=self.label)
            m.set_gauge("slo_stale", float(stale), label=self.label)
        return status


def page_onsets(lines) -> List[str]:
    """The budget-log lines that BEGIN a page episode, in order: a
    transition whose ``to`` state pages (``page``/``exhausted``) while
    its ``from`` state did not. The decision ledger's
    ``slo_page:<svc>#N`` trigger ordinal indexes this list (1-based) —
    computed from the log itself on each paging onset, so a paging
    signal that resumes after a stale gap (no new transition line — the
    state machine held ``page`` through the dark window) keeps the SAME
    episode ordinal and the trigger stays resolvable."""
    out = []
    for line in lines:
        fields = dict(part.partition("=")[::2] for part in line.split(" "))
        frm, _, to = fields.get("state", "").partition("->")
        if to in (BUDGET_PAGE, BUDGET_EXHAUSTED) \
                and frm not in (BUDGET_PAGE, BUDGET_EXHAUSTED):
            out.append(line)
    return out


class SLOEngine:
    """A named set of evaluators sharing one injected clock and ONE
    event log (transitions across objectives interleave in evaluation
    order — the byte-comparable budget timeline ``make slo-soak``
    replays). Specs keep their given order; ``evaluate`` walks them in
    that order, so the log is deterministic whenever the feed is."""

    def __init__(self, specs, *, clock: Callable[[], float],
                 metrics=None, service: str = "",
                 on_transition=None) -> None:
        self.clock = clock
        self.service = service
        self.event_log: List[str] = []
        self.evaluators: Dict[str, SLOEvaluator] = {}
        for spec in specs:
            norm = spec.normalized()
            if norm.name in self.evaluators:
                raise ValueError(f"duplicate SLO name {norm.name!r}")
            label = f"{service}/{norm.name}" if service else norm.name
            self.evaluators[norm.name] = SLOEvaluator(
                norm, clock=clock, metrics=metrics, label=label,
                event_log=self.event_log, on_transition=on_transition)

    # -------------------------------------------------------------- feeding
    def observe_latency(self, kind: str, value: float) -> None:
        """One latency sample (seconds) of ``kind`` (``ttft`` / ``tpot``
        / ``queue_wait``): feeds every evaluator targeting that kind."""
        for ev in self.evaluators.values():
            if ev.kind == kind:
                ev.observe(value=value)

    def observe_outcome(self, ok: bool) -> None:
        """One request outcome: feeds every availability evaluator."""
        for ev in self.evaluators.values():
            if ev.kind == "availability":
                ev.observe(ok=ok)

    # ------------------------------------------------------------ evaluation
    def evaluate(self, span=None) -> Dict[str, SLOStatus]:
        """Evaluate every objective (spec order); returns name → status."""
        return {name: ev.evaluate(span=span)
                for name, ev in self.evaluators.items()}

    def paging(self, statuses: Optional[Dict[str, SLOStatus]] = None
               ) -> bool:
        """True when any non-stale objective is at ``page`` or worse —
        the severity hint the fleet autoscaler consumes."""
        if statuses is None:
            statuses = {n: ev.evaluate()
                        for n, ev in self.evaluators.items()}
        return any(st.state in (BUDGET_PAGE, BUDGET_EXHAUSTED)
                   and not st.stale for st in statuses.values())
