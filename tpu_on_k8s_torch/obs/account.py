"""Goodput and cost accounting: copies of ``ServingAccountant``,
``TrainingAccountant`` and ``goodput_from_spans`` from
``tpu_on_k8s/obs/account.py``, which the port may not import.

* ``ServingAccountant`` classifies every finished request's tokens as
  good (served within the latency SLO) or degraded (finished but
  breached, or partial output from a cancel, expiry or exhaustion), and
  counts rejected and replayed requests per tenant; chip-seconds are
  charged per tenant through the router's capacity weights (a
  mesh-sharded replica spans several cards).
* ``TrainingAccountant``: productive step seconds on NOVEL steps against
  waste (replayed steps after a preemption resume, restart and checkpoint
  gaps, unattributed overhead), surfaced as the ``TrainMetrics``
  ``goodput_fraction`` gauge. ``train/loop.py`` feeds it at every
  host-sync window; a window whose global steps were already accounted is
  replay.
* ``goodput_from_spans`` computes the same split after the fact from a
  trace's ``train.window`` spans.

No clock reads (time enters as arguments the callers measured); stdlib
only.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional


#: waste attribution buckets the training ledger recognizes. ``reshard``
#: is the live mesh-reconfiguration pause (`parallel/reshard.py` via
#: `train/loop.py`) — attributed distinctly so a live rescale's cost is
#: never misclassified as a restart or preemption, and the
#: ``goodput_fraction`` gauge prices the live path against the
#: checkpoint-restart path honestly.
WASTE_KINDS = ("replay", "restart", "recompile", "preempt", "checkpoint",
               "reshard", "overhead")


class ServingAccountant:
    """Per-tenant good/degraded token and chip-second ledger. SLO
    targets come in at construction (``ttft_slo_s`` / ``tpot_slo_s``;
    0 disables that check — a request is good when every *configured*
    target holds). ``router`` supplies chip capacities
    (``capacity_of``); explicit ``note_capacity`` calls win."""

    def __init__(self, *, ttft_slo_s: float = 0.0, tpot_slo_s: float = 0.0,
                 metrics=None, router=None) -> None:
        self.ttft_slo_s = max(float(ttft_slo_s), 0.0)
        self.tpot_slo_s = max(float(tpot_slo_s), 0.0)
        self.metrics = metrics
        self.router = router
        self._capacity: Dict[str, float] = {}
        self.good_tokens: Dict[str, int] = defaultdict(int)
        self.degraded_tokens: Dict[str, int] = defaultdict(int)
        self.rejected: Dict[str, int] = defaultdict(int)
        self.replayed: Dict[str, int] = defaultdict(int)
        self.chip_seconds: Dict[str, float] = defaultdict(float)

    # ------------------------------------------------------------- capacity
    def note_capacity(self, replica: str, chips: float) -> None:
        """Declare a replica's chip count (mirrors
        ``Router.set_capacity`` for callers without a router)."""
        if chips < 1:
            raise ValueError(f"chips must be >= 1, got {chips}")
        self._capacity[replica] = float(chips)

    def chips_of(self, replica: str) -> float:
        got = self._capacity.get(replica)
        if got is not None:
            return got
        if self.router is not None and replica:
            return float(self.router.capacity_of(replica))
        return 1.0

    # ------------------------------------------------------------ the ledger
    def within_slo(self, ttft: Optional[float],
                   tpot: Optional[float]) -> bool:
        """Every configured latency target holds. A missing sample for a
        configured target reads as a breach — "we don't know how slow it
        was" must not count as good (the no-data discipline again)."""
        if self.ttft_slo_s > 0:
            if ttft is None or ttft > self.ttft_slo_s:
                return False
        if self.tpot_slo_s > 0:
            if tpot is None or tpot > self.tpot_slo_s:
                return False
        return True

    def observe_request(self, *, tenant: str, state: str, tokens: int,
                        ttft: Optional[float] = None,
                        tpot: Optional[float] = None,
                        duration_s: float = 0.0, replica: str = "",
                        replays: int = 0) -> str:
        """Account one terminal request; returns its classification
        (``good`` / ``degraded`` / ``rejected``). ``duration_s`` is the
        request's occupancy (submit → terminal) — chip-seconds charge
        ``duration × chips(replica)`` to the tenant regardless of
        outcome: a rejected request cost nothing, a degraded one cost
        the same chips a good one did (which is the point of the
        ledger)."""
        m = self.metrics
        if replays > 0:
            self.replayed[tenant] += replays
            if m is not None:
                m.inc("replayed_requests", replays, label=tenant)
        if state == "rejected":
            self.rejected[tenant] += 1
            if m is not None:
                m.inc("rejected_requests", label=tenant)
            return "rejected"
        cost = self.chips_of(replica) * max(float(duration_s), 0.0)
        if cost > 0:
            self.chip_seconds[tenant] += cost
            if m is not None:
                m.inc("chip_seconds", cost, label=tenant)
        good = state == "done" and self.within_slo(ttft, tpot)
        if good:
            self.good_tokens[tenant] += int(tokens)
            if m is not None and tokens:
                m.inc("good_tokens", int(tokens), label=tenant)
            return "good"
        self.degraded_tokens[tenant] += int(tokens)
        if m is not None and tokens:
            m.inc("degraded_tokens", int(tokens), label=tenant)
        return "degraded"

    def summary(self) -> Dict[str, Any]:
        """Deterministic per-tenant rollup (sorted tenants) plus totals —
        the shape `tools/serve_load.py --slo` folds into its summary."""
        tenants = sorted(set(self.good_tokens) | set(self.degraded_tokens)
                         | set(self.rejected) | set(self.replayed)
                         | set(self.chip_seconds))
        per_tenant = {
            t: {
                "good_tokens": self.good_tokens.get(t, 0),
                "degraded_tokens": self.degraded_tokens.get(t, 0),
                "rejected": self.rejected.get(t, 0),
                "replayed": self.replayed.get(t, 0),
                "chip_seconds": round(self.chip_seconds.get(t, 0.0), 6),
            } for t in tenants}
        good = sum(self.good_tokens.values())
        degraded = sum(self.degraded_tokens.values())
        return {
            "good_tokens": good,
            "degraded_tokens": degraded,
            "goodput_token_fraction": (round(good / (good + degraded), 6)
                                       if good + degraded else None),
            "rejected": sum(self.rejected.values()),
            "replayed": sum(self.replayed.values()),
            "chip_seconds": round(sum(self.chip_seconds.values()), 6),
            "per_tenant": per_tenant,
        }


class TrainingAccountant:
    """Training goodput ledger. `train/loop.py` calls ``window`` at each
    host sync and ``run_complete`` when a run returns; an orchestrator
    that restarts a preempted job sets ``start_step`` to the resumed
    checkpoint step (and may add explicit ``waste`` for the
    restart/recompile gap it measured). Steps at-or-below the
    high-water mark are REPLAY — work the preemption already paid for
    once."""

    def __init__(self, *, metrics=None, start_step: int = 0) -> None:
        self.metrics = metrics
        self.start_step = int(start_step)
        self._max_step = int(start_step)
        self.productive_s = 0.0
        self.waste_s: Dict[str, float] = {k: 0.0 for k in WASTE_KINDS}
        self.preemptions = 0
        self._run_accounted = 0.0

    # ------------------------------------------------------------- the ledger
    def window(self, step: int, steps: int, step_seconds: float) -> None:
        """One host-sync window: ``steps`` loop steps ending at local
        ``step`` (global = ``start_step + step``), each costing
        ``step_seconds``. Novel steps are productive; re-executed ones
        (global end ≤ high-water mark) are replay waste."""
        end = self.start_step + int(step)
        steps = max(int(steps), 0)
        dt = max(float(step_seconds), 0.0)
        novel = max(0, min(steps, end - self._max_step))
        replay = steps - novel
        self.productive_s += novel * dt
        if replay:
            self.waste_s["replay"] += replay * dt
        self._run_accounted += steps * dt
        self._max_step = max(self._max_step, end)
        if self.metrics is not None:
            self.metrics.set_gauge("goodput_fraction",
                                   self.goodput_fraction())

    def waste(self, kind: str, seconds: float) -> None:
        """Attribute ``seconds`` of non-productive time. Unknown kinds
        fold into ``overhead`` rather than raising — the ledger must
        absorb a new caller's vocabulary, not crash it."""
        key = kind if kind in self.waste_s else "overhead"
        self.waste_s[key] += max(float(seconds), 0.0)
        if self.metrics is not None:
            self.metrics.set_gauge("goodput_fraction",
                                   self.goodput_fraction())

    def pause(self, kind: str, seconds: float) -> None:
        """An in-run measured pause (the live-reshard transform): lands
        in its waste bucket AND counts as run-accounted time, so
        ``run_complete`` does not re-classify the same seconds as
        overhead/preempt residual — the pause is attributed exactly
        once, under its own name."""
        self.waste(kind, seconds)
        self._run_accounted += max(float(seconds), 0.0)

    def run_complete(self, run_seconds: float, *,
                     preempted: bool = False) -> None:
        """Close one ``TrainLoop.run``: the gap between the run's wall
        time and its accounted step time is waste — ``preempt`` when the
        run ended on a preemption notice (drain + final save time),
        ``overhead`` otherwise (compile, sync, checkpoint cadence)."""
        residual = max(float(run_seconds) - self._run_accounted, 0.0)
        self._run_accounted = 0.0
        if preempted:
            self.preemptions += 1
        self.waste(("preempt" if preempted else "overhead"), residual)

    def resume(self, from_step: int) -> None:
        """A restarted incarnation resumes at checkpoint ``from_step``:
        subsequent windows report local steps 1.. on top of it. The
        high-water mark is NOT reset — that is how replayed steps are
        recognized."""
        self.start_step = int(from_step)

    # -------------------------------------------------------------- readouts
    def total_waste_s(self) -> float:
        return sum(self.waste_s.values())

    def goodput_fraction(self) -> float:
        total = self.productive_s + self.total_waste_s()
        if total <= 0:
            return 1.0
        return self.productive_s / total

    def summary(self) -> Dict[str, Any]:
        return {
            "productive_s": round(self.productive_s, 6),
            "waste_s": {k: round(v, 6)
                        for k, v in self.waste_s.items() if v > 0},
            "total_waste_s": round(self.total_waste_s(), 6),
            "preemptions": self.preemptions,
            "goodput_fraction": round(self.goodput_fraction(), 6),
            "steps_accounted": self._max_step,
        }


def goodput_from_spans(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Post-hoc goodput from a trace dump's ``train.window`` spans: the
    productive time is the step time the windows report
    (``steps × step_seconds`` attrs, span duration as the fallback);
    everything between the first window's start and the last window's
    end that no window covers is gap waste (compile, checkpoint drains,
    restart dead time — whatever kept the devices from stepping)."""
    windows = sorted((s for s in spans if s.get("name") == "train.window"
                      and s.get("end") is not None),
                     key=lambda s: (s["start"], s.get("span", 0)))
    if not windows:
        return {"windows": 0, "productive_s": 0.0, "span_s": 0.0,
                "gap_s": 0.0, "goodput_fraction": None}
    productive = 0.0
    covered = 0.0
    for s in windows:
        attrs = s.get("attrs") or {}
        dur = s["end"] - s["start"]
        covered += dur
        steps = attrs.get("steps")
        step_seconds = attrs.get("step_seconds")
        if steps is not None and step_seconds is not None:
            productive += float(steps) * float(step_seconds)
        else:
            productive += dur
    span_s = windows[-1]["end"] - windows[0]["start"]
    gap = max(span_s - covered, 0.0)
    total = productive + gap
    return {
        "windows": len(windows),
        "productive_s": round(productive, 6),
        "span_s": round(span_s, 6),
        "gap_s": round(gap, 6),
        "goodput_fraction": (round(productive / total, 6)
                             if total > 0 else None),
    }
