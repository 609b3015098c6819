"""Training goodput: copies of ``TrainingAccountant`` and
``goodput_from_spans`` from ``tpu_on_k8s/obs/account.py``, which the port
may not import.

Productive step seconds on NOVEL steps against waste (replayed steps after
a preemption resume, restart and checkpoint gaps, unattributed overhead),
surfaced as the ``TrainMetrics`` ``goodput_fraction`` gauge.
``train/loop.py`` feeds it at every host-sync window; a window whose
global steps were already accounted is replay. ``goodput_from_spans``
computes the same split after the fact from a trace's ``train.window``
spans. No clock reads (time enters as arguments the callers measured);
stdlib only.
"""
from __future__ import annotations

from typing import Any, Dict, List


#: waste attribution buckets the training ledger recognizes. ``reshard``
#: is the live mesh-reconfiguration pause (`parallel/reshard.py` via
#: `train/loop.py`) — attributed distinctly so a live rescale's cost is
#: never misclassified as a restart or preemption, and the
#: ``goodput_fraction`` gauge prices the live path against the
#: checkpoint-restart path honestly.
WASTE_KINDS = ("replay", "restart", "recompile", "preempt", "checkpoint",
               "reshard", "overhead")


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
