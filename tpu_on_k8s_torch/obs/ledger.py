"""Decision ledger: one byte-replayable provenance record for every
control-loop decision: the counterpart of ``tpu_on_k8s/obs/ledger.py``.

The control loops (the ElasticAutoscaler over TorchJobs, the model pool's
swaps and evictions) each keep their own log; this module is their join
point:

* **``DecisionRecord``** — one loop decision, typed: the loop id, the
  loop-local observation tick, the observed signals (pre-formatted
  strings, so the serialized form is stable by construction), trace-id
  exemplars tying the signals back to the request spans that produced
  them, the triggering SLO page episode or chaos event, a parent link to
  the loop's previous committed decision, the decide outcome
  (action/current→target/reason), and the commit outcome — ``landed``,
  ``conflict:<Type>`` (the patch never happened, no cooldown burned), or
  ``fallback:<Type>`` (the patch landed but in-process execution
  deferred to the reconciler).
* **``HorizonRecord``** — the *effect horizon* of a committed decision:
  opened at commit, progressed/closed later when the effect is observed
  — the replicas go ready, the rollout/drain completes, or the SLO burn
  recovers.
* **``DecisionLedger``** — an injectable-clock, append-only record list
  with ONE monotone sequence counter. Ids come from the counter and
  timestamps from the injected clock, so two runs of the same seeded
  trace produce **byte-identical dumps** (the same contract as
  `obs/trace.Tracer`).
* **``NOOP``** — the disabled ledger: every record method no-ops and
  returns None, reads no clock, takes no lock, allocates nothing per
  call — a loop running without a ledger is bit-for-bit on its
  pre-ledger behavior, so every existing determinism proof survives.

The loops themselves never import this module's internals directly:
they ride `controller/loopkernel.LoopKernel`, whose observe→decide→
commit template emits exactly one ``DecisionRecord`` per decision.

Stdlib-only, importable from any layer — the same discipline as
`obs/trace.py` and `chaos.py`.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

#: the ledger-file format tag ``load_ledger`` checks
LEDGER_FORMAT = "tpu-on-k8s-ledger/v1"

# ------------------------------------------------------------ commit outcomes
#: decide held / skipped: nothing was executed, no effect horizon exists
COMMIT_NONE = "none"
#: the patch landed (and any in-process apply succeeded)
COMMIT_LANDED = "landed"
#: prefix of "the write did not land" outcomes (``conflict:<ExcType>``):
#: the scale never happened and no cooldown was burned
COMMIT_CONFLICT = "conflict"
#: prefix of "the patch landed but in-process execution deferred"
#: outcomes (``fallback:<why>``): the reconciler converges later
COMMIT_FALLBACK = "fallback"

#: horizon-close outcomes (the three observable effect ends)
HORIZON_REPLICAS_READY = "replicas_ready"
HORIZON_ROLLOUT_COMPLETE = "rollout_complete"
HORIZON_BURN_RECOVERED = "burn_recovered"
#: a newer committed decision took over before this one's effect landed
HORIZON_SUPERSEDED = "superseded"
#: the loop itself was retired (object deleted, service deregistered)
#: before the effect was observed — closed so the gauge cannot pin
HORIZON_ABANDONED = "abandoned"


def committed(outcome: str) -> bool:
    """True when a commit outcome means the write LANDED (``landed`` or
    ``fallback:*`` — a deferred in-process apply still changed the
    spec; only ``none``/``conflict:*`` mean nothing happened)."""
    return outcome == COMMIT_LANDED or outcome.startswith(COMMIT_FALLBACK)


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One control-loop decision (see module doc). ``signals`` are
    pre-formatted ``(key, value)`` string pairs — formatting at record
    time is what makes the serialized ledger stable by construction;
    ``exemplars`` are trace ids (`obs/trace.py` counter ids) of the
    requests whose latency observations backed the signals."""

    seq: int
    t: float
    loop: str
    tick: int
    action: str
    current: int
    target: int
    reason: str
    commit: str = COMMIT_NONE
    trigger: str = ""                 # "slo_page:<svc>#N" | "chaos#N" | ""
    parent: Optional[int] = None      # seq of the loop's previous commit
    signals: Tuple[Tuple[str, str], ...] = ()
    exemplars: Tuple[int, ...] = ()
    horizon: str = "none"             # "open" | "none"

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "kind": "decision", "seq": self.seq, "t": self.t,
            "loop": self.loop, "tick": self.tick, "action": self.action,
            "current": self.current, "target": self.target,
            "reason": self.reason, "commit": self.commit,
            "horizon": self.horizon,
        }
        if self.trigger:
            d["trigger"] = self.trigger
        if self.parent is not None:
            d["parent"] = self.parent
        if self.signals:
            d["signals"] = {k: v for k, v in self.signals}
        if self.exemplars:
            d["exemplars"] = list(self.exemplars)
        return d

    def line(self) -> str:
        """One stable human-grep-able line (debugging; the canonical
        byte-compared artifact is the JSON dump)."""
        parts = [f"seq={self.seq}", f"t={self.t:.6f}", f"loop={self.loop}",
                 f"tick={self.tick}", f"action={self.action}",
                 f"replicas={self.current}->{self.target}",
                 f"commit={self.commit}"]
        if self.trigger:
            parts.append(f"trigger={self.trigger}")
        if self.parent is not None:
            parts.append(f"parent={self.parent}")
        parts.append(f"reason={self.reason}")
        return " ".join(parts)


@dataclasses.dataclass(frozen=True)
class HorizonRecord:
    """One effect-horizon event for a committed decision: ``closing``
    ends the horizon (``event`` says why); a non-closing event marks
    intermediate progress (e.g. ``replicas_ready`` on an SLO-paged
    scale-up that still waits for the burn to recover)."""

    seq: int
    t: float
    loop: str
    decision: int                      # seq of the DecisionRecord
    event: str
    closing: bool

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "horizon", "seq": self.seq, "t": self.t,
                "loop": self.loop, "decision": self.decision,
                "event": self.event, "closing": self.closing}

    def line(self) -> str:
        return (f"seq={self.seq} t={self.t:.6f} loop={self.loop} "
                f"horizon decision={self.decision} event={self.event} "
                f"closing={int(self.closing)}")


Record = Union[DecisionRecord, HorizonRecord]


class _NoopLedger:
    """Ledger disabled: no clock reads, no locks, no allocation per call
    — bit-for-bit behavior-neutral, the same contract as the NOOP
    tracer (every determinism proof that predates the ledger survives
    running "with" it)."""

    __slots__ = ()
    enabled = False
    records: Tuple = ()

    def decision(self, **kw) -> None:
        return None

    def horizon(self, decision: int, *, loop: str, event: str,
                closing: bool) -> None:
        return None

    def open_horizons(self) -> int:
        return 0

    def lines(self) -> List[str]:
        return []

    def export(self) -> List[Dict[str, Any]]:
        return []

    def dump(self, path: str, extra: Optional[Dict[str, Any]] = None) -> None:
        raise RuntimeError("decision ledger is disabled (NOOP has no records)")


NOOP = _NoopLedger()


def ensure(ledger) -> Any:
    """The one idiom every kernel-carrying constructor uses:
    ``self.ledger = ensure(ledger)`` — None means disabled."""
    return NOOP if ledger is None else ledger


class DecisionLedger:
    """Append-only decision provenance (see module doc). ``clock`` is
    injectable — pass the driver's virtual clock and the whole ledger
    becomes a pure function of the seed. ``max_records`` bounds host
    RAM on a long-lived operator: past the cap, appends are counted in
    ``dropped`` instead of retained (the same retention posture as
    `obs/trace.Tracer.max_spans`).

    ``metrics`` is an optional `metrics.LedgerMetrics`: every decision
    increments ``decisions`` (labelled ``<loop>|<outcome-class>``),
    conflicts increment ``commit_failures``, and the
    ``open_effect_horizons`` gauge tracks decisions whose effect has
    not yet been observed — a climbing gauge means the loops are
    committing changes whose effects never land."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 metrics=None, max_records: int = 200_000) -> None:
        if max_records < 1:
            raise ValueError(f"max_records must be >= 1, got {max_records}")
        self.clock = clock
        self.metrics = metrics
        self.max_records = max_records
        self.records: List[Record] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._next_seq = 1
        self._open: Dict[int, str] = {}    # decision seq -> loop

    # ------------------------------------------------------------- recording
    def decision(self, *, loop: str, tick: int, action: str, current: int,
                 target: int, reason: str, commit: str = COMMIT_NONE,
                 trigger: str = "", parent: Optional[int] = None,
                 signals: Tuple[Tuple[str, str], ...] = (),
                 exemplars: Tuple[int, ...] = (),
                 horizon_open: bool = False) -> Optional[DecisionRecord]:
        """Record one decision; returns the record (None only from the
        NOOP ledger). ``horizon_open`` marks the decision as having an
        effect still to be observed — close it with ``horizon``."""
        t = self.clock()
        with self._lock:
            rec = DecisionRecord(
                seq=self._next_seq, t=t, loop=loop, tick=tick,
                action=action, current=current, target=target,
                reason=reason, commit=commit, trigger=trigger,
                parent=parent, signals=tuple(signals),
                exemplars=tuple(exemplars),
                horizon="open" if horizon_open else "none")
            self._next_seq += 1
            self._append_locked(rec)
            if horizon_open:
                self._open[rec.seq] = loop
            n_open = len(self._open)
        if self.metrics is not None:
            outcome = commit.split(":", 1)[0]
            if action == "skip":
                outcome = "skip"
            elif commit == COMMIT_NONE:
                outcome = "hold"
            self.metrics.inc("decisions", label=f"{loop}|{outcome}")
            if commit.startswith(COMMIT_CONFLICT):
                self.metrics.inc("commit_failures")
            self.metrics.set_gauge("open_effect_horizons", n_open)
        return rec

    def horizon(self, decision: int, *, loop: str, event: str,
                closing: bool) -> Optional[HorizonRecord]:
        """Record effect-horizon progress for a committed decision."""
        t = self.clock()
        with self._lock:
            rec = HorizonRecord(seq=self._next_seq, t=t, loop=loop,
                                decision=decision, event=event,
                                closing=closing)
            self._next_seq += 1
            self._append_locked(rec)
            if closing:
                self._open.pop(decision, None)
            n_open = len(self._open)
        if self.metrics is not None:
            self.metrics.set_gauge("open_effect_horizons", n_open)
        return rec

    def _append_locked(self, rec: Record) -> None:
        if len(self.records) < self.max_records:
            self.records.append(rec)
        else:
            self.dropped += 1

    # -------------------------------------------------------------- reading
    def open_horizons(self) -> int:
        with self._lock:
            return len(self._open)

    def export(self) -> List[Dict[str, Any]]:
        """Records as dicts, in append order (seq order — one counter)."""
        with self._lock:
            records = list(self.records)
        return [r.to_dict() for r in records]

    def lines(self) -> List[str]:
        with self._lock:
            records = list(self.records)
        return [r.line() for r in records]

    def dump(self, path: str,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Write the canonical ledger file. ``sort_keys`` + fixed
        separators + injected-clock timestamps only: two seeded runs
        produce byte-identical files. ``extra`` carries the sibling logs
        a report joins against (per-service SLO event logs, the chaos
        injector's sequence-stamped event log). File I/O happens outside the
        ledger lock. A ``.gz`` path gzips deterministically
        (`obs/dumpio.py`)."""
        from tpu_on_k8s_torch.obs.dumpio import open_dump
        doc: Dict[str, Any] = {"format": LEDGER_FORMAT,
                               "dropped": self.dropped,
                               "records": self.export()}
        if extra:
            doc.update(extra)
        with open_dump(path, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")


def load_ledger(path: str) -> Dict[str, Any]:
    """Read a ``DecisionLedger.dump`` file back (the whole doc — records
    plus any embedded sibling logs, ``.json`` or ``.json.gz``); raises
    ``ValueError`` on a file that is not a ledger dump."""
    from tpu_on_k8s_torch.obs.dumpio import open_dump
    with open_dump(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("format") != LEDGER_FORMAT:
        raise ValueError(f"{path} is not a {LEDGER_FORMAT} dump")
    return doc
