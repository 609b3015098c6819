"""Decision ledger: one provenance record for every control-loop decision.

The part of ``tpu_on_k8s/obs/ledger.py`` that ``serve/modelpool.py`` uses
(it records every model swap and eviction):

* ``DecisionRecord``: one loop decision, typed: the loop id, the
  loop-local observation tick, the observed signals (pre-formatted
  strings, so the serialized form is stable by construction), the
  triggering chaos event, a parent link to the loop's previous committed
  decision, the decide outcome (action, current to target, reason) and
  the commit outcome: ``landed`` or ``conflict:<Type>`` (the change never
  happened).
* ``DecisionLedger``: an injectable-clock, append-only record list with
  one monotone sequence counter. Ids come from the counter and timestamps
  from the injected clock, so two runs of the same seeded trace produce
  byte-identical ``lines()``.
* ``NOOP``: the disabled ledger. Every record method no-ops and returns
  None and reads no clock: a loop running without a ledger behaves bit
  for bit as it would without one.

Stdlib-only.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List, Optional, Tuple

# ------------------------------------------------------------ commit outcomes
#: decide held / skipped: nothing was executed
COMMIT_NONE = "none"
#: the change landed
COMMIT_LANDED = "landed"
#: prefix of "the change did not land" outcomes (``conflict:<ExcType>``)
COMMIT_CONFLICT = "conflict"


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One control-loop decision (see module doc). ``signals`` are
    pre-formatted ``(key, value)`` string pairs — formatting at record
    time is what makes the serialized ledger stable by construction."""

    seq: int
    t: float
    loop: str
    tick: int
    action: str
    current: int
    target: int
    reason: str
    commit: str = COMMIT_NONE
    trigger: str = ""                 # "chaos#N" | ""
    parent: Optional[int] = None      # seq of the loop's previous commit
    signals: Tuple[Tuple[str, str], ...] = ()

    def line(self) -> str:
        """One stable human-grep-able line."""
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


class _NoopLedger:
    """Ledger disabled: no clock reads, no locks, no allocation per call
    — bit-for-bit behavior-neutral."""

    __slots__ = ()
    enabled = False
    records: Tuple = ()

    def decision(self, **kw) -> None:
        return None

    def lines(self) -> List[str]:
        return []


NOOP = _NoopLedger()


def ensure(ledger):
    """The one idiom every ledger-carrying constructor uses:
    ``self.ledger = ensure(ledger)`` — None means disabled."""
    return NOOP if ledger is None else ledger


class DecisionLedger:
    """Append-only decision provenance (see module doc). ``clock`` is
    injectable — pass the driver's virtual clock and the whole ledger
    becomes a pure function of the seed."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self.clock = clock
        self.records: List[DecisionRecord] = []
        self._lock = threading.Lock()
        self._next_seq = 1

    def decision(self, *, loop: str, tick: int, action: str, current: int,
                 target: int, reason: str, commit: str = COMMIT_NONE,
                 trigger: str = "", parent: Optional[int] = None,
                 signals: Tuple[Tuple[str, str], ...] = ()
                 ) -> DecisionRecord:
        """Record one decision and return it."""
        t = self.clock()
        with self._lock:
            rec = DecisionRecord(
                seq=self._next_seq, t=t, loop=loop, tick=tick,
                action=action, current=current, target=target,
                reason=reason, commit=commit, trigger=trigger,
                parent=parent, signals=tuple(signals))
            self._next_seq += 1
            self.records.append(rec)
        return rec

    def lines(self) -> List[str]:
        with self._lock:
            records = list(self.records)
        return [r.line() for r in records]
