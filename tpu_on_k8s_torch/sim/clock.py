"""Discrete-event core of the digital twin (a copy of
``tpu_on_k8s/sim/clock.py``): a virtual clock plus an event loop that
JUMPS the clock to the next due event instead of ticking fixed periods.

This is the whole >1000x-real-time trick: a 24-virtual-hour scenario
costs wall time proportional to its EVENT count (~one per request
completion plus the control-loop cadences), not to its 86 400 virtual
seconds. Every component — autoscalers, SLO engine, tracer, ledger,
reconciler workqueues — reads the same `SimClock` through the clock
injection seams, so the twin's artifacts are stamped on one coherent
virtual timeline.

Determinism: the heap orders events by ``(time, insertion sequence)``,
so same-time events fire in the order they were scheduled — no set or
dict iteration, no identity comparison, nothing the process layout can
perturb. The loop never reads wall-clock (``tests/test_torch_package.py``
holds ``sim/`` to that); wall timing is the *driver's* concern
(``twin_soak`` injects ``time.perf_counter`` into the harness).
"""
from __future__ import annotations

import heapq
from typing import Callable, List, Optional, Tuple


class SimClock:
    """The twin's virtual clock: callable (``clock()`` → seconds, the
    protocol every injectable-clock seam in the repo expects) and
    advanced only by the event loop or an explicit ``advance`` — the
    same shape as ``serve_load``'s driver clock, importable."""

    __slots__ = ("t",)

    def __init__(self, t0: float = 0.0) -> None:
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.t += dt


class EventLoop:
    """A minimal deterministic discrete-event scheduler.

    ``at(t, fn)`` schedules ``fn`` (no arguments — close over state) at
    virtual time ``t``; ``run(until=...)`` pops events in ``(t, seq)``
    order, sets the clock to each event's time, and calls it. Events
    may schedule further events (including at the current instant —
    they run after everything already due, in scheduling order).
    """

    __slots__ = ("clock", "events_processed", "_heap", "_seq")

    def __init__(self, clock: Optional[SimClock] = None) -> None:
        self.clock = clock if clock is not None else SimClock()
        self.events_processed = 0
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0

    def at(self, t: float, fn: Callable[[], None]) -> None:
        if t < self.clock.t:
            raise ValueError(
                f"event at t={t} is in the past (now={self.clock.t})")
        heapq.heappush(self._heap, (float(t), self._seq, fn))
        self._seq += 1

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.clock.t + dt, fn)

    def every(self, period: float, fn: Callable[[], None], *,
              start_at: Optional[float] = None,
              until: Optional[float] = None) -> None:
        """A fixed-cadence event chain: ``fn`` at ``start_at`` (default
        one period from now), then every ``period``, stopping once the
        next firing would land past ``until``. The control loops ride
        this — their cadence is part of the scenario, the clock still
        only ever jumps between due instants."""
        if period <= 0:
            raise ValueError(f"period must be > 0, got {period}")
        first = self.clock.t + period if start_at is None else start_at

        def fire() -> None:
            fn()
            nxt = self.clock.t + period
            if until is None or nxt <= until:
                self.at(nxt, fire)

        if until is None or first <= until:
            self.at(first, fire)

    def next_due(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    @property
    def pending(self) -> int:
        return len(self._heap)

    def run(self, until: Optional[float] = None) -> int:
        """Drain due events (all of them, or those at ``t <= until``),
        jumping the clock to each; with ``until`` set the clock lands
        exactly there even if the heap ran dry earlier. Returns the
        number of events processed by this call."""
        n0 = self.events_processed
        heap = self._heap
        while heap:
            t, _, fn = heap[0]
            if until is not None and t > until:
                break
            heapq.heappop(heap)
            if t > self.clock.t:
                self.clock.t = t
            fn()
            self.events_processed += 1
        if until is not None and self.clock.t < until:
            self.clock.t = until
        return self.events_processed - n0
