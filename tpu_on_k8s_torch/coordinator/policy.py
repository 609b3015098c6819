"""Queue-selection policies: round-robin and smooth weighted round-robin
(the counterpart of ``tpu_on_k8s/coordinator/policy.py``).

Analog of pkg/coordinator/core/policy.go — RoundRobin (:31-76)
and WeightedRoundRobin (:80-230, the classic nginx gcd/maxWeight scan). Two
deliberate upgrades over the reference:

* WRR is actually wired in as the default (the reference built it but left
  plain RR in the ctor — coordinator.go:62, SURVEY §2.7 note);
* the weighted variant is *smooth* WRR (the reference's own TODO at
  policy.go:232): each pick adds weight to a running current-weight and picks
  the max, so a {5,1,1} weighting yields a-b-a-a-c-a-a instead of bursts.

Weight = total pending task count in the queue (calculateQueueWeight,
policy.go:224-230), recomputed every pick so weights track queue churn.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Protocol

from tpu_on_k8s_torch.coordinator.queue import Queue


class QueueSelector(Protocol):
    def next(self, queues: List[Queue]) -> Optional[Queue]: ...


class SmoothWRR:
    """The smooth-WRR core (nginx algorithm), detached from ``Queue`` so the
    serving gateway's tenant scheduler (`serve/scheduler.py`) can
    reuse the exact policy the coordinator runs: each pick adds every
    candidate's weight to its running current-weight, picks the max, then
    subtracts the total from the winner — a {5,1,1} weighting yields
    a-b-a-a-c-a-a instead of bursts. State for vanished keys is dropped so
    a departed tenant's debt doesn't linger. NOT thread-safe; callers hold
    their own lock (both users already do)."""

    def __init__(self) -> None:
        self._current: Dict[str, float] = {}

    def pick(self, weights: Dict[str, float]) -> Optional[str]:
        if not weights:
            return None
        total = sum(weights.values())
        self._current = {k: v for k, v in self._current.items()
                         if k in weights}
        best: Optional[str] = None
        for key in sorted(weights):
            cur = self._current.get(key, 0.0) + weights[key]
            self._current[key] = cur
            if best is None or cur > self._current[best]:
                best = key
        self._current[best] -= total
        return best


class RoundRobinSelector:
    """Plain RR over queue names (policy.go:31-76)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._last: Optional[str] = None

    def next(self, queues: List[Queue]) -> Optional[Queue]:
        candidates = [q for q in queues if len(q) > 0]
        if not candidates:
            return None
        candidates.sort(key=lambda q: q.name)
        with self._lock:
            names = [q.name for q in candidates]
            if self._last is None or self._last not in names:
                pick = candidates[0]
            else:
                pick = candidates[(names.index(self._last) + 1) % len(candidates)]
            self._last = pick.name
            return pick


class SmoothWeightedRoundRobinSelector:
    """Smooth WRR (nginx algorithm): current[i] += weight[i]; pick max;
    current[pick] -= total. Weight = pending task count, floored at 1 so a
    queue of zero-task units still drains."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._wrr = SmoothWRR()

    def next(self, queues: List[Queue]) -> Optional[Queue]:
        candidates = {q.name: q for q in queues if len(q) > 0}
        if not candidates:
            return None
        with self._lock:
            weights = {name: float(max(q.total_tasks(), 1))
                       for name, q in candidates.items()}
            return candidates[self._wrr.pick(weights)]
