"""Smooth weighted round-robin: the coordinator's selection core.

Counterpart of ``SmoothWRR`` in ``tpu_on_k8s/coordinator/policy.py``, the
part that the serving plane reuses (the gateway's tenant scheduler,
``serve/scheduler.py``, and the router's version split, ``serve/router.py``).
The ``Queue``-based selectors belong to the coordinator, which this package
does not carry yet.
"""
from __future__ import annotations

from typing import Dict, Optional


class SmoothWRR:
    """The smooth-WRR core (nginx algorithm), detached from ``Queue``: each
    pick adds every candidate's weight to its running current-weight, picks
    the max, then subtracts the total from the winner, so a {5,1,1}
    weighting yields a-b-a-a-c-a-a instead of bursts. State for vanished
    keys is dropped so a departed tenant's debt doesn't linger. NOT
    thread-safe; callers hold their own lock."""

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
