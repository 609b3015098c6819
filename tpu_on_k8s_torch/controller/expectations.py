"""Controller expectations: in-flight create/delete accounting (the
counterpart of ``tpu_on_k8s/controller/expectations.py``).

Analog of k8s ControllerExpectations as used by the reference
(controllers/common/expectations.go:29-66, keys built at
controllers/common/utils.go:29-36). A reconcile that creates N pods records
"expect N creations"; watch events decrement; until the count drains (or a TTL
expires) further reconciles are skipped — preventing double-creates when the
cache lags the API server.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict


def expectation_key(job_key: str, task_type: str, resource: str) -> str:
    """``{ns}/{job}/{taskType}/{pods|services}`` (reference utils.go:29-36)."""
    return f"{job_key}/{task_type.lower()}/{resource}"


@dataclass
class _Entry:
    adds: int = 0
    deletes: int = 0
    timestamp: float = 0.0


class Expectations:
    def __init__(self, ttl_seconds: float = 300.0,
                 clock=time.monotonic) -> None:
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self.ttl = ttl_seconds
        # TTL expiry reads an injectable clock so expectation timeouts are
        # steerable under the simulator's virtual time (ROADMAP item 5)
        self._clock = clock

    def expect_creations(self, key: str, count: int) -> None:
        with self._lock:
            self._entries[key] = _Entry(adds=count,
                                        timestamp=self._clock())

    def expect_deletions(self, key: str, count: int) -> None:
        with self._lock:
            self._entries[key] = _Entry(deletes=count,
                                        timestamp=self._clock())

    def creation_observed(self, key: str) -> None:
        self._observe(key, d_adds=-1)

    def deletion_observed(self, key: str) -> None:
        self._observe(key, d_deletes=-1)

    def _observe(self, key: str, d_adds: int = 0, d_deletes: int = 0) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            e.adds = max(0, e.adds + d_adds)
            e.deletes = max(0, e.deletes + d_deletes)

    def satisfied(self, key: str) -> bool:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return True
            if e.adds <= 0 and e.deletes <= 0:
                return True
            if self._clock() - e.timestamp > self.ttl:
                # Expired expectations are treated as satisfied so a lost watch
                # event cannot wedge the job forever.
                return True
            return False

    def delete_expectations(self, key_prefix: str) -> None:
        """Drop all expectations for a job (reference expectations.go:52-66)."""
        with self._lock:
            for k in [k for k in self._entries if k.startswith(key_prefix)]:
                del self._entries[k]
