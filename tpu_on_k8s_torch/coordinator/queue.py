"""Tenant queue: UID-keyed unit container with snapshot iteration (the
counterpart of ``tpu_on_k8s/coordinator/queue.py``).

Analog of pkg/coordinator/core/queue.go:28-121 — deliberately
NOT FIFO: the scheduling cycle scans a point-in-time snapshot and picks by
plugin score, so insertion order carries no meaning.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from tpu_on_k8s_torch.coordinator.types import QueueUnit


class Queue:
    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.RLock()
        self._units: Dict[str, QueueUnit] = {}  # uid → unit

    def add_or_update(self, unit: QueueUnit) -> None:
        with self._lock:
            self._units[unit.uid] = unit

    def remove(self, uid: str) -> Optional[QueueUnit]:
        with self._lock:
            return self._units.pop(uid, None)

    def get(self, uid: str) -> Optional[QueueUnit]:
        with self._lock:
            return self._units.get(uid)

    def __contains__(self, uid: str) -> bool:
        with self._lock:
            return uid in self._units

    def __len__(self) -> int:
        with self._lock:
            return len(self._units)

    def snapshot(self) -> List[QueueUnit]:
        """Point-in-time iteration copy (reference queue.go:97-101 iterator)."""
        with self._lock:
            return list(self._units.values())

    def total_tasks(self) -> int:
        """Pending task count — the WRR queue weight
        (reference core/policy.go:224-230 calculateQueueWeight)."""
        with self._lock:
            return sum(u.total_tasks() for u in self._units.values())
