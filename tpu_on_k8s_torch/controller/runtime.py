"""Minimal controller runtime: workqueue, rate limiting, reconcile pump.

The role controller-runtime plays for the reference (workqueue → Reconcile cycle,
SURVEY §3.2 "hot loop"). Deterministic and synchronous-first: tests and the local
driver call ``Manager.run_until_idle()``; a background-thread mode exists for a
live deployment.
"""
from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, NamedTuple, Optional, Set, Tuple

from tpu_on_k8s_torch.utils.logging import get_logger

_log = get_logger("runtime")


class Request(NamedTuple):
    namespace: str
    name: str


@dataclass
class Result:
    requeue: bool = False
    requeue_after: Optional[float] = None  # seconds


class ExponentialBackoff:
    """Per-item exponential backoff (k8s DefaultItemBasedRateLimiter analog).
    Also the BackoffStatesQueue the reference uses to count job restarts
    (controllers/common/controller.go BackoffStatesQueue): ``failures`` is the
    retry count consulted by the backoff-limit termination check."""

    def __init__(self, base: float = 0.005, cap: float = 30.0) -> None:
        self.base = base
        self.cap = cap
        self._failures: Dict[Request, int] = {}
        self._lock = threading.Lock()

    def next_delay(self, item: Request) -> float:
        with self._lock:
            n = self._failures.get(item, 0)
            self._failures[item] = n + 1
        return min(self.base * (2 ** n), self.cap)

    def failures(self, item: Request) -> int:
        with self._lock:
            return self._failures.get(item, 0)

    def forget(self, item: Request) -> None:
        with self._lock:
            self._failures.pop(item, None)


class Workqueue:
    """Deduplicating delayed workqueue with get/done semantics: an item re-added
    while processing is marked dirty and re-queued on done()."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Condition()
        self._queue: List[Request] = []
        self._queued: Set[Request] = set()
        self._processing: Set[Request] = set()
        self._dirty: Set[Request] = set()
        self._delayed: List[Tuple[float, int, Request]] = []
        self._seq = 0

    def add(self, item: Request) -> None:
        with self._lock:
            if item in self._processing:
                self._dirty.add(item)
                return
            if item not in self._queued:
                self._queued.add(item)
                self._queue.append(item)
                self._lock.notify()

    def add_after(self, item: Request, delay: float) -> None:
        if delay <= 0:
            self.add(item)
            return
        with self._lock:
            self._seq += 1
            heapq.heappush(self._delayed, (self._clock() + delay, self._seq, item))

    def _promote_due(self) -> None:
        now = self._clock()
        while self._delayed and self._delayed[0][0] <= now:
            _, _, item = heapq.heappop(self._delayed)
            if item not in self._queued and item not in self._processing:
                self._queued.add(item)
                self._queue.append(item)
            elif item in self._processing:
                self._dirty.add(item)

    def try_get(self) -> Optional[Request]:
        with self._lock:
            self._promote_due()
            if not self._queue:
                return None
            item = self._queue.pop(0)
            self._queued.discard(item)
            self._processing.add(item)
            return item

    def done(self, item: Request) -> None:
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._dirty.discard(item)
                if item not in self._queued:
                    self._queued.add(item)
                    self._queue.append(item)

    def next_due_in(self) -> Optional[float]:
        with self._lock:
            self._promote_due()
            if self._queue:
                return 0.0
            if self._delayed:
                return max(0.0, self._delayed[0][0] - self._clock())
            return None

    def __len__(self) -> int:
        with self._lock:
            self._promote_due()
            return len(self._queue) + len(self._delayed)


@dataclass
class Controller:
    name: str
    reconcile: Callable[[Request], Result]
    queue: Workqueue = field(default_factory=Workqueue)
    rate_limiter: ExponentialBackoff = field(default_factory=ExponentialBackoff)

    def enqueue(self, namespace: str, name: str) -> None:
        self.queue.add(Request(namespace, name))

    def enqueue_after(self, namespace: str, name: str, delay: float) -> None:
        self.queue.add_after(Request(namespace, name), delay)

    def process_one(self) -> bool:
        item = self.queue.try_get()
        if item is None:
            return False
        try:
            result = self.reconcile(item)
        except Exception:
            self.queue.done(item)
            self.queue.add_after(item, self.rate_limiter.next_delay(item))
            raise
        self.queue.done(item)
        if result.requeue_after is not None:
            self.queue.add_after(item, result.requeue_after)
        elif result.requeue:
            self.queue.add_after(item, self.rate_limiter.next_delay(item))
        else:
            self.rate_limiter.forget(item)
        return True


class Manager:
    """Pumps all controllers to quiescence (tests / local driver) or runs them on
    worker threads (live mode)."""

    def __init__(self) -> None:
        self.controllers: List[Controller] = []
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def add_controller(self, controller: Controller) -> Controller:
        self.controllers.append(controller)
        return controller

    def run_until_idle(self, *, max_iterations: int = 10_000,
                       advance: Optional[Callable[[float], None]] = None) -> int:
        """Process work until every queue is empty (including delayed items if a
        test clock `advance` is provided). Returns reconcile count. Raises if the
        iteration budget is exhausted (reconcile livelock guard)."""
        processed = 0
        for _ in range(max_iterations):
            progressed = False
            for c in self.controllers:
                while c.process_one():
                    processed += 1
                    progressed = True
            if progressed:
                continue
            if advance is not None:
                dues = [d for d in (c.queue.next_due_in() for c in self.controllers)
                        if d is not None]
                if dues:
                    advance(min(dues) + 1e-6)
                    continue
            return processed
        raise RuntimeError(f"run_until_idle: no quiescence after {max_iterations} iterations")

    def start(self, workers_per_controller: int = 1) -> None:
        self._stop.clear()
        for c in self.controllers:
            for i in range(workers_per_controller):
                t = threading.Thread(target=self._worker, args=(c,), daemon=True,
                                     name=f"{c.name}-worker-{i}")
                t.start()
                self._threads.append(t)

    def _worker(self, c: Controller) -> None:
        while not self._stop.is_set():
            try:
                if not c.process_one():
                    due = c.queue.next_due_in()
                    self._stop.wait(min(due, 0.05) if due is not None else 0.05)
            # analyze: allow[silent-loss] process_one already re-queued the item with rate-limited backoff; logged here
            except Exception:  # reconcile errors are retried via backoff
                _log.exception("reconcile failed (will retry with backoff)",
                               extra={"kv": {"controller": c.name}})

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
