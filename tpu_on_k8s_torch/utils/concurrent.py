"""Bounded-concurrency helpers (reference pkg/utils/concurrent/semaphore.go).

The reference bounds all bulk pod operations with a channel semaphore +
waitgroup (widths 10/50/100 — victim cleanup, failover deletes, scale
restarts). Here the same shape as a thread-pool map that a live GKE backend
uses for bulk API calls; the in-memory reconcilers stay synchronous.
"""
from __future__ import annotations

import concurrent.futures
import threading
from typing import Callable, Iterable, List, Optional, Tuple, TypeVar

T = TypeVar("T")
R = TypeVar("R")


class Semaphore:
    """Counting semaphore + waitgroup in one (semaphore.go:21-45)."""

    def __init__(self, width: int):
        self._sem = threading.Semaphore(width)
        self._pending = 0
        self._lock = threading.Condition()

    def acquire(self) -> None:
        self._sem.acquire()
        with self._lock:
            self._pending += 1

    def release(self) -> None:
        self._sem.release()
        with self._lock:
            self._pending -= 1
            if self._pending == 0:
                self._lock.notify_all()

    def wait(self) -> None:
        """Block until every acquired slot has been released."""
        with self._lock:
            while self._pending:
                self._lock.wait()


def bounded_map(fn: Callable[[T], R], items: Iterable[T], width: int,
                ) -> List[Tuple[Optional[R], Optional[BaseException]]]:
    """Run ``fn`` over items with at most ``width`` in flight; returns
    (result, error) pairs in input order — bulk ops tolerate partial failure
    the way the reference's semaphore loops do."""
    items = list(items)
    out: List[Tuple[Optional[R], Optional[BaseException]]] = [(None, None)] * len(items)
    if not items:
        return out
    with concurrent.futures.ThreadPoolExecutor(max_workers=width) as pool:
        # analyze: allow[thread-roots] fn is this helper's parameter — each bounded_map CALLER is recorded as the spawn-through root with its real fn
        futures = {pool.submit(fn, item): i for i, item in enumerate(items)}
        for fut in concurrent.futures.as_completed(futures):
            i = futures[fut]
            try:
                out[i] = (fut.result(), None)
            # analyze: allow[silent-loss] the exception is returned to the caller in the (result, error) tuple
            except BaseException as e:  # noqa: BLE001 — collected, not raised
                out[i] = (None, e)
    return out
