"""QPS-limited event recording, coalesced per object (reference
pkg/utils/flowcontrol/recorder.go:33-115).

Controllers can emit bursts of identical events (every reconcile of a stuck
job); the reference wraps its EventRecorder in a token bucket keyed by object
UID. Same here: a per-key token bucket in front of the cluster's
``record_event``, dropping (not queueing) excess — events are best-effort
diagnostics, backpressure would be worse.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict


class TokenBucket:
    def __init__(self, qps: float, burst: int,
                 clock: Callable[[], float] = time.monotonic):
        self.qps = qps
        self.burst = burst
        self.clock = clock
        self.tokens = float(burst)
        self.last = clock()

    def allow(self) -> bool:
        now = self.clock()
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.qps)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class FlowControlRecorder:
    """Rate-limits ``record_event(obj, etype, reason, message)`` per object."""

    def __init__(self, cluster: Any, qps: float = 1.0, burst: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self.cluster = cluster
        self.qps = qps
        self.burst = burst
        self.clock = clock
        self._buckets: Dict[str, TokenBucket] = {}
        self._lock = threading.Lock()
        self.dropped = 0

    def _key(self, obj: Any) -> str:
        meta = getattr(obj, "metadata", None)
        uid = getattr(meta, "uid", None) if meta is not None else None
        if uid:
            return str(uid)
        if meta is not None:
            return f"{getattr(meta, 'namespace', '')}/{getattr(meta, 'name', '')}"
        return repr(obj)

    def record_event(self, obj: Any, etype: str, reason: str,
                     message: str) -> bool:
        """True if emitted, False if rate-limited away."""
        key = self._key(obj)
        with self._lock:
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = TokenBucket(
                    self.qps, self.burst, self.clock)
            allowed = bucket.allow()
            if not allowed:
                self.dropped += 1
        if allowed:
            self.cluster.record_event(obj, etype, reason, message)
        return allowed
