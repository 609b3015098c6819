"""Trace export: Chrome trace-event / Perfetto JSON + the crash flight
recorder (the counterpart of ``tpu_on_k8s/obs/export.py``).

Two consumers of the span substrate (`obs/trace.py`):

* **Offline analysis** — ``to_chrome_trace`` renders finished spans as
  the Chrome trace-event format (``chrome://tracing`` / Perfetto /
  ``ui.perfetto.dev`` all load it): one complete ``"X"`` event per span
  (tracks keyed by trace id so one request's whole life reads as one
  row), one instant ``"i"`` event per span event (first token, chaos
  injection, replay). Deterministic: events sort by (ts, span id), no
  wall-clock metadata.

* **Crash forensics** — ``FlightRecorder``: a bounded ring of the most
  recently finished spans, dumped to a file when something dies
  (``EngineCrashError`` recovery, ``RETRY_EXHAUSTED`` finalization —
  the gateway/disagg fleet call ``tracer.crash_dump(reason)``). The
  ring costs O(capacity) host RAM forever; the dump is the last N spans
  of context an operator needs to see *what the engine was doing when
  it died* without having traced the whole run. Dump filenames are
  sequence-numbered, never timestamped — a seeded chaos run produces
  the same filenames every time.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional

from tpu_on_k8s_torch.obs.trace import Span, TRACE_FORMAT


def _as_dict(span) -> Dict[str, Any]:
    return span.to_dict() if isinstance(span, Span) else dict(span)


def to_chrome_trace(spans: Iterable, *, service: str = "tpu-on-k8s"
                    ) -> Dict[str, Any]:
    """Render spans (``Span`` objects or their dicts) as a Chrome
    trace-event document. Timestamps convert to microseconds (the
    format's unit); the ``tid`` is the trace id, so every span of one
    request stacks on one named track."""
    events: List[Dict[str, Any]] = []
    for s in map(_as_dict, spans):
        if not s or s.get("end") is None:
            continue
        ts = s["start"] * 1e6
        args = dict(s.get("attrs", {}))
        args["span"] = s["span"]
        if s.get("parent") is not None:
            args["parent"] = s["parent"]
        if s.get("status") not in (None, "ok"):
            args["status"] = s["status"]
        events.append({
            "ph": "X", "name": s["name"], "cat": "span",
            "pid": 1, "tid": s["trace"],
            "ts": round(ts, 3), "dur": round((s["end"] - s["start"]) * 1e6, 3),
            "args": args,
        })
        for ev in s.get("events", ()):
            events.append({
                "ph": "i", "name": ev["name"], "cat": "event",
                "pid": 1, "tid": s["trace"], "s": "t",
                "ts": round(ev["t"] * 1e6, 3),
                "args": dict(ev.get("attrs", {}), span=s["span"]),
            })
    events.sort(key=lambda e: (e["ts"], e["args"].get("span", 0),
                               0 if e["ph"] == "X" else 1))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"service": service, "format": TRACE_FORMAT}}


def dump_chrome_trace(spans: Iterable, path: str, *,
                      service: str = "tpu-on-k8s") -> None:
    doc = to_chrome_trace(spans, service=service)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
        f.write("\n")


def load_trace(path: str) -> List[Dict[str, Any]]:
    """Read a ``Tracer.dump`` file back into span dicts (what
    `tools/trace_report.py` consumes), ``.json`` or ``.json.gz``;
    raises ``ValueError`` on a file that is not a trace dump."""
    from tpu_on_k8s_torch.obs.dumpio import open_dump
    with open_dump(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("format") != TRACE_FORMAT:
        raise ValueError(f"{path} is not a {TRACE_FORMAT} dump")
    return doc["spans"]


class FlightRecorder:
    """Bounded ring of recently finished spans + the crash-dump writer.

    ``capacity`` bounds host RAM (spans are stored as their export
    dicts — no live references pinning engines or request records).
    ``directory`` is where dumps land; with ``None`` the recorder still
    rings (tests read ``snapshot()``) but ``dump`` returns None."""

    def __init__(self, capacity: int = 512,
                 directory: Optional[str] = None,
                 prefix: str = "flightrec") -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.directory = directory
        self.prefix = prefix
        self.dumps: List[str] = []
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, span) -> None:
        with self._lock:
            self._ring.append(_as_dict(span))

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str) -> Optional[str]:
        """Persist the ring as one JSON artifact. The filename carries a
        sequence number and the (sanitized) reason — stable across
        seeded replays, unique within a process (this counter is the
        ONE allocator; `Tracer.crash_dump` delegates here, so mixed
        direct/tracer dumps can never collide on a path)."""
        with self._lock:
            spans = list(self._ring)
            self._seq += 1
            seq = self._seq
        if self.directory is None:
            return None
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason) or "unknown"
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f"{self.prefix}-{seq:04d}-{safe}.json")
        doc = {"format": TRACE_FORMAT, "reason": reason, "seq": seq,
               "spans": spans}
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        self.dumps.append(path)
        return path
