"""Deterministic spans: a copy of ``tpu_on_k8s/obs/trace.py``, which the
port may not import.

``Span`` is one named interval with counter-derived ids, timestamps from
an injectable clock, ordered attributes and point-in-time events;
``Tracer`` mints spans under a lock from one monotone counter and
collects them as they finish (``export``, ``dump``); ``NOOP`` is the
disabled tracer, which reads no clock and allocates nothing per call, and
``ensure(tracer)`` is the idiom every instrumented constructor uses. The
training loop (``train/loop.py``) emits one ``train.window`` span per
host-sync window. Two runs of the same seeded call sequence under the
same clock dump byte-identical files. Stdlib only.
"""
from __future__ import annotations

import contextlib
import gzip
import io
import json
import threading
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence)

#: terminal statuses a span may carry; anything else is treated as a
#: domain-specific status string (e.g. a RequestState value)
STATUS_OK = "ok"
STATUS_ERROR = "error"


class Span:
    """One interval on the trace timeline. Mutate only through ``set`` /
    ``event`` / ``finish`` — the exporter reads the fields directly."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "status", "attrs", "events", "_tracer")

    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 span_id: int, parent_id: Optional[int], start: float,
                 attrs: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: Optional[float] = None
        self.status: str = STATUS_OK
        self.attrs = attrs
        self.events: List[Dict[str, Any]] = []

    # ------------------------------------------------------------- recording
    def set(self, **attrs: Any) -> "Span":
        """Attach/overwrite attributes (insertion-ordered)."""
        self.attrs.update(attrs)
        return self

    def event(self, name: str, /, at: Optional[float] = None,
              **attrs: Any) -> "Span":
        """A point-in-time marker on this span's timeline (first token,
        chaos injection, replay decision). ``at`` backdates the marker —
        the digital twin mints a request's whole span tree at its
        completion event, stamping each point from the virtual timeline
        it already computed."""
        ev: Dict[str, Any] = {"name": name,
                              "t": self._tracer.clock() if at is None
                              else at}
        if attrs:
            ev["attrs"] = attrs
        self.events.append(ev)
        return self

    def finish(self, status: str = STATUS_OK,
               at: Optional[float] = None) -> "Span":
        """End the span exactly once (idempotent — a finalize racing a
        crash sweep keeps the first verdict, mirroring
        `serve/lifecycle.finalize`)."""
        if self.end is not None:
            return self
        self.end = self._tracer.clock() if at is None else at
        self.status = status
        self._tracer._collect(self)
        return self

    # -------------------------------------------------------------- plumbing
    @property
    def finished(self) -> bool:
        return self.end is not None

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start

    def to_dict(self) -> Dict[str, Any]:
        """The canonical export form (what ``--trace-out`` files hold and
        `tools/trace_report.py` consumes)."""
        d: Dict[str, Any] = {
            "name": self.name, "trace": self.trace_id,
            "span": self.span_id, "parent": self.parent_id,
            "start": self.start, "end": self.end, "status": self.status,
        }
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.events:
            d["events"] = list(self.events)
        return d

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.finish(STATUS_ERROR if exc_type is not None else STATUS_OK)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Span({self.name!r} trace={self.trace_id} "
                f"span={self.span_id} status={self.status})")


class _NoopSpan:
    """The inert span the disabled tracer hands out: every method no-ops
    and returns self, so instrumented call sites never branch."""

    __slots__ = ()
    name = ""
    trace_id = 0
    span_id = 0
    parent_id = None
    start = 0.0
    end = 0.0
    status = STATUS_OK
    attrs: Dict[str, Any] = {}
    events: List[Dict[str, Any]] = []
    finished = True
    duration = 0.0

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def event(self, name: str, /, at: Optional[float] = None,
              **attrs: Any) -> "_NoopSpan":
        return self

    def finish(self, status: str = STATUS_OK,
               at: Optional[float] = None) -> "_NoopSpan":
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {}

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class _NoopTracer:
    """Tracing disabled: no clock reads, no locks, no allocation per
    call — bit-for-bit behavior-neutral (the property every existing
    determinism proof depends on)."""

    __slots__ = ()
    enabled = False
    recorder = None

    def clock(self) -> float:
        return 0.0

    def start(self, name: str, /, parent: Any = None,
              at: Optional[float] = None, **attrs: Any) -> _NoopSpan:
        return NOOP_SPAN

    def keep(self, span: Any) -> None:
        return None

    def is_sampled(self, trace_id: int) -> bool:
        return False

    @contextlib.contextmanager
    def span(self, name: str, /, parent: Any = None, **attrs: Any
             ) -> Iterator[_NoopSpan]:
        yield NOOP_SPAN

    def crash_dump(self, reason: str) -> Optional[str]:
        return None

    def export(self) -> List[Dict[str, Any]]:
        return []

    def dump(self, path: str) -> None:
        raise RuntimeError("tracing is disabled (NOOP tracer has no spans)")


NOOP = _NoopTracer()


def ensure(tracer: Optional["Tracer"]):
    """The one idiom every instrumented constructor uses:
    ``self._tracer = ensure(tracer)`` — None means disabled."""
    return NOOP if tracer is None else tracer


class Tracer:
    """Mints and collects spans. ``clock`` is injectable (pass the same
    virtual clock the fleet runs on and the whole dump becomes a pure
    function of the seed); span/trace ids come from one monotone counter
    under the tracer lock, so id assignment is deterministic whenever the
    call sequence is (every seeded closed-loop caller is single-threaded).

    ``max_spans`` bounds retention: a long-lived server must not grow an
    unbounded span list — past the cap, finished spans still feed the
    flight recorder's ring (which is the crash artifact) but are dropped
    from the export list, and ``dropped`` counts them.

    ``sample_every`` is the head-sampling knob a million-request twin
    run needs: keep every Nth root whose name is in ``sample_names``
    (and its whole trace); shed the rest at collect time, counted by
    ``sampled_out``. ``keep(span)`` pins a trace regardless of the
    sample phase — the twin pins SLO-breaching and chaos-adjacent
    traces so every exemplar a page cites still resolves in the dump.
    Sampling decides *retention only*: ids and clock reads are
    allocated identically either way, so a sampled run's kept spans are
    byte-identical to the same spans of an unsampled run, and the
    default (``sample_every=1``) is exactly the pre-knob tracer."""

    enabled = True

    def __init__(self, clock: Callable[[], float] = time.monotonic, *,
                 recorder=None, service: str = "tpu-on-k8s",
                 max_spans: int = 200_000, sample_every: int = 1,
                 sample_names: Sequence[str] = ("request",)) -> None:
        if max_spans < 1:
            raise ValueError(f"max_spans must be >= 1, got {max_spans}")
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}")
        self.clock = clock
        self.service = service
        self.recorder = recorder
        self.max_spans = max_spans
        self.sample_every = int(sample_every)
        self.sample_names = tuple(sample_names)
        self.spans: List[Span] = []       # finished spans, in finish order
        self.dropped = 0
        self.sampled_out = 0              # spans shed by the sampling knob
        self._lock = threading.Lock()
        self._next_id = 1
        self._sampled_roots = 0           # roots subject to the knob so far
        self._unsampled: set = set()      # live trace ids being shed

    # ---------------------------------------------------------------- spans
    def start(self, name: str, /, parent: Optional[Span] = None,
              at: Optional[float] = None, **attrs: Any) -> Span:
        """Begin a span. With ``parent`` the new span joins its trace;
        without, it roots a new trace whose id IS the span id (counter-
        derived — no uuid, no wall clock). ``at`` backdates the start
        (the twin mints finished timelines); id allocation and the
        sampling decision are unaffected by it."""
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            root = parent is None or not parent.trace_id
            if root and self.sample_every > 1 \
                    and name in self.sample_names:
                self._sampled_roots += 1
                if (self._sampled_roots - 1) % self.sample_every != 0:
                    self._unsampled.add(sid)
        if not root:
            tid, pid = parent.trace_id, parent.span_id
        else:
            tid, pid = sid, None
        return Span(self, name, tid, sid, pid,
                    self.clock() if at is None else at, dict(attrs))

    @contextlib.contextmanager
    def span(self, name: str, /, parent: Optional[Span] = None,
             **attrs: Any) -> Iterator[Span]:
        """``with tracer.span("autoscale.tick", svc=key) as sp: ...`` —
        finishes ``error`` if the body raises."""
        sp = self.start(name, parent, **attrs)
        try:
            yield sp
        except BaseException:
            sp.finish(STATUS_ERROR)
            raise
        sp.finish()

    def keep(self, span) -> None:
        """Pin a trace through the sampling knob: the SLO-page /
        chaos-adjacent escape hatch. Accepts a span or a trace id; must
        be called before the trace's spans finish (shed spans are gone,
        not resurrectable). No-op when the trace is already kept."""
        tid = span if isinstance(span, int) else span.trace_id
        with self._lock:
            self._unsampled.discard(tid)

    def is_sampled(self, trace_id: int) -> bool:
        """False while the sampling knob is shedding this trace — the
        gate exemplar emission sits behind, so metrics never cite a
        trace id the dump will not contain."""
        with self._lock:
            return trace_id not in self._unsampled

    def _collect(self, span: Span) -> None:
        with self._lock:
            if span.trace_id in self._unsampled:
                self.sampled_out += 1
                if span.span_id == span.trace_id:
                    # the root is the last word on its trace: once it
                    # collects, drop the shed-set entry so memory stays
                    # bounded by LIVE traces, not all traces ever shed
                    self._unsampled.discard(span.trace_id)
                return
            if len(self.spans) < self.max_spans:
                self.spans.append(span)
            else:
                self.dropped += 1
        if self.recorder is not None:
            self.recorder.record(span)

    # --------------------------------------------------------------- export
    def export(self) -> List[Dict[str, Any]]:
        """Finished spans as dicts, sorted by (trace, span) id — the
        deterministic order, independent of finish-order ties."""
        with self._lock:
            spans = list(self.spans)
        return [s.to_dict()
                for s in sorted(spans, key=lambda s: (s.trace_id,
                                                      s.span_id))]

    def dump(self, path: str) -> None:
        """Write the canonical trace file. ``sort_keys`` + fixed
        separators + no wall-clock metadata: two seeded runs produce
        byte-identical files. A ``.gz`` path gzips deterministically
        (no timestamp, no file name in the header): the compressed bytes
        stay a pure function of the spans."""
        doc = {"format": TRACE_FORMAT, "service": self.service,
               "dropped": self.dropped, "spans": self.export()}
        with _open_dump(path) as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")

    def crash_dump(self, reason: str) -> Optional[str]:
        """Flight-recorder dump hook (engine crash, retry exhaustion):
        persists the ring of recent spans if a recorder with a directory
        is attached; returns the written path (None otherwise). Sequence
        allocation belongs to the recorder — it is the one counter all
        dump paths share, so filenames never collide."""
        if self.recorder is None:
            return None
        return self.recorder.dump(reason)


#: the trace-file format tag `tools/trace_report.py` checks
TRACE_FORMAT = "tpu-on-k8s-trace/v1"


def _open_dump(path: str):
    """A text writer onto ``path``; a ``.gz`` path gets a gzip member with
    mtime 0 and no embedded name, so equal spans give equal bytes."""
    if not str(path).endswith(".gz"):
        return open(path, "w")
    return io.TextIOWrapper(gzip.GzipFile(filename="", mode="wb",
                                          fileobj=open(path, "wb"), mtime=0),
                            encoding="utf-8", newline="")
