"""Serving-load signals: one scrape of a fleet, and its observation line.

Counterpart of the part of ``tpu_on_k8s/autoscale/signals.py`` that the
serving plane emits through (``ServingFleet.observation_line`` and
``DisaggFleet.pool_observation_line``):

* ``FleetSample``: one scrape, the *new* latency observations since the
  previous scrape plus instantaneous load gauges. ``ok=False`` is a dead
  scrape: it carries no data and must never read as "zero load".
* ``FleetScraper``: delta reader over a live fleet. It tracks per-replica
  histogram read positions so each scrape sees only fresh observations
  (the mirror deques are cumulative and bounded).
* ``format_observation_line`` renders a sample as the extended
  ``[elastic-metrics]`` observation line, and ``sample_from_line`` parses
  one back into a ``FleetSample``.

Everything here is stdlib-only and deterministic: percentiles are
nearest-rank over sorted windows, sequence numbers are scrape counts, no
wall-clock enters a sample.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

#: the no-data sentinel in observation lines: ``latency=nan`` means "no
#: TTFT/queue sample exists yet" — parsers must map it to None, never 0.0
NO_DATA = float("nan")

_ACTIVE_REPLICA_STATES = ("starting", "ready", "draining")

#: the observation-line vocabulary
KV_RE = re.compile(r"(\w+)=([^\s]+)")
METRICS_TAG = "[elastic-metrics]"


@dataclasses.dataclass(frozen=True)
class FleetSample:
    """One scrape of the fleet. ``ttft`` / ``queue_wait`` are the NEW
    latency observations (seconds) since the previous scrape; the rest
    are instantaneous gauges. ``ok=False`` marks a dead scrape — every
    payload field is meaningless and the aggregator counts it toward
    staleness instead of folding it in."""

    seq: int
    ttft: Tuple[float, ...] = ()
    queue_wait: Tuple[float, ...] = ()
    tpot: Tuple[float, ...] = ()
    #: model swap-in latencies (seconds) since the previous scrape —
    #: multi-model replicas (`serve/modelpool.py`) mirror their pool's
    #: ``swap_seconds`` histogram into the replica metrics; swap-in is
    #: the pool's cold-start cost and a first-class scaling signal
    #: beside TTFT. Single-model fleets never populate it.
    swap: Tuple[float, ...] = ()
    queue_depth: int = 0
    inflight_tokens: int = 0
    slots: int = 0
    ready_replicas: int = 0
    ok: bool = True
    #: trace ids (`obs/trace.py` counter ids) of the newest retained
    #: TTFT exemplars at scrape time — the join key from this scrape's
    #: latency picture back to the request span trees that produced it
    #: (the decision ledger records these on every decision). Empty when
    #: tracing is off; the log-scrape plane leaves it empty too.
    exemplars: Tuple[int, ...] = ()


def percentile(values, q: float) -> Optional[float]:
    """Nearest-rank percentile; None on an empty set (no data is never
    a number). The ONE percentile definition every emitter and consumer
    of these signals shares — two formulas would make the log-scrape
    and in-process planes disagree on identical data."""
    vals = sorted(values)
    if not vals:
        return None
    idx = min(len(vals) - 1, max(0, math.ceil(q * len(vals)) - 1))
    return vals[idx]


class FleetScraper:
    """Delta reader over a live ``ServingFleet`` (duck-typed: anything
    with a ``replicas`` dict of objects carrying ``metrics`` /
    ``engine`` / ``outstanding`` / ``routable`` / ``state``). Each
    scrape returns only the latency observations appended since the
    previous one — the mirror deques are cumulative, and re-counting
    old samples would let one ancient breach scale the fleet forever."""

    def __init__(self) -> None:
        self._seen: Dict[Tuple[str, str], int] = {}
        self._seq = 0

    def scrape(self, fleet, seq: Optional[int] = None) -> FleetSample:
        """``seq`` lets the caller own the scrape numbering (the
        controller shares one counter across live scrapes AND dead
        ones, so outage ticks never make the sequence regress);
        standalone callers omit it and get the internal counter."""
        if seq is None:
            self._seq += 1
            seq = self._seq
        else:
            self._seq = seq
        ttft = []
        qwait = []
        tpot = []
        swap = []
        exemplars = []
        slots = 0
        inflight = 0
        ready = 0
        # bind once: a DisaggPool's ``replicas`` property takes the
        # fleet lock and rebuilds a filtered dict per access — one
        # snapshot here is one lock acquisition instead of N+1
        replicas = fleet.replicas
        for name in sorted(replicas):
            rep = replicas[name]
            state = getattr(rep.state, "value", str(rep.state))
            if state not in _ACTIVE_REPLICA_STATES:
                continue
            if rep.engine is not None:
                slots += getattr(rep.engine, "n_slots", 0)
            inflight += rep.outstanding
            ready += bool(rep.routable)
            if rep.metrics is None:
                continue
            for key, out in (("time_to_first_token_seconds", ttft),
                             ("queue_wait_seconds", qwait),
                             ("time_per_output_token_seconds", tpot),
                             # multi-model replicas mirror their pool's
                             # swap-in latency here; the mirror is a
                             # defaultdict, so plain fleets read empty
                             ("swap_seconds", swap)):
                # snapshot under the mirror lock: the gateway appends
                # from the driver thread while this scrape runs in the
                # autoscaler's. Position by the monotone observation
                # count, NOT len(): the mirror deque is bounded, and
                # len() freezes once it saturates — a length-based
                # cursor would go permanently blind on a fleet that has
                # served more than MIRROR_CAP requests.
                with rep.metrics._lock:
                    vals = list(rep.metrics.histograms[key])
                    total = rep.metrics.histogram_counts.get(key, 0)
                mark = (name, key)
                n = self._seen.get(mark, 0)
                if total < n:
                    n = 0      # metrics instance was reset: restart
                new = total - n
                if new > 0:
                    # samples beyond the deque's capacity rotated away
                    # before this scrape — take what survives
                    out.extend(vals[-min(new, len(vals)):])
                self._seen[mark] = total
            # newest retained TTFT exemplar trace ids (≤2 per replica):
            # the decision ledger's span join key. Not delta-read — the
            # exemplar deque carries no monotone count; "the freshest
            # evidence at scrape time" is exactly what a decision cites.
            # (duck-typed like the rest of the scrape: a bare-histogram
            # metrics stub simply contributes none)
            mirror = getattr(rep.metrics, "exemplars", None)
            if mirror is not None:
                with rep.metrics._lock:
                    tail = list(mirror["time_to_first_token_seconds"])[-2:]
                exemplars.extend(int(tid) for _, tid in tail
                                 if isinstance(tid, int))
        return FleetSample(
            seq=seq, ttft=tuple(ttft), queue_wait=tuple(qwait),
            tpot=tuple(tpot), swap=tuple(swap),
            queue_depth=fleet.queue_depth, inflight_tokens=inflight,
            slots=slots, ready_replicas=ready,
            exemplars=tuple(exemplars))


def format_observation_line(sample: FleetSample, *, epoch: int,
                            batch: int) -> str:
    """Render a ``FleetSample`` as the extended ElasticAutoscaler
    observation line — the ONE emitter behind
    ``ServingFleet.observation_line`` and
    ``DisaggFleet.pool_observation_line``, and the inverse of
    `sample_from_line` (the format is load-bearing: the log-scraping
    autoscaler plane parses it, so a field added here reaches every
    fleet type at once). With no latency sample of any kind the
    ``latency`` field carries the ``nan`` sentinel — "no data", which
    every parser maps to None, never "infinitely fast"."""
    def p95(vals) -> float:
        v = percentile(vals, 0.95)
        return NO_DATA if v is None else v

    src = sample.ttft or sample.queue_wait
    return (f"{METRICS_TAG} epoch={epoch} batch={batch} "
            f"latency={p95(src):.6f} accuracy=0.0 "
            f"queue_wait={p95(sample.queue_wait):.6f} "
            f"queue_depth={sample.queue_depth} "
            f"inflight={sample.inflight_tokens} "
            f"slots={sample.slots} ready={sample.ready_replicas} "
            f"tpot={p95(sample.tpot):.6f} swap={p95(sample.swap):.6f}")


def sample_from_line(line: str, seq: int) -> Optional[FleetSample]:
    """Parse one extended observation line (the
    ``ServingFleet.observation_line()`` format) into a ``FleetSample``;
    None if the line isn't one. The ``latency`` / ``queue_wait`` values
    are window percentiles the emitter already computed, so they enter
    the sample as single observations; the ``nan`` sentinel (and any
    non-finite or negative value) contributes NO observation — the
    whole point of the sentinel is that "no data yet" must never fold
    in as "latency 0"."""
    if METRICS_TAG not in line:
        return None
    fields = dict(KV_RE.findall(line))
    if "latency" not in fields:
        return None

    def _lat(key: str) -> Tuple[float, ...]:
        try:
            v = float(fields[key])
        except (KeyError, ValueError):
            return ()
        return (v,) if math.isfinite(v) and v >= 0.0 else ()

    def _int(key: str) -> int:
        try:
            v = int(float(fields[key]))
        except (KeyError, ValueError, OverflowError):
            return 0   # OverflowError: int(float("9e999"))
        return max(v, 0)

    return FleetSample(
        seq=seq, ttft=_lat("latency"), queue_wait=_lat("queue_wait"),
        tpot=_lat("tpot"), swap=_lat("swap"),
        queue_depth=_int("queue_depth"), inflight_tokens=_int("inflight"),
        slots=_int("slots"), ready_replicas=_int("ready"))
