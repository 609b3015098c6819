"""TTFT critical-path report over a span dump (``obs/trace.py`` format): a
copy of the reference's ``tools/trace_report.py`` on the port's
``obs/export.load_trace`` and ``autoscale/signals.percentile``.

The span substrate records every request as one trace: a ``request`` root
whose phase children are ``queue`` → (``decode`` | ``prefill`` →
``handoff`` → ``decode``). This report decomposes each request's
time-to-first-token into exactly those segments: a TTFT regression is
queue-wait OR prefill OR handoff-queue OR decode, and the answer differs
per request.

Anchoring: a request's critical path ends at its first *decoded* token —
the ``first_decode_token`` event a disaggregated decode replica emits —
falling back to the ``first_token`` event (the client-visible streaming
TTFT; in monolithic serving the two coincide). Segments are the phase
spans clipped to ``[root.start, anchor]``; because every phase boundary
is one injected-clock read, segments tile the window exactly and the
per-request residual (``ttft - sum(segments)``) is the report's built-in
clock-tolerance check.

Usage:
    python -m tpu_on_k8s_torch.obs.trace_report TRACE.json         # summary
    python -m tpu_on_k8s_torch.obs.trace_report TRACE.json --json  # JSON
    python -m tpu_on_k8s_torch.obs.trace_report TRACE.json --top 5

``TRACE.json`` is what ``Tracer.dump`` / ``serve_load --trace-out``
writes. Exit 0 always on a well-formed dump — this is a report, not a
gate.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

from tpu_on_k8s_torch.autoscale.signals import percentile
from tpu_on_k8s_torch.obs.export import load_trace

#: the phase-span names that tile a request's life, in causal order
SEGMENTS = ("queue", "prefill", "handoff", "decode")

#: events that end the TTFT critical path, in anchor preference order
_ANCHOR_EVENTS = ("first_decode_token", "first_token")


def _event_time(spans: List[Dict[str, Any]], name: str) -> Optional[float]:
    """Earliest occurrence of event ``name`` across one trace's spans."""
    times = [ev["t"] for s in spans for ev in s.get("events", ())
             if ev["name"] == name]
    return min(times) if times else None


def decompose(spans: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """One trace (all spans sharing a trace id) → its critical-path
    record, or None when the trace has no ``request`` root or never
    produced a token (rejected / cancelled before decode — nothing to
    decompose). Replayed attempts are extra phase children on the same
    trace; their pre-anchor wall time lands in their segment, which is
    the point: a replay's cost is attributed, not hidden."""
    root = next((s for s in spans
                 if s["name"] == "request" and s.get("parent") is None),
                None)
    if root is None:
        return None
    anchor = None
    for ev in _ANCHOR_EVENTS:
        anchor = _event_time(spans, ev)
        if anchor is not None:
            break
    if anchor is None:
        return None
    t0 = root["start"]
    segments = {name: 0.0 for name in SEGMENTS}
    for s in spans:
        if s["name"] not in segments or s.get("parent") is None:
            continue
        end = s.get("end")
        hi = anchor if end is None else min(end, anchor)
        segments[s["name"]] += max(0.0, hi - s["start"])
    ttft = anchor - t0
    first_token = _event_time(spans, "first_token")
    # speculative-decoding attribution: each spec round marks every live
    # request's decode span with `spec.draft`/`spec.verify` events whose
    # `dt` attr is the round's device seconds on the engine's clock.
    # The per-request sums below are therefore SHARED batch time "this
    # request's decode overlapped" (concurrent requests each carry the
    # full round cost — correct per-request attribution, but summing
    # across requests would multiply device time by the live count;
    # build_report's aggregate sticks to per-request percentiles and
    # the draft/verify RATIO, where the sharing cancels)
    spec_draft = spec_verify = 0.0
    spec_rounds = 0
    for s in spans:
        for ev in s.get("events", ()):
            if ev["name"] == "spec.draft":
                spec_draft += (ev.get("attrs") or {}).get("dt", 0.0)
                spec_rounds += 1
            elif ev["name"] == "spec.verify":
                spec_verify += (ev.get("attrs") or {}).get("dt", 0.0)
    return {
        "trace": root["trace"],
        "rid": (root.get("attrs") or {}).get("rid"),
        "status": root.get("status"),
        "ttft": ttft,
        "first_token": (None if first_token is None else first_token - t0),
        "segments": segments,
        "residual": ttft - sum(segments.values()),
        "replays": sum(1 for s in spans if s["name"] == "queue") - 1,
        "spec_rounds": spec_rounds,
        "spec_draft_s": spec_draft,
        "spec_verify_s": spec_verify,
        "events": sorted({ev["name"] for s in spans
                          for ev in s.get("events", ())}),
    }


def build_report(spans: List[Dict[str, Any]], *, top: int = 3
                 ) -> Dict[str, Any]:
    """The whole dump → the report dict (what ``--json`` prints)."""
    by_trace: Dict[int, List[Dict[str, Any]]] = {}
    names: Dict[str, int] = {}
    for s in spans:
        by_trace.setdefault(s["trace"], []).append(s)
        names[s["name"]] = names.get(s["name"], 0) + 1
    requests = [r for r in (decompose(group)
                            for group in by_trace.values())
                if r is not None]
    requests.sort(key=lambda r: r["trace"])
    n_roots = sum(1 for group in by_trace.values()
                  if any(s["name"] == "request" for s in group))

    def _ms(v: Optional[float]) -> Optional[float]:
        return None if v is None else round(v * 1e3, 3)

    def pctls(values: List[float]) -> Dict[str, Optional[float]]:
        return {"p50_ms": _ms(percentile(values, 0.50)),
                "p95_ms": _ms(percentile(values, 0.95)),
                "max_ms": _ms(max(values) if values else None)}

    ttfts = [r["ttft"] for r in requests]
    # decomposed TTFT mass across all requests — each segment's share
    # denominator (hoisted: identical for every segment)
    total = sum(sum(r["segments"].values()) for r in requests)
    seg_stats: Dict[str, Any] = {}
    for name in SEGMENTS:
        vals = [r["segments"][name] for r in requests]
        stats = pctls(vals)
        # the exemplar: WHICH request was this segment's p95 — the trace
        # id an operator opens in Perfetto, not a number to guess from
        p95 = percentile(vals, 0.95)
        stats["p95_exemplar_trace"] = next(
            (r["trace"] for r in requests
             if p95 is not None and r["segments"][name] == p95), None)
        # share of the decomposed TTFT mass this segment owns — the
        # headline attribution ("the regression is queue-wait")
        stats["share"] = (round(sum(vals) / total, 4) if total > 0
                          else None)
        seg_stats[name] = stats

    ttft_p95 = percentile(ttfts, 0.95)
    slowest = sorted(requests, key=lambda r: -r["ttft"])[:max(top, 0)]
    # draft-overhead attribution across the dump: per-REQUEST stats
    # only, never cross-request sums — each round's device time lands on
    # every concurrently live request's span (shared batch time), so a
    # sum across requests would multiply it by the live count. The
    # draft/verify ratio is exact (the sharing cancels); None when the
    # trace carries no spec events — a plain-decode dump reports
    # nothing rather than a fake zero.
    spec_reqs = [r for r in requests if r["spec_rounds"] > 0]
    spec_total = (sum(r["spec_draft_s"] for r in spec_reqs)
                  + sum(r["spec_verify_s"] for r in spec_reqs))
    speculative = None
    if spec_reqs:
        speculative = {
            "requests": len(spec_reqs),
            "rounds_per_request_p50": percentile(
                [r["spec_rounds"] for r in spec_reqs], 0.50),
            "draft_ms_per_request_p50": _ms(percentile(
                [r["spec_draft_s"] for r in spec_reqs], 0.50)),
            "draft_ms_per_request_p95": _ms(percentile(
                [r["spec_draft_s"] for r in spec_reqs], 0.95)),
            "draft_overhead_share": (
                round(sum(r["spec_draft_s"] for r in spec_reqs)
                      / spec_total, 4) if spec_total > 0 else None),
        }
    return {
        "metric": "trace_report",
        "spans": len(spans),
        "span_names": dict(sorted(names.items())),
        "requests": n_roots,
        "decomposed": len(requests),
        "no_token": n_roots - len(requests),
        "ttft_ms_p50": _ms(percentile(ttfts, 0.50)),
        "ttft_ms_p95": _ms(ttft_p95),
        "ttft_p95_exemplar_trace": next(
            (r["trace"] for r in requests
             if ttft_p95 is not None and r["ttft"] == ttft_p95), None),
        "segments": seg_stats,
        # clock-tolerance self-check: under an injected virtual clock
        # phase boundaries share clock reads, so this is exactly 0.0;
        # wall clocks bound it by the inter-read jitter
        "residual_ms_max": _ms(max((abs(r["residual"]) for r in requests),
                                   default=None)),
        "replayed_requests": sum(1 for r in requests if r["replays"] > 0),
        "speculative": speculative,
        "slowest": [{
            "trace": r["trace"], "rid": r["rid"], "status": r["status"],
            "ttft_ms": _ms(r["ttft"]),
            **{f"{k}_ms": _ms(v) for k, v in r["segments"].items()},
            "replays": r["replays"],
        } for r in slowest],
    }


def render(report: Dict[str, Any]) -> str:
    """Human-readable summary (the default stdout)."""
    lines = [
        f"trace_report: {report['spans']} spans, "
        f"{report['requests']} requests "
        f"({report['decomposed']} decomposed, "
        f"{report['no_token']} without a token)",
        f"TTFT p50={report['ttft_ms_p50']}ms p95={report['ttft_ms_p95']}ms "
        f"(p95 exemplar: trace {report['ttft_p95_exemplar_trace']})",
        "critical-path segments (per-request p50/p95, share of TTFT mass):",
    ]
    for name in SEGMENTS:
        s = report["segments"][name]
        share = ("-" if s["share"] is None
                 else f"{100 * s['share']:.1f}%")
        lines.append(
            f"  {name:<8} p50={s['p50_ms']}ms p95={s['p95_ms']}ms "
            f"share={share} (p95 exemplar: trace "
            f"{s['p95_exemplar_trace']})")
    lines.append(f"residual |ttft - sum(segments)| max: "
                 f"{report['residual_ms_max']}ms")
    spec = report.get("speculative")
    if spec:
        share = ("-" if spec["draft_overhead_share"] is None
                 else f"{100 * spec['draft_overhead_share']:.1f}%")
        lines.append(
            f"speculative: {spec['requests']} requests, "
            f"{spec['rounds_per_request_p50']} rounds/request p50, "
            f"draft-wait p50={spec['draft_ms_per_request_p50']}ms "
            f"p95={spec['draft_ms_per_request_p95']}ms (draft overhead "
            f"{share} of spec device time)")
    if report["slowest"]:
        lines.append("slowest requests:")
        for r in report["slowest"]:
            segs = " ".join(f"{n}={r[f'{n}_ms']}ms" for n in SEGMENTS)
            lines.append(f"  trace {r['trace']} rid={r['rid']} "
                         f"ttft={r['ttft_ms']}ms [{segs}] "
                         f"replays={r['replays']} status={r['status']}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="per-request TTFT critical-path decomposition over a "
                    "span dump (serve_load --trace-out)")
    p.add_argument("trace", help="Tracer.dump file to analyze")
    p.add_argument("--json", action="store_true",
                   help="print the full report as one JSON line")
    p.add_argument("--top", type=int, default=3,
                   help="slowest-request rows to include")
    args = p.parse_args(argv)
    report = build_report(load_trace(args.trace), top=args.top)
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
