"""SLO budget-timeline report: join page events to their exemplar traces
(a copy of the reference's ``tools/slo_report.py`` on the port's
``obs/trace_report``, ``obs/dumpio`` and ``obs/export``).

A paged error-budget breach (``obs/slo.py`` — the burn-rate engine)
tells you *that* the budget is burning; the retained histogram exemplars
(``metrics.py`` ``(value, trace_id)`` deques) tell you *which requests*
were the breach. This report joins the two: for every
page in a budget dump (``serve_load --slo --slo-out``) it dereferences
the breaching exemplars into the span dump (``--trace-out``), so one
command goes from "TTFT budget paged at t=18.3" to the p95 exemplar
requests' full critical-path decomposition (queue/prefill/handoff/decode
segments via ``obs/trace_report.py``).

Usage:
    python -m tpu_on_k8s_torch.obs.slo_report SLO.json TRACE.json
    python -m tpu_on_k8s_torch.obs.slo_report SLO.json TRACE.json --json
    python -m tpu_on_k8s_torch.obs.slo_report SLO.json --check   # gate:
        every page must resolve >= 1 exemplar trace (exit 1 otherwise)

``SLO.json`` is what ``serve_load --slo --slo-out`` writes; the trace
path may also come from its ``trace_file`` field. Exit 0 on a well-formed
dump — ``--check`` adds the resolution gate the soaks run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional

from tpu_on_k8s_torch.obs.dumpio import open_dump
from tpu_on_k8s_torch.obs.export import load_trace
from tpu_on_k8s_torch.obs.trace_report import SEGMENTS, decompose

SLO_FORMAT = "tpu-on-k8s-slo/v1"


def load_slo(path: str) -> Dict[str, Any]:
    """Read an SLO budget dump, ``.json`` or ``.json.gz``."""
    with open_dump(path) as f:
        doc = json.load(f)
    if doc.get("format") != SLO_FORMAT:
        raise ValueError(f"{path}: not a {SLO_FORMAT} dump "
                         f"(format={doc.get('format')!r})")
    return doc


def build_join(slo: Dict[str, Any],
               spans: Optional[List[Dict[str, Any]]]) -> Dict[str, Any]:
    """The joined report: every page with its exemplars resolved against
    the span dump (when one is given) — resolved exemplars carry the
    request's TTFT critical-path segment decomposition."""
    by_trace: Dict[int, List[Dict[str, Any]]] = {}
    for s in spans or ():
        by_trace.setdefault(s["trace"], []).append(s)
    pages = []
    for page in slo.get("pages", ()):
        resolved = []
        unresolved = 0
        for value, trace_id in page.get("exemplars", ()):
            group = by_trace.get(trace_id)
            if group is None:
                unresolved += 1
                continue
            rec = decompose(group)
            entry: Dict[str, Any] = {"trace": trace_id,
                                     "observed_s": value}
            if rec is not None:
                entry["rid"] = rec["rid"]
                entry["status"] = rec["status"]
                entry["ttft_ms"] = round(rec["ttft"] * 1e3, 3)
                entry["segments_ms"] = {
                    n: round(rec["segments"][n] * 1e3, 3)
                    for n in SEGMENTS}
                entry["replays"] = rec["replays"]
            resolved.append(entry)
        pages.append({
            "t": page.get("t"),
            "slo": page.get("slo"),
            "step": page.get("step"),
            "exemplars": len(page.get("exemplars", ())),
            "resolved": resolved,
            "unresolved": unresolved,
        })
    return {
        "metric": "slo_report",
        "seed": slo.get("seed"),
        "event_log": list(slo.get("event_log", ())),
        "final_state": slo.get("final_state", {}),
        "budget_remaining": slo.get("budget_remaining", {}),
        "pages": pages,
        "have_trace": spans is not None,
    }


def render(report: Dict[str, Any]) -> str:
    lines = [f"slo_report: {len(report['pages'])} page(s), "
             f"{len(report['event_log'])} budget transition(s)"]
    for line in report["event_log"]:
        lines.append(f"  {line}")
    for name, state in sorted(report["final_state"].items()):
        remaining = report["budget_remaining"].get(name)
        lines.append(f"final: slo={name} state={state} "
                     f"budget_remaining={remaining}")
    for page in report["pages"]:
        lines.append(f"page t={page['t']} slo={page['slo']} "
                     f"step={page['step']}: {page['exemplars']} breaching "
                     f"exemplar(s), {len(page['resolved'])} resolved in "
                     f"trace")
        for ex in page["resolved"]:
            if "ttft_ms" in ex:
                segs = " ".join(f"{n}={ex['segments_ms'][n]}ms"
                                for n in SEGMENTS)
                lines.append(
                    f"  trace {ex['trace']} rid={ex.get('rid')} "
                    f"observed={ex['observed_s']}s "
                    f"ttft={ex['ttft_ms']}ms [{segs}] "
                    f"replays={ex.get('replays', 0)}")
            else:
                lines.append(f"  trace {ex['trace']} "
                             f"observed={ex['observed_s']}s "
                             f"(present, no token anchor)")
    if not report["have_trace"]:
        lines.append("(no trace file given — exemplars not dereferenced; "
                     "pass the serve_load --trace-out dump)")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="join an SLO budget timeline (serve_load --slo-out) "
                    "to its exemplar span traces (--trace-out)")
    p.add_argument("slo", help="serve_load --slo-out dump")
    p.add_argument("trace", nargs="?", default=None,
                   help="serve_load --trace-out span dump (defaults to "
                        "the slo dump's trace_file field)")
    p.add_argument("--json", action="store_true",
                   help="print the full join as one JSON line")
    p.add_argument("--check", action="store_true",
                   help="exit 1 unless every page resolves to at least "
                        "one exemplar trace present in the span dump")
    args = p.parse_args(argv)
    slo = load_slo(args.slo)
    trace_path = args.trace or slo.get("trace_file")
    if trace_path and not args.trace and not os.path.isabs(trace_path):
        # a relative trace_file names a sibling of the slo dump (what
        # the digital twin writes, so its artifact set relocates and
        # byte-compares); absolute paths pass through untouched
        trace_path = os.path.join(os.path.dirname(os.path.abspath(
            args.slo)), trace_path)
    spans = load_trace(trace_path) if trace_path else None
    report = build_join(slo, spans)
    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    if args.check:
        bad = [p_ for p_ in report["pages"] if not p_["resolved"]]
        if bad or not report["pages"]:
            print(f"SLO_REPORT_CHECK_FAILED: "
                  f"{len(bad)}/{len(report['pages'])} page(s) resolved "
                  f"no exemplar trace", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
