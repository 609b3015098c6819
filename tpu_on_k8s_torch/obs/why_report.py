"""why_report: causality queries over the decision ledger (a copy of the
reference's ``tools/why_report.py`` on the port's ``obs/ledger``,
``obs/export`` and ``obs/slo.page_onsets``).

The decision ledger (``obs/ledger.py``) records what every control loop
decided and why; the span dump (``obs/trace.py``) records what every
request experienced; the SLO engine's budget event log (``obs/slo.py``)
records when the error budget burned. This report JOINS them:

* **"why did replicas change at t?"** — walk back from the last
  committed decision at/before ``t``: its observed signals (with the
  trace-id exemplars dereferenced into real request spans), its trigger
  (the SLO page episode resolved to the actual ``...->page`` transition
  line, or the chaos injection resolved to the injector's
  sequence-stamped event), its parent decisions, and its effect horizon
  (replicas ready / rollout complete / burn recovered).
* **"why did this SLO page?"** (``--page``) — every page episode, the
  urgent decisions it triggered, their commits, and the recovery.
* **one merged Perfetto timeline** (``--perfetto out.json``) — the
  request spans with control-plane decisions as named tracks beside
  them, on one clock.

``--check`` is the acceptance gate: the ledger must contain at least one
COMPLETE page chain — page episode resolved to a real transition line →
urgent scale decision → landed patch → replicas ready → burn recovered —
with every exemplar resolving to a real span in the trace dump. Exit 1
otherwise.

Usage:
    python -m tpu_on_k8s_torch.obs.why_report LEDGER.json
    python -m tpu_on_k8s_torch.obs.why_report LEDGER.json --trace t.json \
        --check
    python -m tpu_on_k8s_torch.obs.why_report LEDGER.json --at 12.5
    python -m tpu_on_k8s_torch.obs.why_report LEDGER.json --page --json
    python -m tpu_on_k8s_torch.obs.why_report LEDGER.json --trace t.json \
        --perfetto out.json
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from tpu_on_k8s_torch.obs.export import load_trace, to_chrome_trace
from tpu_on_k8s_torch.obs.ledger import committed, load_ledger
# the ONE page-onset definition, shared with the fleet autoscaler's
# episode-ordinal assignment — two copies would let the writer and the
# resolver disagree about what an episode is
from tpu_on_k8s_torch.obs.slo import page_onsets


def resolve_trigger(trigger: str, doc: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve a ledger trigger ref against the embedded sibling logs:
    ``slo_page:<svc>#N`` → the N-th page-onset line of that service's
    budget event log; ``chaos#N`` → the injector's seq=N event line.
    ``resolved`` is None when the referenced record does not exist —
    `--check` treats that as a broken chain."""
    if trigger.startswith("slo_page:"):
        ref, _, episode_s = trigger[len("slo_page:"):].rpartition("#")
        lines = (doc.get("slo_event_log") or {}).get(ref, [])
        onsets = page_onsets(lines)
        try:
            idx = int(episode_s) - 1
        except ValueError:
            idx = -1
        return {"kind": "slo_page", "ref": trigger,
                "resolved": onsets[idx] if 0 <= idx < len(onsets) else None}
    if trigger.startswith("chaos#"):
        try:
            n = int(trigger[len("chaos#"):])
        except ValueError:
            n = 0
        events = doc.get("chaos_events") or []
        line = None
        if 1 <= n <= len(events):
            cand = events[n - 1]
            line = cand if cand.startswith(f"seq={n} ") else None
        return {"kind": "chaos", "ref": trigger, "resolved": line}
    return {"kind": "signal", "ref": trigger, "resolved": ""}


def build_chains(doc: Dict[str, Any],
                 trace_ids: Optional[set] = None) -> List[Dict[str, Any]]:
    """One chain per COMMITTED decision: trigger (resolved), parent
    decisions (walked to the root), the decision itself, and its
    horizon events. ``trace_ids`` (span-dump trace ids) marks which
    exemplars dereference into real spans."""
    records = doc.get("records", [])
    by_seq = {r["seq"]: r for r in records if r.get("kind") == "decision"}
    horizons: Dict[int, List[Dict[str, Any]]] = {}
    for r in records:
        if r.get("kind") == "horizon":
            horizons.setdefault(r["decision"], []).append(r)
    chains = []
    for r in records:
        if r.get("kind") != "decision" or not committed(r.get("commit", "")):
            continue
        parents = []
        seen = set()
        p = r.get("parent")
        while p is not None and p in by_seq and p not in seen:
            seen.add(p)
            parents.append(by_seq[p])
            p = by_seq[p].get("parent")
        exemplars = r.get("exemplars", [])
        chains.append({
            "decision": r,
            "trigger": resolve_trigger(r.get("trigger", ""), doc),
            "parents": parents,
            "horizon": horizons.get(r["seq"], []),
            "exemplars": exemplars,
            "exemplars_resolved": (
                [tid for tid in exemplars if tid in trace_ids]
                if trace_ids is not None else None),
        })
    return chains


def why_replicas(chains: List[Dict[str, Any]],
                 at: Optional[float] = None) -> Optional[Dict[str, Any]]:
    """The chain answering "why did replicas change at ``t``" — the
    newest committed decision at/before ``at`` (or overall)."""
    cand = [c for c in chains
            if at is None or c["decision"]["t"] <= at]
    return cand[-1] if cand else None


def why_pages(chains: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The chains answering "why did this SLO page" — every committed
    decision an SLO page episode triggered."""
    return [c for c in chains
            if c["trigger"]["kind"] == "slo_page"]


def chain_complete(chain: Dict[str, Any]) -> bool:
    """The full page→decision→patch→recovery chain: trigger resolved to
    a real transition line, the patch landed, the new capacity went
    ready, and the burn recovered."""
    events = {h["event"] for h in chain["horizon"]}
    return (chain["trigger"]["kind"] == "slo_page"
            and chain["trigger"]["resolved"] is not None
            and committed(chain["decision"].get("commit", ""))
            and "replicas_ready" in events
            and "burn_recovered" in events)


# ------------------------------------------------------------------ rendering
def _fmt_chain(chain: Dict[str, Any]) -> List[str]:
    d = chain["decision"]
    out = [f"decision seq={d['seq']} t={d['t']:.6f} loop={d['loop']}: "
           f"{d['action']} {d['current']}->{d['target']} "
           f"[commit={d['commit']}] reason={d['reason']}"]
    trig = chain["trigger"]
    if trig["kind"] != "signal":
        mark = "resolved" if trig["resolved"] is not None else "UNRESOLVED"
        out.append(f"  trigger [{trig['kind']}] {trig['ref']} ({mark})")
        if trig["resolved"]:
            out.append(f"    -> {trig['resolved']}")
    sig = d.get("signals")
    if sig:
        out.append("  observed " + " ".join(f"{k}={v}"
                                            for k, v in sig.items()))
    if chain["exemplars"]:
        res = chain["exemplars_resolved"]
        suffix = ("" if res is None
                  else f" ({len(res)}/{len(chain['exemplars'])} in trace)")
        out.append("  exemplar traces "
                   + ",".join(map(str, chain["exemplars"])) + suffix)
    for p in chain["parents"]:
        out.append(f"  parent seq={p['seq']} t={p['t']:.6f}: {p['action']} "
                   f"{p['current']}->{p['target']} reason={p['reason']}")
    for h in chain["horizon"]:
        closing = " (closes horizon)" if h["closing"] else ""
        out.append(f"  effect t={h['t']:.6f}: {h['event']}{closing}")
    return out


# ------------------------------------------------------- merged Perfetto view
#: pid lanes of the merged timeline: requests on 1 (the span exporter's
#: convention), control-plane loops on 2
_CONTROL_PID = 2


def merged_timeline(spans: List[Dict[str, Any]],
                    doc: Dict[str, Any]) -> Dict[str, Any]:
    """One Chrome trace-event document: the request spans (via
    `obs/export.to_chrome_trace`) plus one named track per control loop
    — committed decisions render as duration slices from commit to
    horizon close (so "the fleet was converging" is visible width, not
    a dot), holds/skips as instants, horizon events as instants."""
    base = to_chrome_trace(spans)
    events = list(base["traceEvents"])
    records = doc.get("records", [])
    loops = sorted({r["loop"] for r in records})
    tids = {loop: i + 1 for i, loop in enumerate(loops)}
    for loop, tid in tids.items():
        events.append({"ph": "M", "name": "thread_name",
                       "pid": _CONTROL_PID, "tid": tid,
                       "args": {"name": loop}})
    close_t: Dict[int, float] = {}
    last_t = max((r["t"] for r in records), default=0.0)
    for r in records:
        if r.get("kind") == "horizon" and r["closing"]:
            close_t[r["decision"]] = r["t"]
    for r in records:
        tid = tids[r["loop"]]
        if r.get("kind") == "horizon":
            events.append({
                "ph": "i", "name": f"horizon:{r['event']}",
                "cat": "ledger", "pid": _CONTROL_PID, "tid": tid,
                "s": "t", "ts": round(r["t"] * 1e6, 3),
                "args": {"decision": r["decision"],
                         "closing": r["closing"]}})
            continue
        args = {k: r[k] for k in ("seq", "action", "current", "target",
                                  "reason", "commit") if k in r}
        if r.get("trigger"):
            args["trigger"] = r["trigger"]
        if committed(r.get("commit", "")):
            end = close_t.get(r["seq"], last_t)
            events.append({
                "ph": "X", "name": f"{r['action']} "
                                   f"{r['current']}->{r['target']}",
                "cat": "ledger", "pid": _CONTROL_PID, "tid": tid,
                "ts": round(r["t"] * 1e6, 3),
                "dur": round(max(end - r["t"], 0.0) * 1e6, 3),
                "args": args})
        else:
            events.append({
                "ph": "i", "name": f"{r['action']}", "cat": "ledger",
                "pid": _CONTROL_PID, "tid": tid, "s": "t",
                "ts": round(r["t"] * 1e6, 3), "args": args})
    events.sort(key=lambda e: (e.get("ts", -1),
                               e.get("pid", 0), e.get("tid", 0)))
    base["traceEvents"] = events
    return base


# ------------------------------------------------------------------- the CLI
def build_report(doc: Dict[str, Any],
                 spans: Optional[List[Dict[str, Any]]] = None,
                 at: Optional[float] = None) -> Dict[str, Any]:
    trace_ids = ({s["trace"] for s in spans}
                 if spans is not None else None)
    chains = build_chains(doc, trace_ids)
    pages = why_pages(chains)
    return {
        "records": len(doc.get("records", [])),
        "committed": len(chains),
        "chains": chains,
        "pages": pages,
        "complete_page_chains": [c for c in pages if chain_complete(c)],
        "latest": why_replicas(chains, at=at),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="causal chains over the decision ledger")
    ap.add_argument("ledger", help="DecisionLedger.dump file "
                                   "(serve_load --ledger-out)")
    ap.add_argument("--trace", default="",
                    help="span dump (serve_load --trace-out): exemplar "
                         "trace ids are resolved against it")
    ap.add_argument("--at", type=float, default=None,
                    help="answer 'why did replicas change at t' for "
                         "this ledger-clock time (default: latest)")
    ap.add_argument("--page", action="store_true",
                    help="report every SLO page episode's chain")
    ap.add_argument("--perfetto", default="",
                    help="write the merged request+control-plane "
                         "Chrome/Perfetto timeline here (needs --trace)")
    ap.add_argument("--json", action="store_true",
                    help="print the report as JSON instead of text")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless >=1 COMPLETE page chain exists "
                         "(page->decision->patch->ready->recovery, every "
                         "link + exemplar resolving)")
    args = ap.parse_args(argv)

    doc = load_ledger(args.ledger)
    spans = load_trace(args.trace) if args.trace else None
    report = build_report(doc, spans, at=args.at)

    if args.perfetto:
        timeline = merged_timeline(spans or [], doc)
        with open(args.perfetto, "w") as f:
            json.dump(timeline, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        print(f"merged timeline -> {args.perfetto} "
              f"({len(timeline['traceEvents'])} events)", file=sys.stderr)

    if args.json:
        print(json.dumps(report, indent=2))
    else:
        chains = report["pages"] if args.page else (
            [report["latest"]] if report["latest"] is not None else [])
        if not chains:
            print("no committed decisions"
                  + (" with SLO page triggers" if args.page else "")
                  + " in the ledger")
        for chain in chains:
            for line in _fmt_chain(chain):
                print(line)
        print(f"ledger: {report['records']} records, "
              f"{report['committed']} committed, "
              f"{len(report['pages'])} page-triggered, "
              f"{len(report['complete_page_chains'])} complete page "
              f"chain(s)")

    if args.check:
        complete = report["complete_page_chains"]
        ok = bool(complete)
        if ok and spans is not None:
            # every complete chain's exemplars must dereference into the
            # span dump — a ledger citing evidence the trace doesn't
            # hold is a broken join, not a passing check
            for c in complete:
                if c["exemplars"] and not c["exemplars_resolved"]:
                    ok = False
        if not ok:
            print("WHY_CHECK_FAILED: no complete page->decision->patch->"
                  "ready->recovery chain with resolving links",
                  file=sys.stderr)
            return 1
        print(f"WHY_CHECK_OK: {len(complete)} complete chain(s)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
