"""Broker soak driver: the contention rehearsal, twice, gate-checked (a
copy of the reference's ``tools/broker_soak.py`` on the port's twin; it
touches no device).

``twin_soak`` proves the twin replays; this driver proves the CAPACITY
MARKET holds its contract while a traffic burst, an elastic training
job, and a batch backlog all want the same 12 hosts:

1. **Replayability** — `sim/scenario.broker_contention` runs twice into
   sibling directories and all four artifacts (span dump, decision
   ledger — broker lane records included — SLO budget dump, summary)
   must byte-compare. Any drift prints ``BROKER_SOAK_FAILED seed=N``
   with the offending file, so a red run replays verbatim from the
   printed seed.
2. **Market gates** — from the run-A summary: the serving SLO paged at
   most briefly (zero rejected interactive requests), the batch lane's
   goodput is NONZERO (the market filled idle hosts into it), the
   zero-silent-loss invariant ``submitted == completed + backlog +
   in_flight`` held through every harvest, and the escalation ladder
   actually fired (at least one harvest — a run where nothing contends
   proves nothing).
3. **Report gates** (``--check``) — the UNMODIFIED production reports
   (`obs/trace_report.py`, `obs/why_report.py --check`,
   `obs/slo_report.py --check`) accept the dumps; `why_report --check`
   resolves every broker preemption to its triggering cause through the
   ``slo_page:`` / ``chaos#`` refs the lanes carry.

Usage:
    python -m tpu_on_k8s_torch.broker_soak --check
    python -m tpu_on_k8s_torch.broker_soak --seed 7 --outdir OUT
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from tpu_on_k8s_torch.sim.scenario import broker_contention
from tpu_on_k8s_torch.sim.twin import run_twin
from tpu_on_k8s_torch.twin_soak import ARTIFACTS, _first_drift, _report_gates

PRESETS = {"broker_contention": broker_contention}


def _market_gates(summary) -> list:
    """The broker-specific acceptance gates, from the deterministic
    summary alone. Returns the list of violated gate descriptions."""
    bad = []
    batch = summary.get("batch", {})
    if summary.get("rejected", 0) != 0:
        bad.append(f"interactive requests rejected: {summary['rejected']}")
    if batch.get("completed", 0) <= 0:
        bad.append("batch goodput is zero — the fill phase never ran")
    if not summary.get("batch_intact", False):
        bad.append("batch lane lost work: submitted != "
                   "completed + backlog + in_flight")
    if summary.get("broker_ticks", 0) <= 0:
        bad.append("broker never ticked")
    if batch.get("yields", 0) <= 0:
        bad.append("no harvest ever fired — the scenario did not contend")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="run the capacity-market contention scenario twice, "
                    "byte-compare the artifact set, and gate the "
                    "market's acceptance invariants")
    p.add_argument("scenario", nargs="?", default="broker_contention",
                   choices=sorted(PRESETS),
                   help="scenario preset (default: broker_contention)")
    p.add_argument("--seed", type=int, default=None,
                   help="override the preset's seed")
    p.add_argument("--outdir", default=None,
                   help="base directory for the two runs' artifacts "
                        "(default: a fresh temp dir)")
    p.add_argument("--check", action="store_true",
                   help="also gate trace_report / why_report --check / "
                        "slo_report --check on the run-A dumps")
    p.add_argument("--json", action="store_true",
                   help="print the run-A summary as one JSON line")
    args = p.parse_args(argv)

    sc = (PRESETS[args.scenario](args.seed) if args.seed is not None
          else PRESETS[args.scenario]())
    base = args.outdir or tempfile.mkdtemp(prefix=f"broker_{sc.name}_")
    dir_a = os.path.join(base, "a")
    dir_b = os.path.join(base, "b")

    summary = run_twin(sc, dir_a, wall_clock=time.perf_counter)
    run_twin(sc, dir_b)                      # replay: no wall clock at all

    f = _first_drift(dir_a, dir_b)
    if f is not None:
        print(f"BROKER_SOAK_FAILED seed={sc.seed}: {f} differs "
              f"between {dir_a} and {dir_b}", file=sys.stderr)
        return 1
    print(f"BROKER_SOAK_OK seed={sc.seed}: {len(ARTIFACTS)} artifact(s) "
          f"byte-identical across two runs ({base})")

    violations = _market_gates(summary)
    for v in violations:
        print(f"BROKER_SOAK_FAILED seed={sc.seed}: {v}", file=sys.stderr)
    if violations:
        return 1

    perf = summary.pop("perf", {})
    batch = summary.get("batch", {})
    if args.json:
        print(json.dumps(dict(summary, perf=perf), sort_keys=True))
    else:
        print(f"  scenario={sc.name} requests={summary['requests']} "
              f"served={summary['served']} pages={summary['pages']} "
              f"broker_ticks={summary['broker_ticks']} "
              f"broker_decisions={summary['broker_decisions']}")
        print(f"  batch: completed={batch.get('completed')} "
              f"backlog={batch.get('backlog')} "
              f"yields={batch.get('yields')} "
              f"intact={summary.get('batch_intact')}")
        if perf:
            print(f"  virtual_s={summary['virtual_s']} "
                  f"wall_s={perf['wall_s']} speedup={perf['speedup']}x")

    if args.check and _report_gates(dir_a):
        print(f"BROKER_SOAK_FAILED seed={sc.seed}: report gate(s) failed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
