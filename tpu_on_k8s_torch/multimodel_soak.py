"""Multi-model density soak: the model-pool rehearsal, twice, gated (a
copy of the reference's ``tools/multimodel_soak.py`` on the port's twin;
it touches no device).

``broker_soak`` proves the capacity market arbitrates; this driver proves
MODEL DENSITY pays: 50 zipf-weighted models multiplexed onto one small
fleet, with real swap churn, must beat the one-replica-per-model control
arm on chips while every per-model SLO budget holds:

1. **Replayability** — `sim/scenario.multi_model_density` runs twice
   into sibling directories and all four artifacts (span dump, decision
   ledger, SLO budget dump, summary) must byte-compare. Any drift
   prints ``MULTIMODEL_SOAK_FAILED seed=N`` with the offending file, so
   a red run replays verbatim from the printed seed.
2. **Density gates** — from the run-A summary's ``models`` block: the
   whole catalog was served, swap churn actually happened (a run where
   no model ever swaps or gets evicted proves nothing about pooling),
   NO per-model budget finished exhausted, and the fleet's peak chip
   cost came in strictly under the control arm that parks one
   ``REPLICA_TOPOLOGY`` slice per catalog model. The autoscaler's
   swap-latency cold-start signal must have reached the decision
   ledger (``swap_p95`` in the signal snapshots) — measured swap-in
   latency is a first-class signal, not a private pool stat.
3. **Report gates** (``--check``) — the UNMODIFIED production reports
   (`obs/trace_report.py`, `obs/why_report.py --check`,
   `obs/slo_report.py --check`) accept the dumps, same as every other
   twin-backed soak.

Usage:
    python -m tpu_on_k8s_torch.multimodel_soak --check
    python -m tpu_on_k8s_torch.multimodel_soak --seed 7 --outdir OUT
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import tempfile
import time

from tpu_on_k8s_torch.sim.scenario import multi_model_density
from tpu_on_k8s_torch.sim.twin import LEDGER_FILE, run_twin
from tpu_on_k8s_torch.twin_soak import ARTIFACTS, _first_drift, _report_gates

PRESETS = {"multi_model_density": multi_model_density}


def _swap_signal_count(ledger_path: str) -> int:
    """How many ledger records carry a ``swap_p95`` signal snapshot —
    proof the swap-latency cold-start signal reached the decision
    plane, read from the same gzip dump `why_report` loads."""
    opener = gzip.open if ledger_path.endswith(".gz") else open
    with opener(ledger_path, "rt") as f:
        doc = json.load(f)
    records = doc["records"] if isinstance(doc, dict) else doc
    return sum(1 for r in records
               if "swap_p95" in (r.get("signals") or {}))


def _density_gates(summary, swap_signals: int) -> list:
    """The model-pool acceptance gates, from the deterministic summary
    alone. Returns the list of violated gate descriptions."""
    bad = []
    m = summary.get("models")
    if not m:
        return ["summary has no models block — the scenario did not "
                "run multi-model"]
    if summary.get("rejected", 0) != 0:
        bad.append(f"requests rejected: {summary['rejected']}")
    if m["served_models"] != m["catalog"]:
        bad.append(f"only {m['served_models']}/{m['catalog']} models "
                   f"ever served — the cold tail went dark")
    if m["swaps"] <= 0 or m["evictions"] <= 0:
        bad.append(f"no swap churn (swaps={m['swaps']} "
                   f"evictions={m['evictions']}) — nothing was pooled")
    if m["slo_engines"] != m["catalog"]:
        bad.append(f"{m['slo_engines']}/{m['catalog']} per-model SLO "
                   f"engines on the CRD plane")
    if m["slo_exhausted"]:
        bad.append(f"per-model budgets exhausted: {m['slo_exhausted']}")
    if m["chips"] >= m["control_arm_chips"]:
        bad.append(f"no density win: peak {m['chips']} chips vs "
                   f"control arm {m['control_arm_chips']}")
    if swap_signals <= 0:
        bad.append("no ledger record carries a swap_p95 signal — the "
                   "swap cold-start signal never reached the decision "
                   "plane")
    return bad


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="run the multi-model density scenario twice, "
                    "byte-compare the artifact set, and gate the "
                    "model pool's acceptance invariants")
    p.add_argument("scenario", nargs="?", default="multi_model_density",
                   choices=sorted(PRESETS),
                   help="scenario preset (default: multi_model_density)")
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
    base = args.outdir or tempfile.mkdtemp(prefix=f"mmd_{sc.name}_")
    dir_a = os.path.join(base, "a")
    dir_b = os.path.join(base, "b")

    summary = run_twin(sc, dir_a, wall_clock=time.perf_counter)
    run_twin(sc, dir_b)                      # replay: no wall clock at all

    f = _first_drift(dir_a, dir_b)
    if f is not None:
        print(f"MULTIMODEL_SOAK_FAILED seed={sc.seed}: {f} differs "
              f"between {dir_a} and {dir_b}", file=sys.stderr)
        return 1
    print(f"MULTIMODEL_SOAK_OK seed={sc.seed}: {len(ARTIFACTS)} "
          f"artifact(s) byte-identical across two runs ({base})")

    swap_signals = _swap_signal_count(os.path.join(dir_a, LEDGER_FILE))
    violations = _density_gates(summary, swap_signals)
    for v in violations:
        print(f"MULTIMODEL_SOAK_FAILED seed={sc.seed}: {v}",
              file=sys.stderr)
    if violations:
        return 1

    perf = summary.pop("perf", {})
    m = summary["models"]
    if args.json:
        print(json.dumps(dict(summary, perf=perf), sort_keys=True))
    else:
        print(f"  scenario={sc.name} requests={summary['requests']} "
              f"served={summary['served']} pages={summary['pages']} "
              f"models={m['catalog']} swaps={m['swaps']} "
              f"evictions={m['evictions']}")
        print(f"  density: peak_replicas={m['peak_replicas']} "
              f"chips={m['chips']} < control_arm={m['control_arm_chips']} "
              f"slo_exhausted={len(m['slo_exhausted'])} "
              f"swap_signals={swap_signals}")
        if perf:
            print(f"  virtual_s={summary['virtual_s']} "
                  f"wall_s={perf['wall_s']} speedup={perf['speedup']}x")

    if args.check and _report_gates(dir_a):
        print(f"MULTIMODEL_SOAK_FAILED seed={sc.seed}: report gate(s) "
              f"failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
