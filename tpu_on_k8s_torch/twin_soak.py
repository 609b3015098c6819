"""Twin soak driver: one scenario, twice, byte-compared, report-gated (a
copy of the reference's ``tools/twin_soak.py`` on the port's twin and its
``obs/*_report.py`` copies; like the reference's, it touches no device).

The digital twin's whole value rests on two properties this driver
enforces from OUTSIDE the deterministic core:

1. **Replayability** — the artifact set (span dump, decision ledger,
   SLO budget dump, summary) is a pure function of the `Scenario`. The
   soak runs the scenario twice into sibling directories and
   byte-compares all four files; any drift prints
   ``TWIN_SOAK_FAILED seed=N`` with the offending file, so a red run
   replays verbatim from the printed seed.
2. **Report compatibility** — ``--check`` feeds the twin's dumps to the
   UNMODIFIED production reports (`obs/trace_report.py`,
   `obs/why_report.py --check`, `obs/slo_report.py --check`) in-process
   and gates on their exit codes: none of them may be able to tell a
   rehearsal from a live run.

Wall-clock speedup is measured HERE, by injecting ``time.perf_counter``
as the twin's ``wall_clock`` — ``sim/`` itself never reads wall time
(the determinism gate of ``tests/test_torch_package.py``).
``--min-speedup`` turns the measurement into a gate, e.g. that the
24-virtual-hour million-request scenario beat 1000x real time.

Usage:
    python -m tpu_on_k8s_torch.twin_soak smoke --check
    python -m tpu_on_k8s_torch.twin_soak million_diurnal --check \\
        --min-speedup 1000
    python -m tpu_on_k8s_torch.twin_soak smoke --seed 7 --outdir OUT
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

from tpu_on_k8s_torch.sim.scenario import PRESETS, preset
from tpu_on_k8s_torch.sim.twin import (
    LEDGER_FILE,
    SLO_FILE,
    SUMMARY_FILE,
    TRACE_FILE,
    run_twin,
)

ARTIFACTS = (TRACE_FILE, LEDGER_FILE, SLO_FILE, SUMMARY_FILE)


def _identical(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _report_gates(outdir: str) -> int:
    """Run the three production reports on the twin's dumps, in-process,
    output swallowed — only the exit codes gate. Imported here (never
    from ``sim/``): the twin must not depend on the reports that audit
    it. The broker and multi-model soaks share this gate."""
    from tpu_on_k8s_torch.obs import slo_report, trace_report, why_report
    trace = os.path.join(outdir, TRACE_FILE)
    gates = (
        ("trace_report", trace_report.main, [trace, "--json"]),
        ("why_report", why_report.main,
         [os.path.join(outdir, LEDGER_FILE), "--trace", trace, "--check"]),
        ("slo_report", slo_report.main,
         [os.path.join(outdir, SLO_FILE), "--check"]),
    )
    failed = 0
    for name, fn, argv in gates:
        with contextlib.redirect_stdout(io.StringIO()):
            rc = fn(argv)
        print(f"  {name}: {'OK' if rc == 0 else f'FAILED rc={rc}'}")
        failed += rc != 0
    return failed


def _first_drift(dir_a: str, dir_b: str):
    """The first artifact that differs between the two runs, or None."""
    for f in ARTIFACTS:
        if not _identical(os.path.join(dir_a, f), os.path.join(dir_b, f)):
            return f
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="run a twin scenario twice, byte-compare the "
                    "artifact set, optionally gate the production "
                    "reports and the real-time speedup")
    p.add_argument("scenario", nargs="?", default=None,
                   choices=sorted(PRESETS),
                   help="scenario preset (default: smoke)")
    p.add_argument("--scenario", dest="scenario_opt", default=None,
                   choices=sorted(PRESETS), metavar="NAME",
                   help="scenario preset, as an option (overrides the "
                        "positional form)")
    p.add_argument("--seed", type=int, default=None,
                   help="override the preset's seed")
    p.add_argument("--outdir", default=None,
                   help="base directory for the two runs' artifacts "
                        "(default: a fresh temp dir)")
    p.add_argument("--check", action="store_true",
                   help="also gate trace_report / why_report --check / "
                        "slo_report --check on the run-A dumps")
    p.add_argument("--min-speedup", type=float, default=0.0,
                   help="fail unless virtual/wall speedup of run A "
                        "beats this (0 = report only)")
    p.add_argument("--json", action="store_true",
                   help="print the run-A summary as one JSON line")
    args = p.parse_args(argv)

    name = args.scenario_opt or args.scenario or "smoke"
    sc = preset(name, seed=args.seed)
    base = args.outdir or tempfile.mkdtemp(prefix=f"twin_{sc.name}_")
    dir_a = os.path.join(base, "a")
    dir_b = os.path.join(base, "b")

    summary = run_twin(sc, dir_a, wall_clock=time.perf_counter)
    run_twin(sc, dir_b)                      # replay: no wall clock at all

    f = _first_drift(dir_a, dir_b)
    if f is not None:
        print(f"TWIN_SOAK_FAILED seed={sc.seed}: {f} differs "
              f"between {dir_a} and {dir_b}", file=sys.stderr)
        return 1
    print(f"TWIN_SOAK_OK seed={sc.seed}: {len(ARTIFACTS)} artifact(s) "
          f"byte-identical across two runs ({base})")

    perf = summary.pop("perf", {})
    if args.json:
        print(json.dumps(dict(summary, perf=perf), sort_keys=True))
    else:
        print(f"  scenario={sc.name} requests={summary['requests']} "
              f"served={summary['served']} pages={summary['pages']} "
              f"scale_ups={summary['scale_ups']} "
              f"preemptions={summary['preemptions']} "
              f"spans={summary['spans']}")
        if perf:
            print(f"  virtual_s={summary['virtual_s']} "
                  f"wall_s={perf['wall_s']} speedup={perf['speedup']}x")

    if args.check and _report_gates(dir_a):
        print(f"TWIN_SOAK_FAILED seed={sc.seed}: report gate(s) failed",
              file=sys.stderr)
        return 1
    if args.min_speedup and perf.get("speedup", 0.0) < args.min_speedup:
        print(f"TWIN_SOAK_FAILED seed={sc.seed}: speedup "
              f"{perf.get('speedup')}x < required {args.min_speedup}x",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
