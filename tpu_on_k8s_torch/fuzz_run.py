"""Scenario-fuzz driver: budgeted adversarial search over the digital
twin, from the command line (a copy of the reference's
``tools/fuzz_run.py`` on the port's twin, fuzzer and ``obs/*_report.py``
copies; it touches no device).

This is the orchestration shell around `sim/fuzz`: it picks the
mutation bases from the `sim/scenario` preset registry, arms the oracle
with the PRODUCTION report gates (the sim package never imports the
reports that audit it — the gate is injected from here), optionally
fans twin evaluations out over worker processes, and writes confirmed
minimized failures as corpus entries (only where ``--corpus-dir`` says:
by default it writes none).

Determinism contract: ``--seed`` + ``--budget`` + ``--bases`` fully
determine the campaign. ``--workers`` parallelizes one *generation* of
candidate evaluations and changes wall time only — candidates are
drawn before evaluation and results are consumed in candidate order.
A red run always prints ``seed=N`` so it replays verbatim.

Modes:

* ``--smoke`` — the acceptance loop: fixed small
  budget over (`slo_regression`, `smoke`); asserts the campaign finds
  at least one genuine failure (the deliberately planted
  ``slo_regression`` preset guarantees one exists), minimizes it, and
  that the minimized entry replays byte-identically twice. Prints
  ``FUZZ_SMOKE_OK seed=N`` / ``FUZZ_SMOKE_FAILED seed=N``.
* ``--soak`` — the nightly-style budgeted run over every registered
  preset (long bases clamped to the mutation config's virtual-time
  ceiling).
* default — explicit ``--bases``/``--budget``.

Usage:
    python -m tpu_on_k8s_torch.fuzz_run --smoke --seed 1122
    python -m tpu_on_k8s_torch.fuzz_run --soak --budget 64 --workers 4
    python -m tpu_on_k8s_torch.fuzz_run --bases smoke --budget 8 \
        --corpus-dir OUT
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
from typing import List, Optional, Sequence, Tuple

from tpu_on_k8s_torch.metrics import FuzzMetrics
from tpu_on_k8s_torch.sim import fuzz as fz
from tpu_on_k8s_torch.sim.scenario import (
    PRESETS,
    Scenario,
    preset,
    preset_names,
    scenario_from_doc,
    scenario_to_doc,
)
from tpu_on_k8s_torch.sim.twin import LEDGER_FILE, SLO_FILE, TRACE_FILE

SMOKE_BASES = ("slo_regression", "smoke")
SMOKE_BUDGET = 12


def report_gate(outdir: str, pages: int) -> List[Tuple[str, int]]:
    """The oracle's production report gate (`sim/fuzz/oracle` docs):
    run the unmodified reports on a twin artifact set, output
    swallowed, exit codes returned. ``why_report --check`` and
    ``slo_report --check`` demand a resolved page chain, so on a run
    that never paged they would fail vacuously — skipped."""
    from tpu_on_k8s_torch.obs import slo_report, trace_report, why_report
    trace = os.path.join(outdir, TRACE_FILE)
    gates = [("trace_report", trace_report.main, [trace, "--json"])]
    if pages > 0:
        gates += [
            ("why_report", why_report.main,
             [os.path.join(outdir, LEDGER_FILE), "--trace", trace,
              "--check"]),
            ("slo_report", slo_report.main,
             [os.path.join(outdir, SLO_FILE), "--check"]),
        ]
    out = []
    for name, fn, argv in gates:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(buf):
            try:
                rc = fn(argv)
            except SystemExit as e:      # argparse failures etc.
                rc = int(e.code or 0)
        out.append((name, rc))
    return out


def oracle_config() -> fz.OracleConfig:
    return fz.OracleConfig(report_gate=report_gate)


# ------------------------------------------------------------- workers
# Worker processes rebuild the oracle config locally (callables don't
# cross the process boundary); scenarios travel as their JSON docs.
def _worker_judge(doc) -> fz.Verdict:
    sc = scenario_from_doc(doc)
    verdict, _ = fz.run_and_judge(sc, oracle_config())
    return verdict


def _pool_map(pool):
    def run(scenarios: Sequence[Scenario]) -> List[fz.Verdict]:
        docs = [scenario_to_doc(sc) for sc in scenarios]
        return list(pool.map(_worker_judge, docs))
    return run


def _campaign(bases: Sequence[Scenario], *, seed: int, budget: int,
              workers: int, mcfg: fz.MutationConfig,
              metrics: FuzzMetrics) -> fz.FuzzResult:
    kwargs = dict(seed=seed, budget=budget, cfg=oracle_config(),
                  mcfg=mcfg, metrics=metrics, log=print)
    if workers > 1:
        import concurrent.futures as cf
        import multiprocessing

        # spawn, not fork: the parent holds torch's threads
        with cf.ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            return fz.fuzz(bases, map_fn=_pool_map(pool), **kwargs)
    return fz.fuzz(bases, **kwargs)


def _write_entries(result: fz.FuzzResult, corpus_dir: Optional[str]
                   ) -> List[str]:
    if not corpus_dir:
        return []
    return [fz.write_entry(corpus_dir, e) for e in result.entries]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="budgeted adversarial scenario search over the "
                    "digital twin")
    p.add_argument("--bases", default=None,
                   help="comma-separated preset names to mutate "
                        f"(known: {', '.join(sorted(PRESETS))})")
    p.add_argument("--budget", type=int, default=None,
                   help="total twin evaluations (shrink included)")
    p.add_argument("--seed", type=int, default=1122)
    p.add_argument("--workers", type=int, default=0,
                   help="worker processes for candidate evaluation "
                        "(0/1 = in-process)")
    p.add_argument("--corpus-dir", default=None,
                   help="write confirmed minimized entries here")
    p.add_argument("--max-virtual", type=float, default=3600.0,
                   help="virtual-seconds ceiling per evaluation")
    p.add_argument("--smoke", action="store_true",
                   help="the fuzz-smoke acceptance loop")
    p.add_argument("--soak", action="store_true",
                   help="budgeted run over every registered preset")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the campaign result doc as JSON")
    args = p.parse_args(argv)

    if args.smoke and args.soak:
        p.error("--smoke and --soak are mutually exclusive")
    if args.bases:
        base_names = [b.strip() for b in args.bases.split(",") if b.strip()]
    elif args.smoke:
        base_names = list(SMOKE_BASES)
    elif args.soak:
        base_names = preset_names()
    else:
        base_names = list(SMOKE_BASES)
    unknown = [b for b in base_names if b not in PRESETS]
    if unknown:
        p.error(f"unknown preset(s): {', '.join(unknown)}")
    budget = args.budget or (SMOKE_BUDGET if args.smoke else 48)

    bases = [preset(n) for n in base_names]
    # smoke is a tier-1 CI gate: cap mutant virtual time at the bases'
    # own scale so one unlucky duration draw can't eat the budget
    max_virtual = 600.0 if args.smoke else args.max_virtual
    mcfg = fz.MutationConfig(max_virtual_s=max_virtual)
    metrics = FuzzMetrics()
    result = _campaign(bases, seed=args.seed, budget=budget,
                       workers=args.workers, mcfg=mcfg, metrics=metrics)
    paths = _write_entries(result, args.corpus_dir)
    doc = result.to_doc()
    doc["written"] = paths
    if args.as_json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        print(f"fuzz: {result.evals}/{result.budget} evals, "
              f"{result.failures_found} failing candidates, "
              f"{len(result.entries)} corpus entries "
              f"({result.dedup_skipped} deduped)")

    if not args.smoke:
        return 0

    # ------------------------- the fuzz-smoke acceptance assertions
    if not result.entries:
        print(f"FUZZ_SMOKE_FAILED seed={args.seed}: no failure found "
              f"in {result.evals} evals (the planted slo_regression "
              f"preset should fail on evaluation #1)", file=sys.stderr)
        return 1
    entry = result.entries[0]
    rep = fz.replay(entry, oracle_config())
    if not rep.byte_identical:
        print(f"FUZZ_SMOKE_FAILED seed={args.seed}: minimized entry "
              f"{entry['name']} did not replay byte-identically: "
              f"{'; '.join(rep.details)}", file=sys.stderr)
        return 1
    if not rep.kinds_match:
        print(f"FUZZ_SMOKE_FAILED seed={args.seed}: replay verdict "
              f"{list(rep.observed_kinds)} != pinned "
              f"{list(rep.pinned_kinds)} for {entry['name']}",
              file=sys.stderr)
        return 1
    print(f"FUZZ_SMOKE_OK seed={args.seed} entries={len(result.entries)} "
          f"evals={result.evals} first={entry['name']} "
          f"kinds={','.join(entry['oracle']['kinds'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
