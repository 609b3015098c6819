"""The budgeted fuzz driver: enumerate bases, mutate, judge, shrink,
emit corpus entries.

The campaign is a pure function of ``(bases, seed, budget)``: every
random draw comes from one ``random.Random(seed)``, candidates are
generated *before* they are evaluated (so a parallel ``map_fn`` — the
``--workers`` path in ``fuzz_run`` — changes wall time, never
results), and results are processed in candidate order.

Budget accounting is total twin evaluations, shrink included: a
campaign with ``budget=24`` runs the twin at most 24 times, however
the work splits between exploration and minimization. Each confirmed
failure also spends one eval capturing the minimized entry's artifact
hashes (the corpus records what bytes a green replay should produce).

Failures de-duplicate by ``(base preset, failure-kind set)``: a
hundred mutants of the same base all tripping the same oracle are one
weakness, and the corpus stays reviewable.
"""
from __future__ import annotations

import dataclasses
import os
import random
import shutil
import tempfile
from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

from tpu_on_k8s_torch.sim.fuzz import corpus as corpus_mod
from tpu_on_k8s_torch.sim.fuzz.mutate import MutationConfig, mutate
from tpu_on_k8s_torch.sim.fuzz.oracle import (
    OracleConfig,
    Verdict,
    run_and_judge,
)
from tpu_on_k8s_torch.sim.fuzz.shrink import shrink
from tpu_on_k8s_torch.sim.scenario import Scenario

MapFn = Callable[[List[Scenario]], List[Verdict]]
LogFn = Callable[[str], None]


@dataclasses.dataclass(frozen=True)
class FuzzResult:
    """One campaign's outcome. ``entries`` are ready-to-write corpus
    docs (`corpus.write_entry`), in discovery order."""

    entries: Tuple[Dict[str, Any], ...]
    seed: int
    budget: int
    evals: int
    candidates: int
    failures_found: int
    dedup_skipped: int

    def to_doc(self) -> Dict[str, Any]:
        return {
            "seed": self.seed, "budget": self.budget,
            "evals": self.evals, "candidates": self.candidates,
            "failures_found": self.failures_found,
            "dedup_skipped": self.dedup_skipped,
            "entries": [e["name"] for e in self.entries],
        }


def _clamp_base(sc: Scenario, mcfg: MutationConfig) -> Scenario:
    if sc.duration_s > mcfg.max_virtual_s:
        return dataclasses.replace(sc, duration_s=mcfg.max_virtual_s)
    return sc


def fuzz(bases: Sequence[Scenario], *, seed: int, budget: int,
         cfg: Optional[OracleConfig] = None,
         mcfg: Optional[MutationConfig] = None,
         gen_size: int = 8, max_mutations: int = 3,
         shrink_budget: int = 32,
         status: str = corpus_mod.STATUS_WEAKNESS,
         map_fn: Optional[MapFn] = None,
         metrics: Optional[Any] = None,
         log: Optional[LogFn] = None) -> FuzzResult:
    """Run one campaign (see module doc). ``map_fn`` evaluates a
    generation of candidate scenarios and must return verdicts in the
    same order; the default is the in-process serial judge."""
    if not bases:
        raise ValueError("fuzz needs at least one base scenario")
    if budget < 1:
        raise ValueError("budget must be >= 1")
    cfg = cfg or OracleConfig()
    mcfg = mcfg or MutationConfig()
    rng = random.Random(seed)
    say: LogFn = log or (lambda _msg: None)

    def judge(sc: Scenario) -> Verdict:
        return run_and_judge(sc, cfg)[0]

    evaluate: MapFn = map_fn or (lambda scs: [judge(s) for s in scs])
    clamped = [_clamp_base(b, mcfg) for b in bases]
    # candidate stream: every base unmutated first (a planted
    # regression preset must be found on eval #1, not by luck), then
    # round-robin mutants
    pending: List[Tuple[Scenario, str, Tuple[str, ...]]] = [
        (b, b.name, ()) for b in clamped]
    entries: List[Dict[str, Any]] = []
    seen: set = set()
    evals = candidates = failures = deduped = 0
    round_i = 0
    while evals < budget:
        while len(pending) < min(gen_size, budget - evals):
            base = clamped[round_i % len(clamped)]
            round_i += 1
            n_mut = rng.randint(1, max_mutations)
            mutant, applied = mutate(rng, base, n_mut, mcfg)
            pending.append((mutant, base.name, applied))
        gen = pending[:max(1, min(gen_size, budget - evals))]
        pending = pending[len(gen):]
        verdicts = evaluate([sc for sc, _, _ in gen])
        evals += len(gen)
        candidates += len(gen)
        if metrics is not None:
            metrics.inc("evals", len(gen))
        for (sc, base_name, applied), verdict in zip(gen, verdicts):
            if not verdict.failing:
                continue
            failures += 1
            if metrics is not None:
                metrics.inc("failures_found")
            sig = (base_name, verdict.kinds)
            if sig in seen:
                deduped += 1
                if metrics is not None:
                    metrics.inc("dedup_skipped")
                continue
            seen.add(sig)
            say(f"fuzz: {base_name} fails "
                f"[{', '.join(verdict.kinds)}] after {evals} evals "
                f"(mutations: {', '.join(applied) or 'none'})")
            shrink_cap = min(shrink_budget, budget - evals)
            if shrink_cap > 0:
                res = shrink(sc, verdict, judge, budget=shrink_cap)
                evals += res.evals
                if metrics is not None and res.evals:
                    metrics.inc("shrink_evals", res.evals)
                min_sc, min_verdict = res.scenario, res.verdict
                steps = res.steps
            else:
                min_sc, min_verdict, steps = sc, verdict, ()
            sha = {}
            if evals < budget:
                tmp = tempfile.mkdtemp(prefix="tpu_on_k8s_fuzz_pin_")
                try:
                    run_and_judge(min_sc, cfg,
                                  outdir=os.path.join(tmp, "pin"))
                    sha = corpus_mod.artifact_hashes(
                        os.path.join(tmp, "pin"))
                finally:
                    shutil.rmtree(tmp, ignore_errors=True)
                evals += 1
                if metrics is not None:
                    metrics.inc("evals")
            entry = corpus_mod.make_entry(
                min_sc, min_verdict, base=base_name, fuzz_seed=seed,
                mutations=applied, shrink_steps=steps, evals=evals,
                status=status, artifacts_sha256=sha)
            entries.append(entry)
            if metrics is not None:
                metrics.inc("corpus_entries")
            say(f"fuzz: minimized to {entry['name']} "
                f"({len(steps)} shrink steps, {evals}/{budget} evals)")
    return FuzzResult(
        entries=tuple(entries), seed=seed, budget=budget, evals=evals,
        candidates=candidates, failures_found=failures,
        dedup_skipped=deduped)
