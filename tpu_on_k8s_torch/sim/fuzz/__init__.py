"""Scenario fuzzing: seeded adversarial search over the `Scenario`
DSL, run entirely against the digital twin.

The pipeline is four stages, one module each:

* `mutate`  — a seeded mutation engine that perturbs every knob the
  DSL exposes (traffic curve, bursts, tenant/model mixes, chaos
  windows, autoscale band, broker capacity, cost-model constants
  within calibrated bounds);
* `oracle`  — scores one twin run for *genuine* failures: SLO budget
  exhaustion, autoscaler thrash, interactive refusals, zero-silent-loss
  accounting breaks, open-horizon leaks on the decision ledger, and
  production report-gate failures;
* `shrink`  — a delta-debugging minimizer that simplifies a failing
  scenario (drop chaos, drop bursts, shorten, halve traffic) while the
  oracle still fires the same failure kinds;
* `corpus`  — serializes minimized failures into corpus-directory
  entries that replay byte-identically and pin the oracle verdict;
* `search`  — the budgeted driver tying them together.

Everything is deterministic given (bases, seed, budget): the package
lives under ``sim/`` on purpose, so the determinism gate of
``tests/test_torch_package.py`` holds it like the twin itself — no wall
clock, no ambient entropy. A copy of ``tpu_on_k8s/sim/fuzz/``.
"""
from tpu_on_k8s_torch.sim.fuzz.corpus import (
    ARTIFACTS,
    CORPUS_FORMAT,
    STATUS_GUARD,
    STATUS_WEAKNESS,
    entry_name,
    load_entries,
    make_entry,
    replay,
    write_entry,
)
from tpu_on_k8s_torch.sim.fuzz.mutate import (
    MUTATORS,
    MutationConfig,
    mutate,
    mutator_names,
)
from tpu_on_k8s_torch.sim.fuzz.oracle import (
    FAIL_ACCOUNTING,
    FAIL_HORIZON,
    FAIL_REFUSALS,
    FAIL_REPORT_PREFIX,
    FAIL_SLO_EXHAUSTED,
    FAIL_THRASH,
    Failure,
    OracleConfig,
    Verdict,
    judge_run,
    run_and_judge,
)
from tpu_on_k8s_torch.sim.fuzz.search import FuzzResult, fuzz
from tpu_on_k8s_torch.sim.fuzz.shrink import complexity, shrink

__all__ = [
    "ARTIFACTS", "CORPUS_FORMAT", "STATUS_GUARD", "STATUS_WEAKNESS",
    "entry_name",
    "load_entries", "make_entry", "replay", "write_entry",
    "MUTATORS", "MutationConfig", "mutate", "mutator_names",
    "FAIL_ACCOUNTING", "FAIL_HORIZON", "FAIL_REFUSALS",
    "FAIL_REPORT_PREFIX", "FAIL_SLO_EXHAUSTED", "FAIL_THRASH",
    "Failure", "OracleConfig", "Verdict", "judge_run", "run_and_judge",
    "FuzzResult", "fuzz", "complexity", "shrink",
]
