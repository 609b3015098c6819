"""Delta-debugging shrinker: minimize a failing scenario while the
oracle still fires the same failure kinds.

Classic ddmin splits a flat input list; a `Scenario` is structured, so
the shrinker instead runs an ordered catalog of *simplification
passes* — drop all chaos, drop one chaos window, disable the training
job, disable the broker, disable the model catalog, collapse to one
tenant, drop a burst, halve a burst, halve the duration, halve the
traffic, flatten the diurnal curve. Greedy first-improvement to a
fixed point: take the first candidate that (a) strictly decreases the
`complexity` tuple and (b) still makes the oracle report every kind
the original failure had (a superset is fine — simplification may
surface a second symptom of the same bug, but it must never *lose*
the one being pinned), then restart from the top of the catalog.

The scenario ``seed`` is never touched here: the minimized scenario
must replay the same bytes the shrink run judged.

Termination: every acceptance strictly decreases a tuple whose
components are bounded below, and the eval ``budget`` caps oracle
calls regardless; determinism: the catalog order is fixed, candidates
are generated in deterministic order, and the judge is the
deterministic twin — same failing scenario, same minimum, every time
(tier-1 pins this).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Tuple

from tpu_on_k8s_torch.sim.fuzz.oracle import Verdict
from tpu_on_k8s_torch.sim.scenario import Scenario
from tpu_on_k8s_torch.sim.traffic import TenantMix

#: minimum duration a shrink step may leave (one autoscale reconcile
#: plus slack — shorter runs cannot express most failures anyway)
MIN_DURATION_S = 30.0

Judge = Callable[[Scenario], Verdict]


def complexity(sc: Scenario) -> Tuple:
    """The strictly-decreasing acceptance metric. Leading component
    counts the moving parts (chaos windows, bursts, subsystems armed,
    tenants); later components order same-part-count scenarios by how
    much virtual work they schedule."""
    parts = (len(sc.chaos) + len(sc.profile.bursts)
             + (1 if sc.n_models > 0 else 0)
             + (1 if sc.broker_capacity_chips > 0 else 0)
             + (1 if sc.train_workers > 0 else 0)
             + len(sc.tenants.names))
    burst_load = round(sum(m * ln for _, ln, m in sc.profile.bursts), 6)
    return (parts,
            round(sc.duration_s, 6),
            round(sc.profile.base_rate * sc.duration_s, 6),
            burst_load,
            round(sc.profile.amplitude, 6),
            sc.n_models,
            sc.train_workers)


def _rep(sc: Scenario, **kw) -> Scenario:
    return dataclasses.replace(sc, **kw)


def _rep_profile(sc: Scenario, **kw) -> Scenario:
    return _rep(sc, profile=dataclasses.replace(sc.profile, **kw))


# ---------------------------------------------------- the pass catalog
def _p_drop_all_chaos(sc: Scenario) -> Iterator[Scenario]:
    if sc.chaos:
        yield _rep(sc, chaos=())


def _p_drop_one_chaos(sc: Scenario) -> Iterator[Scenario]:
    for i in range(len(sc.chaos)):
        yield _rep(sc, chaos=sc.chaos[:i] + sc.chaos[i + 1:])


def _p_disable_training(sc: Scenario) -> Iterator[Scenario]:
    if sc.train_workers > 0:
        yield _rep(sc, train_workers=0)


def _p_disable_broker(sc: Scenario) -> Iterator[Scenario]:
    if sc.broker_capacity_chips > 0:
        yield _rep(sc, broker_capacity_chips=0, batch_backlog=0,
                   batch_max_units=0)


def _p_disable_models(sc: Scenario) -> Iterator[Scenario]:
    if sc.n_models > 0:
        yield _rep(sc, n_models=0, model_slo_ttft_s=0.0,
                   target_swap_s=0.0)


def _p_halve_models(sc: Scenario) -> Iterator[Scenario]:
    if sc.n_models > 1:
        yield _rep(sc, n_models=sc.n_models // 2)


def _p_single_tenant(sc: Scenario) -> Iterator[Scenario]:
    if len(sc.tenants.names) > 1:
        yield _rep(sc, tenants=TenantMix(names=(sc.tenants.names[0],),
                                         weights=(1.0,)))


def _p_drop_one_burst(sc: Scenario) -> Iterator[Scenario]:
    b = sc.profile.bursts
    for i in range(len(b)):
        yield _rep_profile(sc, bursts=b[:i] + b[i + 1:])


def _p_halve_burst(sc: Scenario) -> Iterator[Scenario]:
    b = sc.profile.bursts
    for i, (start, length, mult) in enumerate(b):
        if mult > 2.0:
            shrunk = (start, length, round(max(mult / 2.0, 1.5), 6))
            yield _rep_profile(sc, bursts=b[:i] + (shrunk,) + b[i + 1:])
        if length > 20.0:
            shrunk = (start, round(length / 2.0, 6), mult)
            yield _rep_profile(sc, bursts=b[:i] + (shrunk,) + b[i + 1:])


def _p_halve_duration(sc: Scenario) -> Iterator[Scenario]:
    if sc.duration_s > 2.0 * MIN_DURATION_S:
        yield _rep(sc, duration_s=round(max(sc.duration_s / 2.0,
                                            MIN_DURATION_S), 6))


def _p_halve_rate(sc: Scenario) -> Iterator[Scenario]:
    if sc.profile.base_rate > 1.0:
        yield _rep_profile(sc, base_rate=round(
            max(sc.profile.base_rate / 2.0, 0.5), 6))


def _p_flatten_curve(sc: Scenario) -> Iterator[Scenario]:
    if sc.profile.amplitude > 0.0:
        yield _rep_profile(sc, amplitude=0.0)


#: fixed order, strongest structural simplifications first — append
#: only (reordering changes every pinned minimum)
PASSES: Tuple[Tuple[str, Callable[[Scenario], Iterator[Scenario]]], ...] = (
    ("drop_all_chaos", _p_drop_all_chaos),
    ("drop_one_chaos", _p_drop_one_chaos),
    ("disable_training", _p_disable_training),
    ("disable_broker", _p_disable_broker),
    ("disable_models", _p_disable_models),
    ("single_tenant", _p_single_tenant),
    ("drop_one_burst", _p_drop_one_burst),
    ("halve_burst", _p_halve_burst),
    ("halve_duration", _p_halve_duration),
    ("halve_rate", _p_halve_rate),
    ("flatten_curve", _p_flatten_curve),
    ("halve_models", _p_halve_models),
)


@dataclasses.dataclass(frozen=True)
class ShrinkResult:
    scenario: Scenario
    verdict: Verdict
    evals: int
    steps: Tuple[str, ...]        # accepted pass names, in order


def shrink(scenario: Scenario, verdict: Verdict, judge: Judge,
           budget: int = 64,
           required_kinds: Optional[Tuple[str, ...]] = None
           ) -> ShrinkResult:
    """Minimize ``scenario`` (which ``judge`` scored as ``verdict``)
    until no catalog pass improves it or ``budget`` oracle evaluations
    are spent. ``required_kinds`` defaults to the verdict's kinds."""
    required = set(required_kinds if required_kinds is not None
                   else verdict.kinds)
    if not required:
        raise ValueError("shrink needs a failing verdict")
    cur, cur_verdict = scenario, verdict
    evals = 0
    steps: List[str] = []
    improved = True
    while improved and evals < budget:
        improved = False
        for name, gen in PASSES:
            accepted = False
            for cand in gen(cur):
                if evals >= budget:
                    break
                try:
                    cand_c = complexity(cand)
                except ValueError:
                    continue
                if not cand_c < complexity(cur):
                    continue
                v = judge(cand)
                evals += 1
                if required <= set(v.kinds):
                    cur, cur_verdict = cand, v
                    steps.append(name)
                    accepted = True
                    break
            if accepted:
                improved = True
                break   # restart the catalog from the top
            if evals >= budget:
                break
    return ShrinkResult(scenario=cur, verdict=cur_verdict, evals=evals,
                        steps=tuple(steps))
