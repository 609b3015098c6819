"""The oracle layer: score one finished twin run for *genuine*
failures.

"Genuine" is the load-bearing word — a fuzzer whose oracle counts any
page or any scale-up as a bug drowns in noise. Every check here maps to
an invariant the repo already holds elsewhere:

* ``slo_budget_exhausted`` — a TTFT error budget (fleet or per-model)
  ends the run in the ``exhausted`` state: the SLO engine's terminal
  verdict, not a transient page.
* ``autoscaler_thrash`` — committed fleet decisions reverse direction
  (up→down→up…) at least ``thrash_reversals`` times inside any
  ``thrash_window_s`` span: the oscillation the flap guard and
  cooldowns exist to prevent.
* ``request_refusals`` — interactive requests rejected at admission
  (``summary["rejected"] > 0``); the serving plane queues, degrades,
  and scales before it ever refuses.
* ``accounting_break`` — zero-silent-loss arithmetic fails:
  ``requests != served + rejected``, the tracer dropped spans, or the
  batch lane lost work units.
* ``open_horizon_leak`` — a committed decision's effect horizon is
  still open ``horizon_grace_s`` after it landed: the why-chain
  machinery lost track of an in-flight effect (decisions committed
  *near the end of the run* are inside the grace window and exempt —
  their compile legitimately outlives the horizon).
* ``report_check:<tool>`` — a production report gate fails on the
  run's artifact set. The gate itself is INJECTED (`report_gate` on
  `OracleConfig`): ``sim/`` must not import the reports that
  audit it, so ``fuzz_run`` supplies the real gate and library
  users may run oracle-only. ``why_report``/``slo_report`` are only
  meaningful on runs that paged, so the gate receives the page count
  and skips them when it is zero.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from tpu_on_k8s_torch.obs.ledger import committed
from tpu_on_k8s_torch.sim.scenario import Scenario
from tpu_on_k8s_torch.sim.twin import DigitalTwin

FAIL_SLO_EXHAUSTED = "slo_budget_exhausted"
FAIL_THRASH = "autoscaler_thrash"
FAIL_REFUSALS = "request_refusals"
FAIL_ACCOUNTING = "accounting_break"
FAIL_HORIZON = "open_horizon_leak"
FAIL_REPORT_PREFIX = "report_check"

#: (outdir, pages) -> [(tool_name, exit_code), ...]
ReportGate = Callable[[str, int], Sequence[Tuple[str, int]]]


@dataclasses.dataclass(frozen=True)
class OracleConfig:
    """Failure thresholds. The defaults are tuned so every *passing*
    registered preset judges clean (tests pin that) — tighten them and
    the fuzzer starts reporting the control plane's normal behavior as
    bugs."""

    #: 4, not 3: the million_diurnal acceptance day legitimately makes
    #: three committed reversals riding its steepest diurnal shoulder —
    #: a blessed preset must judge clean at the default thresholds
    thrash_reversals: int = 4
    thrash_window_s: float = 300.0
    #: None derives per scenario: two compiles plus a scrape and a
    #: reconcile period — the longest an honest horizon stays open
    horizon_grace_s: Optional[float] = None
    report_gate: Optional[ReportGate] = None


@dataclasses.dataclass(frozen=True)
class Failure:
    kind: str
    detail: str


@dataclasses.dataclass(frozen=True)
class Verdict:
    """What the oracle concluded about one run. ``kinds`` is the
    sorted, de-duplicated failure-kind tuple — the shrinker preserves
    it and the corpus pins it."""

    kinds: Tuple[str, ...]
    failures: Tuple[Failure, ...]

    @property
    def failing(self) -> bool:
        return bool(self.kinds)

    @staticmethod
    def of(failures: Sequence[Failure]) -> "Verdict":
        kinds = tuple(sorted({f.kind for f in failures}))
        return Verdict(kinds=kinds, failures=tuple(failures))


def _grace_s(sc: Scenario, cfg: OracleConfig) -> float:
    if cfg.horizon_grace_s is not None:
        return cfg.horizon_grace_s
    return (2.0 * sc.cost.compile_s + sc.scrape_period_s
            + sc.reconcile_period_s)


# ------------------------------------------------------------ the checks
def _check_slo(summary: Dict[str, Any], slo_final: Dict[str, str]
               ) -> List[Failure]:
    out = []
    exhausted = sorted(n for n, s in slo_final.items() if s == "exhausted")
    if exhausted:
        out.append(Failure(FAIL_SLO_EXHAUSTED,
                           f"fleet objectives exhausted at end of run: "
                           f"{', '.join(exhausted)}"))
    model_exhausted = (summary.get("models") or {}).get("slo_exhausted")
    if model_exhausted:
        out.append(Failure(FAIL_SLO_EXHAUSTED,
                           f"per-model budgets exhausted: "
                           f"{', '.join(model_exhausted)}"))
    return out


def _check_thrash(records: List[Dict[str, Any]],
                  cfg: OracleConfig) -> List[Failure]:
    by_loop: Dict[str, List[Tuple[float, str]]] = {}
    for r in records:
        if (r.get("kind") == "decision"
                and str(r.get("loop", "")).startswith("fleetautoscaler/")
                and r.get("action") in ("up", "down")
                and committed(str(r.get("commit", "")))):
            by_loop.setdefault(r["loop"], []).append(
                (float(r["t"]), r["action"]))
    out = []
    for loop, moves in sorted(by_loop.items()):
        reversals = [t for (t, a), (_, prev) in
                     zip(moves[1:], moves[:-1]) if a != prev]
        # sliding window: enough direction flips close together?
        for i in range(len(reversals)):
            j = i
            while (j + 1 < len(reversals)
                   and reversals[j + 1] - reversals[i]
                   <= cfg.thrash_window_s):
                j += 1
            n = j - i + 1
            if n >= cfg.thrash_reversals:
                out.append(Failure(
                    FAIL_THRASH,
                    f"{loop}: {n} direction reversals within "
                    f"{cfg.thrash_window_s:g}s "
                    f"(t={reversals[i]:.1f}..{reversals[j]:.1f})"))
                break
    return out


def _check_refusals(summary: Dict[str, Any]) -> List[Failure]:
    rejected = int(summary.get("rejected", 0))
    if rejected > 0:
        return [Failure(FAIL_REFUSALS,
                        f"{rejected} interactive requests refused at "
                        f"admission")]
    return []


def _check_accounting(summary: Dict[str, Any]) -> List[Failure]:
    out = []
    requests = int(summary.get("requests", 0))
    served = int(summary.get("served", 0))
    rejected = int(summary.get("rejected", 0))
    if requests != served + rejected:
        out.append(Failure(FAIL_ACCOUNTING,
                           f"requests={requests} != served={served} + "
                           f"rejected={rejected}"))
    dropped = int(summary.get("spans_dropped", 0))
    if dropped > 0:
        out.append(Failure(FAIL_ACCOUNTING,
                           f"{dropped} trace spans dropped"))
    if summary.get("batch_intact") is False:
        out.append(Failure(FAIL_ACCOUNTING, "batch lane lost work units"))
    return out


def _check_horizons(records: List[Dict[str, Any]], sc: Scenario,
                    cfg: OracleConfig) -> List[Failure]:
    closed = {r.get("decision") for r in records
              if r.get("kind") == "horizon" and r.get("closing")}
    grace = _grace_s(sc, cfg)
    leaks = []
    for r in records:
        if (r.get("kind") == "decision" and r.get("horizon") == "open"
                and r.get("seq") not in closed
                and float(r.get("t", 0.0)) < sc.duration_s - grace):
            leaks.append(r)
    if not leaks:
        return []
    what = ", ".join(f"seq={r['seq']}@t={float(r['t']):.1f}"
                     for r in leaks[:5])
    return [Failure(FAIL_HORIZON,
                    f"{len(leaks)} effect horizons still open "
                    f">{grace:g}s after commit: {what}")]


def _check_reports(outdir: str, pages: int,
                   cfg: OracleConfig) -> List[Failure]:
    if cfg.report_gate is None:
        return []
    out = []
    for tool, rc in cfg.report_gate(outdir, pages):
        if rc != 0:
            out.append(Failure(f"{FAIL_REPORT_PREFIX}:{tool}",
                               f"{tool} exited {rc}"))
    return out


# ------------------------------------------------------------- top level
def judge_run(twin: DigitalTwin, outdir: Optional[str] = None,
              cfg: Optional[OracleConfig] = None) -> Verdict:
    """Judge one *finished* twin (``run()`` returned, and — when report
    gates are armed — ``write(outdir)`` already emitted the artifact
    set there)."""
    cfg = cfg or OracleConfig()
    sc = twin.scenario
    summary = twin.summary
    records = twin.ledger.export()
    svc_slo: Dict[str, str] = {}
    from tpu_on_k8s_torch.api.inference_types import InferenceService
    from tpu_on_k8s_torch.sim.twin import SERVICE_NAME, SERVICE_NS
    service = twin.cluster.get(InferenceService, SERVICE_NS, SERVICE_NAME)
    if service is not None and service.status.slo:
        svc_slo = {name: st.state
                   for name, st in sorted(service.status.slo.items())}
    failures: List[Failure] = []
    failures += _check_slo(summary, svc_slo)
    failures += _check_thrash(records, cfg)
    failures += _check_refusals(summary)
    failures += _check_accounting(summary)
    failures += _check_horizons(records, sc, cfg)
    if outdir is not None:
        failures += _check_reports(outdir, int(summary.get("pages", 0)),
                                   cfg)
    return Verdict.of(failures)


def run_and_judge(scenario: Scenario,
                  cfg: Optional[OracleConfig] = None,
                  outdir: Optional[str] = None
                  ) -> Tuple[Verdict, Dict[str, Any]]:
    """Run one scenario through the twin and judge it. With ``outdir``
    the artifact set is written there (and kept); otherwise a temp dir
    holds it just long enough for the report gates and is removed."""
    cfg = cfg or OracleConfig()
    twin = DigitalTwin(scenario)
    summary = twin.run()
    tmp = None
    out = outdir
    if out is None and cfg.report_gate is not None:
        tmp = tempfile.mkdtemp(prefix="tpu_on_k8s_fuzz_")
        out = tmp
    try:
        if out is not None:
            twin.write(out)
        verdict = judge_run(twin, out, cfg)
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return verdict, summary
