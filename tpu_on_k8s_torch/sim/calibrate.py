"""Fit `sim/devices.DeviceCostModel` constants from measurements of the
port on the card, so the twin prices virtual latency with numbers the
hardware actually produced instead of hand-picked defaults (a copy of
``tpu_on_k8s/sim/calibrate.py``: the same closed-form fit, bit for bit).
``chip_smoke.py``'s twin phase writes one such document from the
``ContinuousBatchingEngine`` on the card and fits it with ``main``.

The inputs are measurement documents in the reference's bench schema
(``CHIPWINDOW_*.json`` / ``BENCH_*.json``): a JSON object whose
top-level values are either run metadata or *stage* dicts.
A stage that died carries ``{"error": ...}`` or ``{"rc": <nonzero>}``
and is skipped; a live stage carries measurements in one of three
shapes this module understands:

* a parsed metric row — ``{"metric": ..., "value": ..., "unit": ...}``
  either directly or under ``"parsed"`` (the BENCH_*.json shape).
  Recognized metrics: ``decode_step_s`` / ``decode_step_ms`` (decode
  step wall time), ``prefill_s_per_token`` / ``prefill_ms_per_token``
  (prefill slope), ``compile_s`` / ``compile_ms``;
* sample lists — ``"decode_steps": [s, ...]`` (seconds per decode
  step), ``"compiles": [s, ...]`` (seconds per compile);
* prefill pairs — ``"prefills": [[prompt_len, seconds], ...]``.

Real windows are messy — a doc where every stage timed out fits
*nothing* and the calibration falls back to the base model, per
constant. The fit is deliberately simple and closed-form, so two runs
over the same docs are bit-identical (the determinism gate covers this
module like the rest of ``sim/``):

* ``step_s``  = median of all decode step samples;
* ``prefill_cost`` = least-squares-through-origin slope of prefill
  seconds vs prompt length, divided by the fitted ``step_s`` (the cost
  model prices prefill as ``step_s * prefill_cost * prompt_len``);
* ``compile_s`` = median of all compile samples.

`CostBounds` wraps a calibration (or a bare cost model) into the
per-constant intervals the scenario fuzzer is allowed to wander in —
"cost-model constants within calibrated bounds" means mutations stay
inside ``[value/ (1+spread), value * (1+spread)]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

from tpu_on_k8s_torch.sim.devices import DeviceCostModel

CALIBRATION_FORMAT = "tpu-on-k8s-calibration/v1"

# metric-name -> (target, seconds-per-unit) for parsed metric rows
_METRIC_MAP = {
    "decode_step_s": ("step", 1.0),
    "decode_step_ms": ("step", 1e-3),
    "prefill_s_per_token": ("prefill_slope", 1.0),
    "prefill_ms_per_token": ("prefill_slope", 1e-3),
    "compile_s": ("compile", 1.0),
    "compile_ms": ("compile", 1e-3),
}


@dataclasses.dataclass(frozen=True)
class Measurements:
    """Everything usable pulled out of one or more measurement docs."""

    decode_steps: Tuple[float, ...] = ()
    prefills: Tuple[Tuple[float, float], ...] = ()   # (prompt_len, s)
    prefill_slopes: Tuple[float, ...] = ()           # s per token
    compiles: Tuple[float, ...] = ()

    def merged(self, other: "Measurements") -> "Measurements":
        return Measurements(
            self.decode_steps + other.decode_steps,
            self.prefills + other.prefills,
            self.prefill_slopes + other.prefill_slopes,
            self.compiles + other.compiles)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """The fitted constants plus how much evidence backed each one.
    A constant with zero samples keeps the base model's value and is
    absent from ``fitted``."""

    step_s: float
    prefill_cost: float
    compile_s: float
    n_steps: int = 0
    n_prefills: int = 0
    n_compiles: int = 0

    @property
    def fitted(self) -> List[str]:
        out = []
        if self.n_steps:
            out.append("step_s")
        if self.n_prefills:
            out.append("prefill_cost")
        if self.n_compiles:
            out.append("compile_s")
        return out

    def cost_model(self, base: Optional[DeviceCostModel] = None
                   ) -> DeviceCostModel:
        """The base model with every fitted constant replaced."""
        base = base or DeviceCostModel()
        return dataclasses.replace(
            base, step_s=self.step_s, prefill_cost=self.prefill_cost,
            compile_s=self.compile_s)

    def to_doc(self) -> Dict[str, Any]:
        return {
            "format": CALIBRATION_FORMAT,
            "step_s": self.step_s,
            "prefill_cost": self.prefill_cost,
            "compile_s": self.compile_s,
            "n_steps": self.n_steps,
            "n_prefills": self.n_prefills,
            "n_compiles": self.n_compiles,
            "fitted": self.fitted,
        }


def calibration_from_doc(doc: Dict[str, Any]) -> Calibration:
    fmt = doc.get("format")
    if fmt != CALIBRATION_FORMAT:
        raise ValueError(f"not a calibration doc (format={fmt!r})")
    return Calibration(
        step_s=float(doc["step_s"]),
        prefill_cost=float(doc["prefill_cost"]),
        compile_s=float(doc["compile_s"]),
        n_steps=int(doc.get("n_steps", 0)),
        n_prefills=int(doc.get("n_prefills", 0)),
        n_compiles=int(doc.get("n_compiles", 0)))


# ------------------------------------------------------------ extraction
def _stage_alive(stage: Dict[str, Any]) -> bool:
    if "error" in stage or "err" in stage:
        return False
    rc = stage.get("rc")
    return not (isinstance(rc, int) and rc != 0)


def _floats(v: Any) -> List[float]:
    if not isinstance(v, list):
        return []
    out = []
    for x in v:
        if isinstance(x, (int, float)) and x > 0:
            out.append(float(x))
    return out


def _pairs(v: Any) -> List[Tuple[float, float]]:
    out = []
    if not isinstance(v, list):
        return out
    for row in v:
        if (isinstance(row, (list, tuple)) and len(row) == 2
                and all(isinstance(x, (int, float)) for x in row)
                and row[0] > 0 and row[1] > 0):
            out.append((float(row[0]), float(row[1])))
    return out


def _metric_rows(stage: Dict[str, Any]) -> List[Dict[str, Any]]:
    rows = []
    if isinstance(stage.get("metric"), str):
        rows.append(stage)
    parsed = stage.get("parsed")
    if isinstance(parsed, dict) and isinstance(parsed.get("metric"), str):
        rows.append(parsed)
    return rows


def extract_measurements(doc: Dict[str, Any]) -> Measurements:
    """Pull every usable sample out of one measurement doc. Stages that
    errored or exited nonzero contribute nothing; a doc with no live
    stages yields an empty Measurements (not an error — the caller
    decides whether an evidence-free fit is acceptable)."""
    steps: List[float] = []
    prefills: List[Tuple[float, float]] = []
    slopes: List[float] = []
    compiles: List[float] = []
    stages: Iterable[Tuple[str, Any]] = doc.items()
    for key, stage in stages:
        if key == "parsed":
            # the flat BENCH shape: `parsed` is the DOC's metric row,
            # governed by the doc's own rc — handled below, not a stage
            continue
        if not isinstance(stage, dict) or not _stage_alive(stage):
            continue
        steps.extend(_floats(stage.get("decode_steps")))
        compiles.extend(_floats(stage.get("compiles")))
        prefills.extend(_pairs(stage.get("prefills")))
        for row in _metric_rows(stage):
            tgt = _METRIC_MAP.get(row["metric"])
            v = row.get("value")
            if tgt is None or not isinstance(v, (int, float)) or v <= 0:
                continue
            kind, scale = tgt
            if kind == "step":
                steps.append(v * scale)
            elif kind == "prefill_slope":
                slopes.append(v * scale)
            elif kind == "compile":
                compiles.append(v * scale)
    # the doc itself may be one flat stage (BENCH_*.json shape)
    if _stage_alive(doc):
        for row in _metric_rows(doc):
            tgt = _METRIC_MAP.get(row["metric"])
            v = row.get("value")
            if tgt is None or not isinstance(v, (int, float)) or v <= 0:
                continue
            kind, scale = tgt
            if kind == "step":
                steps.append(v * scale)
            elif kind == "prefill_slope":
                slopes.append(v * scale)
            elif kind == "compile":
                compiles.append(v * scale)
    return Measurements(tuple(steps), tuple(prefills), tuple(slopes),
                        tuple(compiles))


# ------------------------------------------------------------------- fit
def _median(xs: Tuple[float, ...]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def fit(measurements: Measurements,
        base: Optional[DeviceCostModel] = None) -> Calibration:
    """Closed-form fit (see module doc). Constants without evidence
    keep the base model's value."""
    base = base or DeviceCostModel()
    m = measurements
    step_s = _median(m.decode_steps) if m.decode_steps else base.step_s
    n_pre = len(m.prefills) + len(m.prefill_slopes)
    if m.prefills:
        # least squares through the origin: slope = sum(l*s) / sum(l^2),
        # pooled with any directly-reported per-token slopes
        num = sum(length * s for length, s in m.prefills)
        den = sum(length * length for length, _ in m.prefills)
        slopes = list(m.prefill_slopes) + [num / den]
        slope = sum(slopes) / len(slopes)
        prefill_cost = slope / step_s
    elif m.prefill_slopes:
        slope = sum(m.prefill_slopes) / len(m.prefill_slopes)
        prefill_cost = slope / step_s
    else:
        prefill_cost = base.prefill_cost
    compile_s = _median(m.compiles) if m.compiles else base.compile_s
    return Calibration(
        step_s=round(step_s, 9), prefill_cost=round(prefill_cost, 9),
        compile_s=round(compile_s, 9), n_steps=len(m.decode_steps),
        n_prefills=n_pre, n_compiles=len(m.compiles))


def fit_files(paths: Iterable[str],
              base: Optional[DeviceCostModel] = None) -> Calibration:
    """Load + merge every doc, then fit. Unreadable / non-JSON files
    are an error; error-laden stages inside a readable doc are not."""
    merged = Measurements()
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        if not isinstance(doc, dict):
            raise ValueError(f"{p}: measurement doc must be an object")
        merged = merged.merged(extract_measurements(doc))
    return fit(merged, base)


# ---------------------------------------------------------------- bounds
@dataclasses.dataclass(frozen=True)
class CostBounds:
    """Per-constant intervals a fuzzed cost model must stay inside —
    the "calibrated bounds" of the scenario mutation engine."""

    step_s: Tuple[float, float]
    prefill_cost: Tuple[float, float]
    compile_s: Tuple[float, float]

    @staticmethod
    def around(cost: DeviceCostModel, spread: float = 0.5) -> "CostBounds":
        """Symmetric multiplicative bounds around one cost model."""
        if spread < 0:
            raise ValueError("spread must be >= 0")

        def band(v: float) -> Tuple[float, float]:
            return (v / (1.0 + spread), v * (1.0 + spread))

        return CostBounds(band(cost.step_s), band(cost.prefill_cost),
                          band(cost.compile_s))

    def clamp(self, cost: DeviceCostModel) -> DeviceCostModel:
        def pin(v: float, lo_hi: Tuple[float, float]) -> float:
            return min(max(v, lo_hi[0]), lo_hi[1])

        return dataclasses.replace(
            cost,
            step_s=pin(cost.step_s, self.step_s),
            prefill_cost=pin(cost.prefill_cost, self.prefill_cost),
            compile_s=pin(cost.compile_s, self.compile_s))


# ------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="fit DeviceCostModel constants from measurement "
                    "docs (stage dicts of decode_steps / compiles / "
                    "prefills, or bench metric rows)")
    p.add_argument("paths", nargs="+",
                   help="measurement documents (JSON)")
    p.add_argument("--strict", action="store_true",
                   help="exit 3 when no constant could be fitted")
    args = p.parse_args(argv)
    cal = fit_files(args.paths)
    print(json.dumps(cal.to_doc(), indent=1, sort_keys=True))
    if args.strict and not cal.fitted:
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
