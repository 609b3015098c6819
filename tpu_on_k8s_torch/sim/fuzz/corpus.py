"""The regression corpus: minimized failing scenarios checked into a
corpus directory as JSON entries that the tests replay forever (a copy
of ``tpu_on_k8s/sim/fuzz/corpus.py``; the format string names the
project, not the device).

An entry pins three things: the minimized `Scenario` (serialized via
`sim/scenario.scenario_to_doc`), the oracle verdict the fuzz campaign
observed (the failure kinds plus their human-readable details), and
provenance (which preset it grew from, the campaign seed, the mutators
applied, the shrink passes accepted) so a red replay is diagnosable
without re-running the campaign.

``status`` carries the corpus workflow:

* ``known_weakness`` — the bug is real and unfixed; the tier-1 replay
  asserts the oracle STILL reports exactly the pinned kinds (the entry
  is an executable bug report, and a silent behavior change in either
  direction is a finding);
* ``regression_guard`` — the bug was fixed; the replay asserts the
  oracle is clean. Flipping a fixed entry's status (and clearing its
  pinned kinds) is the whole fix-verification ceremony.

`replay` also re-asserts the twin's replayability: the entry's
scenario runs twice into fresh directories and every artifact must
byte-compare equal — a corpus entry that cannot replay byte-identically
cannot pin anything.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpu_on_k8s_torch.sim.fuzz.oracle import (
    OracleConfig,
    Verdict,
    run_and_judge,
)
from tpu_on_k8s_torch.sim.scenario import (
    Scenario,
    scenario_from_doc,
    scenario_to_doc,
)
from tpu_on_k8s_torch.sim.twin import (
    LEDGER_FILE,
    SLO_FILE,
    SUMMARY_FILE,
    TRACE_FILE,
)

CORPUS_FORMAT = "tpu-on-k8s-fuzz/v1"
STATUS_WEAKNESS = "known_weakness"
STATUS_GUARD = "regression_guard"
ARTIFACTS = (TRACE_FILE, LEDGER_FILE, SLO_FILE, SUMMARY_FILE)


def entry_name(base: str, kinds: Sequence[str],
               scenario_doc: Dict[str, Any]) -> str:
    """Stable, content-derived entry id: base preset, primary failure
    kind, and an 8-hex digest of the canonical scenario doc."""
    blob = json.dumps(scenario_doc, sort_keys=True,
                      separators=(",", ":")).encode()
    digest = hashlib.sha256(blob).hexdigest()[:8]
    primary = (kinds[0] if kinds else "clean").replace(":", "_")
    return f"{base}-{primary}-{digest}"


def make_entry(scenario: Scenario, verdict: Verdict, *, base: str,
               fuzz_seed: int, mutations: Sequence[str] = (),
               shrink_steps: Sequence[str] = (), evals: int = 0,
               status: str = STATUS_WEAKNESS,
               artifacts_sha256: Optional[Dict[str, str]] = None
               ) -> Dict[str, Any]:
    if status not in (STATUS_WEAKNESS, STATUS_GUARD):
        raise ValueError(f"unknown corpus status {status!r}")
    sdoc = scenario_to_doc(scenario)
    entry: Dict[str, Any] = {
        "format": CORPUS_FORMAT,
        "name": entry_name(base, verdict.kinds, sdoc),
        "status": status,
        "scenario": sdoc,
        "oracle": {
            "kinds": list(verdict.kinds),
            "failures": [{"kind": f.kind, "detail": f.detail}
                         for f in verdict.failures],
        },
        "provenance": {
            "base": base,
            "fuzz_seed": fuzz_seed,
            "mutations": list(mutations),
            "shrink_steps": list(shrink_steps),
            "evals": evals,
        },
    }
    if artifacts_sha256:
        entry["artifacts_sha256"] = dict(sorted(artifacts_sha256.items()))
    return entry


def write_entry(corpus_dir: str, entry: Dict[str, Any]) -> str:
    os.makedirs(corpus_dir, exist_ok=True)
    path = os.path.join(corpus_dir, f"{entry['name']}.json")
    with open(path, "w") as f:
        json.dump(entry, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_entries(corpus_dir: str) -> List[Tuple[str, Dict[str, Any]]]:
    """Every ``*.json`` entry under ``corpus_dir``, sorted by filename.
    A file that is not a corpus entry is an error — the corpus
    directory is not a scratch space."""
    out = []
    if not os.path.isdir(corpus_dir):
        return out
    for fname in sorted(os.listdir(corpus_dir)):
        if not fname.endswith(".json"):
            continue
        path = os.path.join(corpus_dir, fname)
        with open(path) as f:
            doc = json.load(f)
        if doc.get("format") != CORPUS_FORMAT:
            raise ValueError(f"{path}: not a fuzz corpus entry "
                             f"(format={doc.get('format')!r})")
        out.append((path, doc))
    return out


def artifact_hashes(outdir: str) -> Dict[str, str]:
    out = {}
    for fname in ARTIFACTS:
        path = os.path.join(outdir, fname)
        if os.path.exists(path):
            with open(path, "rb") as f:
                out[fname] = hashlib.sha256(f.read()).hexdigest()
    return out


@dataclasses.dataclass(frozen=True)
class ReplayResult:
    """One entry replayed twice. ``ok`` folds the three assertions:
    bytes identical across the two runs, and the observed kinds match
    the entry's contract for its status."""

    name: str
    status: str
    pinned_kinds: Tuple[str, ...]
    observed_kinds: Tuple[str, ...]
    byte_identical: bool
    artifacts_sha256: Dict[str, str]
    details: Tuple[str, ...]

    @property
    def kinds_match(self) -> bool:
        if self.status == STATUS_GUARD:
            return not self.observed_kinds
        return self.observed_kinds == self.pinned_kinds

    @property
    def ok(self) -> bool:
        return self.byte_identical and self.kinds_match


def replay(entry: Dict[str, Any],
           cfg: Optional[OracleConfig] = None) -> ReplayResult:
    """Run the entry's scenario twice, byte-compare every artifact,
    and judge the first run against the pinned verdict."""
    sc = scenario_from_doc(entry["scenario"])
    pinned = tuple(entry.get("oracle", {}).get("kinds", ()))
    tmp = tempfile.mkdtemp(prefix="tpu_on_k8s_fuzz_replay_")
    details: List[str] = []
    try:
        dir_a = os.path.join(tmp, "a")
        dir_b = os.path.join(tmp, "b")
        verdict, _ = run_and_judge(sc, cfg, outdir=dir_a)
        run_and_judge(sc, cfg, outdir=dir_b)
        sha_a = artifact_hashes(dir_a)
        sha_b = artifact_hashes(dir_b)
        identical = sha_a == sha_b and set(sha_a) == set(ARTIFACTS)
        if not identical:
            diff = sorted(f for f in set(sha_a) | set(sha_b)
                          if sha_a.get(f) != sha_b.get(f))
            details.append("artifacts differ across replays: "
                           + ", ".join(diff))
        for f in verdict.failures:
            details.append(f"{f.kind}: {f.detail}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return ReplayResult(
        name=str(entry.get("name", "?")),
        status=str(entry.get("status", STATUS_WEAKNESS)),
        pinned_kinds=pinned,
        observed_kinds=verdict.kinds,
        byte_identical=identical,
        artifacts_sha256=sha_a,
        details=tuple(details))
