"""Whole-cluster digital twin: a deterministic cluster-in-a-process
simulator (the counterpart of ``tpu_on_k8s/sim/``).

Every control loop is a `LoopKernel` subclass with an injectable clock,
one `DecisionLedger`, byte-identical seeded replays. This package is the
thing those injection seams exist *for*: it stands a virtual device
layer in for GPU hosts and drives the REAL control plane —
`FleetAutoscaler`, `ElasticAutoscaler`, `SLOEngine`, the
`torchjob`/`inferenceservice` reconcilers — against seeded
million-request, multi-tenant, diurnal traffic on one shared virtual
clock, far faster than real time.

Layout (each module's docstring carries its own contract):

* `clock`     — `SimClock` + the discrete-event `EventLoop` that
  advances the clock to the next due event instead of ticking fixed
  periods.
* `traffic`   — the seeded generators: `build_workload`/`Arrival`, the
  load driver's trace, and `build_diurnal_trace`, the vectorized
  million-scale variant.
* `devices`   — the virtual device/slice layer: per-replica slot
  capacity, compile/prefill/decode latencies priced by the same cost
  model constants `serve_load`'s virtual modes use, preemption.
* `scenario`  — the scenario DSL: traffic phases + chaos schedules
  compiled onto the existing `FaultRule` machinery (no new chaos
  sites), plus the seeded presets the soak drivers run.
* `calibrate` — the closed-form fit of the cost model's constants from
  measurement documents (the card's, written by ``chip_smoke.py``).
* `twin`      — the harness wiring InMemoryCluster, reconcilers,
  autoscalers, SLO engines, tracer, and ledger together and emitting
  the SAME dump formats as production, so `obs/trace_report`,
  `obs/why_report`, and `obs/slo_report` run unmodified on twin output.
* `fuzz`      — seeded adversarial search over the scenario DSL.

Determinism contract: everything observable is a pure function of the
scenario seed. Wall-clock only ever enters through the *injected*
``wall_clock`` callable (the ``twin_soak`` driver passes
``time.perf_counter``; the default is "no wall timing") and lands only
in the perf side-channel, never in byte-compared artifacts.
"""
from tpu_on_k8s_torch.sim.clock import EventLoop, SimClock
from tpu_on_k8s_torch.sim.devices import (
    DeviceCostModel,
    SimFleet,
    SimReplica,
    SimRequest,
)
from tpu_on_k8s_torch.sim.scenario import (
    ChaosWindow,
    Scenario,
    million_diurnal,
    smoke,
)
from tpu_on_k8s_torch.sim.traffic import (
    Arrival,
    ArrivalTrace,
    DiurnalProfile,
    ModelMix,
    TenantMix,
    build_diurnal_trace,
    build_workload,
    diurnal_rate,
)
from tpu_on_k8s_torch.sim.twin import DigitalTwin, run_twin

__all__ = [
    "Arrival",
    "ArrivalTrace",
    "ChaosWindow",
    "DeviceCostModel",
    "DigitalTwin",
    "DiurnalProfile",
    "EventLoop",
    "ModelMix",
    "Scenario",
    "SimClock",
    "SimFleet",
    "SimReplica",
    "SimRequest",
    "TenantMix",
    "build_diurnal_trace",
    "build_workload",
    "diurnal_rate",
    "million_diurnal",
    "run_twin",
    "smoke",
]
