"""The whole-cluster digital twin: every control loop the port ships,
closed over a virtual device layer, on one discrete-event clock (a copy
of ``tpu_on_k8s/sim/twin.py`` in the GPU flavour: a ``TorchJob`` on
``nvidia-h100-80gb`` hosts, serving replicas on ``1x4`` slices).

One `run_twin` call stands up the REAL control plane — the
`controller/fleetautoscaler.FleetAutoscaler` (scrape → SLO burn →
recommend → patch → apply), the `controller/inferenceservice` reconciler
maintaining the pod shadow of ``spec.replicas``, the `controller/torchjob`
+ `controller/elastic` reconcilers and the
`controller/autoscaler.ElasticAutoscaler` growing a virtual training
job — and closes the loop through `sim/devices.SimFleet`, whose
latencies come from the serve_load cost constants instead of a real
engine. Traffic is a seeded `sim/traffic.build_diurnal_trace`; chaos is
the scenario's windows compiled onto `chaos.FaultRule`s.

The observability surface is PRODUCTION code, not a twin-side imitation:
the same `obs/trace.Tracer` (request span trees minted at completion
via backdated ``at=`` stamps), the same `obs/ledger.DecisionLedger`,
the same budget event log the SLO engine writes. The dumps this module
emits are therefore bit-compatible with `obs/trace_report.py`,
`obs/why_report.py`, and `obs/slo_report.py` — none of them can tell a
rehearsal from a live run, which is the acceptance bar.

Determinism: no wall clock, no unseeded RNG, no unsorted iteration —
every artifact is a pure function of the `Scenario`. Wall time (for the
``speedup`` gauge) is the DRIVER's concern: ``twin_soak`` injects
``time.perf_counter`` through ``wall_clock``; the twin never reads it
itself, so the determinism gate of ``tests/test_torch_package.py``
holds.
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.api.core import (
    Container,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
)
from tpu_on_k8s_torch.api.inference_types import (
    AutoscalePolicy,
    InferenceService,
    InferenceServiceSpec,
    ModelRef,
    SLOObjective,
    SLOPolicy,
)
from tpu_on_k8s_torch.api.types import (
    ElasticPolicy,
    GPUPolicy,
    TaskSpec,
    TaskType,
    TorchJob,
    TorchJobSpec,
)
from tpu_on_k8s_torch.client import InMemoryCluster, KubeletSim
from tpu_on_k8s_torch.controller.autoscaler import setup_elastic_autoscaler
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.elastic import ElasticController
from tpu_on_k8s_torch.controller.failover import InMemoryRestarter
from tpu_on_k8s_torch.controller.fleetautoscaler import FleetAutoscaler
from tpu_on_k8s_torch.controller.inferenceservice import (
    setup_inferenceservice_controller,
)
from tpu_on_k8s_torch.controller.runtime import Manager, Workqueue
from tpu_on_k8s_torch.controller.torchjob import (
    setup_torchjob_controller,
    submit_job,
)
from tpu_on_k8s_torch.coordinator.broker import CapacityBroker
from tpu_on_k8s_torch.gang.topology import chips_in_topology
from tpu_on_k8s_torch.metrics import (
    AutoscaleMetrics,
    BrokerMetrics,
    LedgerMetrics,
    SimMetrics,
)
from tpu_on_k8s_torch.obs.ledger import DecisionLedger
from tpu_on_k8s_torch.obs.slo import page_onsets
from tpu_on_k8s_torch.obs.trace import Tracer
from tpu_on_k8s_torch.serve.batchlane import BatchLane
from tpu_on_k8s_torch.sim.clock import EventLoop, SimClock
from tpu_on_k8s_torch.sim.devices import SimFleet, SimRequest
from tpu_on_k8s_torch.sim.scenario import Scenario
from tpu_on_k8s_torch.sim.traffic import build_diurnal_trace

#: must equal `obs/slo_report.SLO_FORMAT` (asserted by the tests)
SLO_FORMAT = "tpu-on-k8s-slo/v1"

SERVICE_NS = "default"
SERVICE_NAME = "twin"
TRAIN_JOB = "train"

#: the serving fleet's slice shape — one replica owns one of these (the
#: reference's 2x2 TPU slice as 4 GPUs of one host)
REPLICA_TOPOLOGY = "1x4"

#: spans whose request started within this many virtual seconds of a
#: chaos window are pinned through the sampling knob — "chaos-adjacent"
CHAOS_KEEP_MARGIN_S = 30.0

#: canonical artifact names inside a twin output directory (`.gz` trace
#: and ledger exercise the gzip dump path the report loaders accept)
TRACE_FILE = "trace.json.gz"
LEDGER_FILE = "ledger.json.gz"
SLO_FILE = "slo.json"
SUMMARY_FILE = "summary.json"


class DigitalTwin:
    """One rehearsal run. Construct, `run()`, then `write(outdir)` (or
    use the `run_twin` convenience). Separated so tests can poke at the
    live objects (fleet, tracer, ledger) after the loop drains."""

    def __init__(self, scenario: Scenario, *,
                 wall_clock: Optional[Callable[[], float]] = None,
                 max_spans: int = 600_000) -> None:
        self.scenario = scenario
        self.wall_clock = wall_clock
        self.clock = SimClock()
        self.loop = EventLoop(self.clock)
        self.sim_metrics = SimMetrics()
        self.tracer = Tracer(self.clock, max_spans=max_spans,
                             sample_every=scenario.sample_every)
        self.ledger = DecisionLedger(self.clock, metrics=LedgerMetrics())
        self.pages: List[Dict[str, Any]] = []
        self.preempt_log: List[str] = []
        self.rejected = 0
        self._submitted = 0
        self._tick_no = 0
        self._onsets_seen = 0
        self._train_batch = 0
        self._train_frozen = False
        self._svc_key = f"{SERVICE_NS}/{SERVICE_NAME}"
        sc = scenario
        self._peak_replicas = sc.min_replicas
        self.model_served: Dict[str, int] = {}
        self._model_breaches: Dict[str, int] = {}
        self._keep_windows: List[Tuple[float, float]] = [
            (w.at_s - CHAOS_KEEP_MARGIN_S,
             w.at_s + w.duration_s + CHAOS_KEEP_MARGIN_S)
            for w in sc.chaos]
        self._build_cluster()
        self._build_fleet()
        self._build_traffic()
        self._schedule()

    # ------------------------------------------------------------- wiring
    def _build_cluster(self) -> None:
        sc = self.scenario
        self.cluster = InMemoryCluster()
        self.manager = Manager()
        # The capacity market, on the virtual clock: the broker's tick
        # thread is never started — `_broker_tick` drives `run_once`
        # as a scheduled event, so clearing order is deterministic.
        self.broker: Optional[CapacityBroker] = None
        self.broker_metrics: Optional[BrokerMetrics] = None
        self.batch_lane: Optional[BatchLane] = None
        if sc.broker_capacity_chips > 0:
            self.broker_metrics = BrokerMetrics()
            self.broker = CapacityBroker(
                sc.broker_capacity_chips, ledger=self.ledger,
                metrics=self.broker_metrics,
                period_s=sc.broker_period_s)
            if sc.batch_max_units > 0:
                self.batch_lane = BatchLane(
                    max_units=sc.batch_max_units,
                    default_work=sc.batch_work)
                for _ in range(sc.batch_backlog):
                    self.batch_lane.submit()
                self.broker.register(self.batch_lane.name,
                                     self.batch_lane.bid,
                                     apply_fn=self.batch_lane.apply,
                                     managed=True)
        setup_inferenceservice_controller(self.cluster, self.manager,
                                          clock=self.clock)
        elastic = ElasticController(self.cluster,
                                    restarter=InMemoryRestarter())
        # the twin is fully event-driven (every mutation lands as a
        # watch event the same pump drains), so the engine's 30s safety
        # resync is pure reconcile churn at 24 virtual hours — stretch
        # it to once a virtual hour
        job_cfg = JobControllerConfig(sync_period_seconds=3600.0)
        setup_torchjob_controller(self.cluster, self.manager,
                                config=job_cfg,
                                elastic_controller=elastic)
        self.train_scaler = setup_elastic_autoscaler(self.cluster,
                                                     ledger=self.ledger,
                                                     broker=self.broker)
        self.kubelet = KubeletSim(self.cluster)
        # every reconciler workqueue onto the virtual clock (torchjob's
        # default is wall monotonic — delayed requeues would otherwise
        # become due by WALL time, a nondeterminism leak at >1000x)
        for c in self.manager.controllers:
            c.queue = Workqueue(clock=self.clock)

        w = sc.slo_window_s

        def ttft_slo(target: float) -> SLOPolicy:
            return SLOPolicy(objectives=[SLOObjective(
                name="ttft", objective="ttft_p95", target=target,
                window_s=w, fast_short_s=w / 60, fast_long_s=w / 20,
                slow_short_s=w / 12, slow_long_s=w / 4)])
        # the model-pool catalog: every model on the CRD plane, each
        # with its own (looser — the swap tax is priced in) TTFT budget
        models = []
        if sc.n_models > 0:
            per_model = (ttft_slo(sc.model_slo_ttft_s)
                         if sc.model_slo_ttft_s > 0 else None)
            models = [ModelRef(name=m, image="inproc", slo=per_model)
                      for m in sc.model_mix().names]
        self.cluster.create(InferenceService(
            metadata=ObjectMeta(name=SERVICE_NAME),
            spec=InferenceServiceSpec(
                image="inproc", replicas=sc.min_replicas,
                gpu_policy=GPUPolicy(accelerator="nvidia-h100-80gb",
                                     topology=REPLICA_TOPOLOGY),
                autoscale=AutoscalePolicy(
                    min_replicas=sc.min_replicas,
                    max_replicas=sc.max_replicas,
                    min_warm=sc.min_warm,
                    target_ttft_s=sc.target_ttft_s,
                    target_swap_s=sc.target_swap_s,
                    hysteresis=0.1, max_step=sc.max_step,
                    scale_up_cooldown_s=sc.up_cooldown_s,
                    scale_down_cooldown_s=sc.down_cooldown_s,
                    flap_guard_s=sc.flap_guard_s),
                slo=ttft_slo(sc.slo_ttft_s),
                models=models)))
        self.autoscaler = FleetAutoscaler(
            self.cluster,
            config=JobControllerConfig(autoscale_window_scrapes=3,
                                       autoscale_stale_scrapes=3),
            metrics=AutoscaleMetrics(), clock=self.clock,
            tracer=self.tracer, ledger=self.ledger, broker=self.broker)

        if sc.train_workers > 0:
            template = PodTemplateSpec(spec=PodSpec(
                containers=[Container(name="torch", image="inproc")]))
            submit_job(self.cluster, TorchJob(
                metadata=ObjectMeta(name=TRAIN_JOB),
                spec=TorchJobSpec(
                    tasks={TaskType.WORKER: TaskSpec(
                        num_tasks=sc.train_workers, template=template)},
                    elastic_policy=ElasticPolicy(
                        min_replicas=sc.train_workers,
                        max_replicas=sc.train_max_hosts),
                    gpu_policy=GPUPolicy(
                        accelerator="nvidia-h100-80gb",
                        topology=sc.train_topology))))

    def _build_fleet(self) -> None:
        sc = self.scenario
        self.fleet = SimFleet(self.loop, cost=sc.cost,
                              replicas=sc.min_replicas,
                              max_queue_depth=sc.max_queue_depth,
                              on_complete=self._mint)
        self.autoscaler.attach_fleet(SERVICE_NS, SERVICE_NAME, self.fleet)

    def _build_traffic(self) -> None:
        sc = self.scenario
        rng = np.random.default_rng(sc.seed)
        self.trace = build_diurnal_trace(
            rng, profile=sc.profile, tenants=sc.tenants,
            duration_s=sc.duration_s, tick_s=sc.tick_s,
            prompt_lens=sc.prompt_lens, new_tokens=sc.new_tokens,
            models=sc.model_mix() if sc.n_models > 0 else None)

    def _schedule(self) -> None:
        sc = self.scenario
        end = sc.duration_s
        self.loop.every(sc.tick_s, self._tick_arrivals, start_at=0.0,
                        until=end - sc.tick_s)
        self.loop.every(sc.scrape_period_s, self._autoscale_tick,
                        start_at=sc.scrape_period_s, until=end)
        self.loop.every(sc.reconcile_period_s, self._pump,
                        start_at=0.0, until=end)
        if sc.train_workers > 0:
            self.loop.every(sc.train_obs_period_s, self._train_emit,
                            start_at=sc.train_obs_period_s, until=end)
            self.loop.every(sc.train_scale_period_s, self._train_tick,
                            start_at=sc.train_scale_period_s, until=end)
        if self.broker is not None:
            self.loop.every(sc.broker_period_s, self._broker_tick,
                            start_at=sc.broker_period_s, until=end)
        for at_s, note in sc.preempt_times():
            self.loop.at(at_s, lambda n=note: self._preempt(n))

    # ----------------------------------------------------- event handlers
    def _tick_arrivals(self) -> None:
        i = self._tick_no
        self._tick_no += 1
        tr = self.trace
        now = self.clock.t
        for j in tr.rows_for_tick(i):
            req = SimRequest(j, tr.tenant_names[tr.tenant[j]],
                             tr.prompt_len[j], tr.new_tokens[j], now,
                             model=tr.model_of(j))
            self._submitted += 1
            if not self.fleet.submit(req):
                self.rejected += 1

    def _pump(self) -> None:
        """One reconcile round: drain every controller queue (items due
        on the virtual clock), let the kubelet run pending pods, drain
        again — the `run_world` cadence of the controller tests, as a
        scheduled event. Pods only ever appear from a reconcile, so an
        idle round (no reconciles ran) has nothing for the kubelet and
        skips the pod list walk entirely."""
        if self.manager.run_until_idle():
            self.kubelet.run_all(SERVICE_NS)
            self.manager.run_until_idle()

    def _autoscale_tick(self) -> None:
        self.autoscaler.run_once()
        self._peak_replicas = max(self._peak_replicas, self.fleet.size)
        lines = self.autoscaler.slo_event_lines().get(self._svc_key, [])
        onsets = page_onsets(lines)
        if len(onsets) > self._onsets_seen:
            for _ in onsets[self._onsets_seen:]:
                self.pages.append({
                    "t": round(self.clock.t, 6),
                    "slo": "ttft",
                    "step": self.loop.events_processed,
                    "exemplars": self._breach_exemplars(),
                })
            self._onsets_seen = len(onsets)

    def _breach_exemplars(self) -> List[List[Any]]:
        """The page's join key: retained breaching (ttft, trace_id)
        exemplars at the moment the budget blew, merged across replicas
        in name order (deterministic), newest 8. Only sampled-in traces
        ever reach the exemplar deques, so every citation resolves."""
        target = self.scenario.slo_ttft_s
        merged: List[List[Any]] = []
        for name in sorted(self.fleet.replicas):
            rep = self.fleet.replicas[name]
            for v, tid in rep.metrics.exemplars[
                    "time_to_first_token_seconds"]:
                if v > target and isinstance(tid, int):
                    merged.append([round(v, 6), tid])
        return merged[-8:]

    def _train_emit(self) -> None:
        """The virtual training job's worker-0 heartbeat: 5 parseable
        ``[elastic-metrics]`` lines per observation window, latency read
        from the scenario's plan for the CURRENT worker count — the
        script that drives grow → grow → regress-and-freeze."""
        job = self.cluster.get(TorchJob, SERVICE_NS, TRAIN_JOB)
        if job is None:
            return
        workers = job.spec.tasks[TaskType.WORKER].num_tasks
        latency = dict(self.scenario.train_latency_plan).get(workers, 1.0)
        name = f"{TRAIN_JOB}-worker-0"
        for _ in range(5):
            self._train_batch += 1
            self.kubelet.log_line(
                SERVICE_NS, name,
                f"[elastic-metrics] epoch=1 batch={self._train_batch} "
                f"latency={latency} accuracy=0.9")

    def _train_tick(self) -> None:
        if self._train_frozen:
            return   # regressed-and-frozen holds for good; stop ticking
        self.train_scaler.run_once()
        job = self.cluster.get(TorchJob, SERVICE_NS, TRAIN_JOB)
        if job is not None:
            es = job.status.elastic_statuses.get(TaskType.WORKER)
            if es is not None and es.continue_scaling is False:
                self._train_frozen = True

    def _broker_tick(self) -> None:
        """One market clearing + one batch-lane pump on the virtual
        clock. The pump runs AFTER the clearing so a harvest lands
        before the lane admits more backlog into the doomed slots —
        the within-one-tick yield the lane promises."""
        self.broker.run_once()
        if self.batch_lane is not None:
            self.batch_lane.step()

    def _preempt(self, note: str) -> None:
        """Device-layer chaos: kill the newest live replica. No
        production chaos site covers the twin's own device layer, so
        this logs through the twin (and the span substrate) rather than
        inventing a `SITE_REGISTRY` row."""
        live = sorted(n for n, r in self.fleet.replicas.items()
                      if r.state.value != "draining")
        if not live:
            return
        name = live[-1]
        replayed = self.fleet.preempt_replica(name)
        self.preempt_log.append(
            f"t={self.clock.t:.6f} replica={name} replayed={replayed} "
            f"note={note}")
        sp = self.tracer.start("chaos.preempt", at=self.clock.t,
                               replica=name, replayed=replayed,
                               note=note)
        sp.finish(at=self.clock.t)

    # ------------------------------------------------------- span minting
    def _mint(self, req: SimRequest) -> Optional[int]:
        """Mint one request's finished span tree at its completion event
        (every boundary backdated from the timeline the device layer
        already computed — shared floats, so `trace_report`'s residual
        check reads exactly 0). Returns the trace id to cite as the
        TTFT exemplar, or None when the sampling knob shed the trace —
        metrics must never cite a span the dump will not contain."""
        if req.model:
            # per-model accounting rides every completion (sampled or
            # not): the CRD-plane SLO engines and the density summary
            # must see the full population, not the retained traces
            self.model_served[req.model] = \
                self.model_served.get(req.model, 0) + 1
            self.autoscaler.observe_model_latency(
                SERVICE_NS, SERVICE_NAME, req.model, "ttft", req.ttft)
            if req.ttft > self.scenario.model_slo_ttft_s > 0:
                self._model_breaches[req.model] = \
                    self._model_breaches.get(req.model, 0) + 1
        t = self.tracer
        root = t.start("request", at=req.submit_t, rid=req.rid,
                       tenant=req.tenant)
        if req.ttft > self.scenario.slo_ttft_s or req.replays \
                or self._chaos_adjacent(req.submit_t):
            t.keep(root)
        elif not t.is_sampled(root.trace_id):
            # shed trace: don't build children the collector will only
            # throw away — at a million requests the phase spans of
            # unsampled traces are the single largest avoidable cost
            root.finish(at=req.finish_t)
            return None
        t.start("queue", parent=root,
                at=req.submit_t).finish(at=req.dispatch_t)
        t.start("prefill", parent=root, at=req.dispatch_t,
                replica=req.replica).finish(at=req.prefill_end_t)
        d = t.start("decode", parent=root, at=req.prefill_end_t,
                    replica=req.replica)
        d.event("first_token", at=req.first_token_t)
        d.finish(at=req.finish_t)
        if req.replays:
            root.set(replays=req.replays)
        root.finish(at=req.finish_t)
        return root.trace_id if t.is_sampled(root.trace_id) else None

    def _chaos_adjacent(self, t: float) -> bool:
        for lo, hi in self._keep_windows:
            if lo <= t <= hi:
                return True
        return False

    # --------------------------------------------------------------- run
    def run(self) -> Dict[str, Any]:
        """Execute the scenario: chaos installed, recurring loops until
        ``duration_s``, then drain the in-flight tail (completions and
        compile-ready events past the horizon). Returns the
        deterministic summary; wall-clock numbers live in `self.perf`
        (separate, so byte-compares never see them)."""
        sc = self.scenario
        w0 = self.wall_clock() if self.wall_clock is not None else None
        self.chaos_events: List[str] = []
        inj = chaos.FaultInjector(sc.fault_rules(), seed=sc.seed,
                                  name=f"twin-{sc.name}")
        with inj:
            self.loop.run(until=sc.duration_s)
            self.loop.run()        # drain: completions, compiles, pumps
            self._pump()           # final reconcile convergence
            self.chaos_events = list(inj.events)
        self.sim_metrics.inc("events_processed",
                             self.loop.events_processed)
        self.sim_metrics.inc("requests_simulated", self._submitted)
        self.sim_metrics.set_gauge("virtual_seconds_simulated",
                                   self.clock.t)
        self.perf: Dict[str, Any] = {}
        if w0 is not None:
            wall = max(self.wall_clock() - w0, 1e-9)
            self.sim_metrics.set_gauge("wall_seconds", wall)
            self.sim_metrics.set_gauge("speedup", self.clock.t / wall)
            self.perf = {"wall_s": round(wall, 3),
                         "speedup": round(self.clock.t / wall, 1)}
        self.summary = self._summarize()
        return self.summary

    def _summarize(self) -> Dict[str, Any]:
        svc = self.cluster.get(InferenceService, SERVICE_NS, SERVICE_NAME)
        out: Dict[str, Any] = {
            "metric": "twin",
            "scenario": self.scenario.name,
            "seed": self.scenario.seed,
            "virtual_s": round(self.clock.t, 6),
            "events": self.loop.events_processed,
            "requests": self._submitted,
            "served": self.fleet.served,
            "rejected": self.rejected,
            "replayed": self.fleet.replayed,
            "preemptions": self.fleet.stats["preemptions"],
            "scale_ups": self.fleet.stats["scale_ups"],
            "scale_downs": self.fleet.stats["scale_downs"],
            "final_replicas": self.fleet.size,
            "final_spec_replicas": svc.spec.replicas,
            "pages": len(self.pages),
            "budget_transitions": len(
                self.autoscaler.slo_event_lines().get(self._svc_key, [])),
            "chaos_events": len(self.chaos_events),
            "preempt_log": list(self.preempt_log),
            "ledger_records": len(self.ledger.records),
            "spans": len(self.tracer.spans),
            "spans_sampled_out": self.tracer.sampled_out,
            "spans_dropped": self.tracer.dropped,
        }
        if self.scenario.train_workers > 0:
            job = self.cluster.get(TorchJob, SERVICE_NS, TRAIN_JOB)
            out["train_final_workers"] = (
                job.spec.tasks[TaskType.WORKER].num_tasks
                if job is not None else 0)
            out["train_frozen"] = self._train_frozen
        if self.broker is not None:
            out["broker_ticks"] = self.broker.tick_count()
            out["broker_decisions"] = len(self.broker.decision_lines())
        if self.batch_lane is not None:
            out["batch"] = self.batch_lane.snapshot()
            out["batch_intact"] = self.batch_lane.intact()
        if self.scenario.n_models > 0:
            out["models"] = self._model_summary(svc)
        return out

    def _model_summary(self, svc) -> Dict[str, Any]:
        """The density verdict: swap churn, per-model SLO final states
        off the CRD plane, and the chip-cost comparison against the
        one-replica-per-model control arm (the deployment shape the
        model pool exists to beat). ``chips`` prices the fleet's
        actual peak; ``control_arm_chips`` prices a dedicated
        ``REPLICA_TOPOLOGY`` slice per catalog model."""
        sc = self.scenario
        chips_per_replica = chips_in_topology(REPLICA_TOPOLOGY)
        slo_states: Dict[str, str] = {}
        if svc is not None:
            for mname, mst in sorted(svc.status.models.items()):
                for oname, ost in sorted(mst.slo.items()):
                    slo_states[f"{mname}/{oname}"] = ost.state
        exhausted = sorted(k for k, s in slo_states.items()
                           if s == "exhausted")
        top = sorted(self.model_served.items(),
                     key=lambda kv: (-kv[1], kv[0]))[:5]
        return {
            "catalog": sc.n_models,
            "served_models": len(self.model_served),
            "swaps": self.fleet.stats["model_swaps"],
            "loads": self.fleet.stats["model_loads"],
            "evictions": self.fleet.stats["model_evictions"],
            "top_served": [[m, n] for m, n in top],
            "slo_engines": len(slo_states),
            "slo_exhausted": exhausted,
            "breaches": sum(self._model_breaches.values()),
            "peak_replicas": self._peak_replicas,
            "chips": self._peak_replicas * chips_per_replica,
            "control_arm_chips": sc.n_models * chips_per_replica,
        }

    # ------------------------------------------------------------- output
    def write(self, outdir: str) -> Dict[str, str]:
        """Emit the artifact set the production reports consume:
        span dump, decision ledger (with the sibling logs `why_report`
        joins against embedded), SLO budget dump, and the deterministic
        summary. Returns the path map."""
        import os
        os.makedirs(outdir, exist_ok=True)
        paths = {k: os.path.join(outdir, v) for k, v in (
            ("trace", TRACE_FILE), ("ledger", LEDGER_FILE),
            ("slo", SLO_FILE), ("summary", SUMMARY_FILE))}
        self.tracer.dump(paths["trace"])
        extra: Dict[str, Any] = {
            "slo_event_log": self.autoscaler.slo_event_lines()}
        if self.chaos_events:
            extra["chaos_events"] = self.chaos_events
        if self.broker is not None:
            extra["broker_decision_log"] = self.broker.decision_lines()
        self.ledger.dump(paths["ledger"], extra=extra)
        svc = self.cluster.get(InferenceService, SERVICE_NS, SERVICE_NAME)
        slo_status = svc.status.slo or {}
        slo_doc = {
            "format": SLO_FORMAT,
            "seed": self.scenario.seed,
            "slo_target_ttft_s": self.scenario.slo_ttft_s,
            "event_log": list(
                self.autoscaler.slo_event_lines().get(self._svc_key, [])),
            "pages": self.pages,
            "final_state": {name: st.state
                            for name, st in sorted(slo_status.items())},
            "budget_remaining": {
                name: round(st.budget_remaining, 6)
                for name, st in sorted(slo_status.items())},
            # relative to the dump's own directory (slo_report resolves
            # it there), so two outdirs' slo.json byte-compare
            "trace_file": TRACE_FILE,
        }
        with open(paths["slo"], "w") as f:
            json.dump(slo_doc, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        with open(paths["summary"], "w") as f:
            json.dump(self.summary, f, sort_keys=True, indent=1)
            f.write("\n")
        return paths


def run_twin(scenario: Scenario, outdir: Optional[str] = None, *,
             wall_clock: Optional[Callable[[], float]] = None
             ) -> Dict[str, Any]:
    """Run one scenario end to end. With ``outdir`` the artifact set is
    written there and the summary gains the path map under ``"out"``."""
    twin = DigitalTwin(scenario, wall_clock=wall_clock)
    summary = twin.run()
    if outdir is not None:
        summary = dict(summary, out=twin.write(outdir))
        twin.summary = summary
    if twin.perf:
        summary = dict(summary, perf=twin.perf)
    return summary
