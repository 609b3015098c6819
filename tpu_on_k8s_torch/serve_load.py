"""Deterministic closed-loop load driver for the serving gateway and fleet
(the port's counterpart of the reference's ``tools/serve_load.py``).

Drives ``serve.ServingGateway`` — or, with ``--replicas N``, a routed
``serve.ServingFleet`` — with seeded Poisson arrivals and mixed
prompt/output lengths: the same workload every run for a given seed, so a
test can assert on it and the card can measure TTFT/TPOT on a
reproducible trace (``chip_smoke.py``'s load phase runs ``--bench`` and
``--bench --disagg --trace-out``). The virtual-clock modes
(``--autoscale``, ``--slo``, ``--spec``, ``--paged``, ``--disagg``,
``--shard``) give the reference's summaries, event logs, ledgers and
trace dumps for the same flags and weights.

Closed loop: the driver submits each arrival at its assigned engine step,
steps the gateway, and collects outcomes until every request is terminal.
Arrival *steps* (not wall-clock) keep the trace independent of host
speed.

Usage::

    python -m tpu_on_k8s_torch.serve_load --device cpu   # tiny config
    python -m tpu_on_k8s_torch.serve_load --bench --n-slots 8   # the card
    python -m tpu_on_k8s_torch.serve_load --device cpu --replicas 2 \
        --soak --crash-replica 1 --crash-step 5
    torchrun --nproc-per-node 4 -m tpu_on_k8s_torch.serve_load \
        --device cpu --shard --soak                     # meshes 1/2/4

Prints one JSON summary line (throughput, outcome counts, TTFT/TPOT
percentiles; fleet mode adds a per-replica TTFT/queue-wait breakdown).
``--soak`` additionally asserts the mode's zero-silent-loss accounting
(and, in the virtual-clock modes, a byte-identical replay) and prints
``<MODE>_SOAK_FAILED seed=N`` on any violation (exit 1) so a red run is
replayable verbatim. Every engine runs on ``--device``: ``cuda`` (the
default, which raises without a card) or ``cpu`` when asked. The weights
are random from a fixed torch seed (``--seed`` seeds the traffic only):
the tiny config in fp32, or ``bench_config`` in bf16 under ``--bench``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.serve.kvstore import PAGE_TOKENS
# The seeded generator lives in the sim package (the digital twin shares
# it); re-exported here so every import site and seeded trace replays
# unchanged, byte for byte.
from tpu_on_k8s_torch.sim.traffic import Arrival, build_workload  # noqa: F401


def _make_tracer(args, clock):
    """Span substrate for ``--trace-out`` (`obs/trace.py`):
    counter-derived ids + THIS driver's clock, so virtual-clock modes
    produce byte-identical dumps across seeded replays (the property the
    disaggregated trace's acceptance test asserts). None (tracing off)
    keeps every mode bit-for-bit on its pre-tracing behavior."""
    if not args.trace_out:
        return None
    from tpu_on_k8s_torch.obs import Tracer
    return Tracer(clock)


def _dump_trace(tracer, args, summary) -> None:
    """Write the canonical dump and fold the TTFT critical-path segment
    breakdown (`obs/trace_report.py`) into the summary — the shape
    ``chip_smoke.py``'s load phase prints."""
    if tracer is None:
        return
    from tpu_on_k8s_torch.obs.trace_report import SEGMENTS, build_report
    tracer.dump(args.trace_out)
    report = build_report(tracer.export(), top=1)
    summary["trace_out"] = args.trace_out
    summary["trace_spans"] = report["spans"]
    summary["ttft_critical_path"] = {
        "decomposed": report["decomposed"],
        "no_token": report["no_token"],
        "ttft_ms_p50": report["ttft_ms_p50"],
        "ttft_ms_p95": report["ttft_ms_p95"],
        "residual_ms_max": report["residual_ms_max"],
        "segments": {n: {k: report["segments"][n][k]
                         for k in ("p50_ms", "p95_ms", "share")}
                     for n in SEGMENTS},
    }


def _pctl(values, q: float) -> Optional[float]:
    """Empirical percentile (nearest-rank) in milliseconds."""
    vals = sorted(values)
    if not vals:
        return None
    idx = min(len(vals) - 1, max(0, math.ceil(q * len(vals)) - 1))
    return round(vals[idx] * 1e3, 2)


def run_load(gateway, arrivals: List[Arrival],
             time_fn=time.perf_counter) -> dict:
    """Drive the trace to completion; returns the summary dict. Outcome
    counts come from gateway results; latency percentiles from the
    gateway's ``ServingMetrics`` (None when the gateway has no metrics)."""
    from tpu_on_k8s_torch.serve.admission import Rejected

    by_step: dict = {}
    for a in arrivals:
        by_step.setdefault(a.step, []).append(a)
    outcomes: dict = {}
    rejected = 0
    t0 = time_fn()
    step = 0
    live = True
    while by_step or live:
        for a in by_step.pop(step, []):
            r = gateway.submit(a.prompt, a.max_new_tokens, tenant=a.tenant,
                               priority=a.priority, deadline_s=a.deadline_s)
            if isinstance(r, Rejected):
                rejected += 1
        for rid in gateway.step():
            res = gateway.result(rid)
            if res is not None:
                outcomes[rid] = res
        live = gateway.queue_depth > 0 or gateway._live()
        step += 1
    dt = time_fn() - t0
    states = [r.state.value for r in outcomes.values()]
    total_tokens = sum(len(r.tokens) for r in outcomes.values())
    m = gateway.metrics
    summary = {
        "metric": "gateway_load_tokens_per_sec",
        "value": round(total_tokens / dt, 1) if dt > 0 else None,
        "unit": "tokens/s",
        "requests": len(arrivals),
        "served": states.count("done"),
        "rejected": rejected,
        "deadline_exceeded": states.count("deadline_exceeded"),
        "cancelled": states.count("cancelled"),
        "tokens": total_tokens,
        "driver_steps": step,
        "wall_s": round(dt, 3),
    }
    if m is not None:
        ttft = list(m.histograms["time_to_first_token_seconds"])
        tpot = list(m.histograms["time_per_output_token_seconds"])
        qw = list(m.histograms["queue_wait_seconds"])
        summary.update(
            ttft_ms_p50=_pctl(ttft, 0.50), ttft_ms_p99=_pctl(ttft, 0.99),
            tpot_ms_p50=_pctl(tpot, 0.50), tpot_ms_p99=_pctl(tpot, 0.99),
            queue_wait_ms_p50=_pctl(qw, 0.50),
            queue_wait_ms_p99=_pctl(qw, 0.99))
    return summary


def run_fleet_load(fleet, arrivals: List[Arrival],
                   time_fn=time.perf_counter) -> dict:
    """Drive the trace through a ``ServingFleet``: same closed loop as
    ``run_load``, plus the per-replica TTFT/queue-wait breakdown (from
    each replica's own ``ServingMetrics``) and the fleet's routing /
    ejection / replay accounting."""
    from tpu_on_k8s_torch.serve.admission import Rejected

    by_step: dict = {}
    for a in arrivals:
        by_step.setdefault(a.step, []).append(a)
    outcomes: dict = {}
    rejected = 0
    t0 = time_fn()
    step = 0
    live = True
    while by_step or live:
        for a in by_step.pop(step, []):
            r = fleet.submit(a.prompt, a.max_new_tokens, tenant=a.tenant,
                             priority=a.priority, deadline_s=a.deadline_s)
            if isinstance(r, Rejected):
                rejected += 1
        for rid in fleet.step():
            res = fleet.result(rid)
            if res is not None:
                outcomes[rid] = res
        live = fleet.queue_depth > 0 or fleet.has_live_requests
        step += 1
    dt = time_fn() - t0
    states = [r.state.value for r in outcomes.values()]
    total_tokens = sum(len(r.tokens) for r in outcomes.values())
    all_ttft: List[float] = []
    all_qw: List[float] = []
    per_replica: dict = {}
    for name, rep in sorted(fleet.replicas.items()):
        m = rep.metrics
        if m is None:
            continue
        ttft = list(m.histograms["time_to_first_token_seconds"])
        qw = list(m.histograms["queue_wait_seconds"])
        all_ttft += ttft
        all_qw += qw
        per_replica[name] = {
            "routed": rep.routed,
            "state": rep.state.value,
            "ttft_ms_p50": _pctl(ttft, 0.50),
            "ttft_ms_p95": _pctl(ttft, 0.95),
            "queue_wait_ms_p50": _pctl(qw, 0.50),
            "queue_wait_ms_p95": _pctl(qw, 0.95),
        }
    return {
        "metric": "fleet_load_tokens_per_sec",
        "value": round(total_tokens / dt, 1) if dt > 0 else None,
        "unit": "tokens/s",
        "replicas": len(fleet.replicas),
        "requests": len(arrivals),
        "served": states.count("done"),
        "rejected": rejected,
        "deadline_exceeded": states.count("deadline_exceeded"),
        "cancelled": states.count("cancelled"),
        "retry_exhausted": states.count("retry_exhausted"),
        "rerouted": fleet.stats["rerouted"],
        "ejected": fleet.stats["ejected"],
        "prefix_hits": fleet.stats["prefix_hits"],
        "prefix_misses": fleet.stats["prefix_misses"],
        "tokens": total_tokens,
        "driver_steps": step,
        "wall_s": round(dt, 3),
        "ttft_ms_p50": _pctl(all_ttft, 0.50),
        "ttft_ms_p95": _pctl(all_ttft, 0.95),
        "queue_wait_ms_p50": _pctl(all_qw, 0.50),
        "queue_wait_ms_p95": _pctl(all_qw, 0.95),
        "per_replica": per_replica,
    }


def _fleet_main(args, cfg, params, max_len) -> dict:
    """``--replicas N`` mode: route the trace through a ServingFleet
    (optionally crashing a replica mid-trace for the soak)."""
    from tpu_on_k8s_torch import chaos
    from tpu_on_k8s_torch.models.decode import _bucket_len
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.serve import (
        AdmissionConfig,
        ProbeConfig,
        Router,
        ServingFleet,
    )

    def factory(name):
        return ContinuousBatchingEngine(cfg, params, n_slots=args.n_slots,
                                        max_len=max_len,
                                        step_horizon=args.horizon,
                                        device=args.device)

    tracer = _make_tracer(args, time.monotonic)
    fleet = ServingFleet(
        factory, args.replicas,
        admission=AdmissionConfig(max_queue_depth=args.queue_bound),
        probe=ProbeConfig(slow_start_steps=1),
        router=Router(prefix_bucket_len=args.prefix_bucket),
        clock=time.monotonic, tracer=tracer)
    rng = np.random.default_rng(args.seed)
    arrivals = build_workload(
        rng, args.n_requests, rate=args.rate,
        prompt_lens=(args.prompt_min, args.prompt_max),
        new_tokens=(args.new_min, args.new_max),
        vocab_size=cfg.vocab_size,
        deadline_s=args.deadline_s or None,
        deadline_fraction=args.deadline_fraction,
        shared_prefixes=args.shared_prefixes,
        shared_prefix_len=args.prefix_bucket if args.shared_prefixes
        else 0,
        shared_fraction=args.shared_fraction)
    # warm every replica off-trace (same guard as the single-gateway
    # path) and earn readiness
    buckets = sorted({_bucket_len(int(a.prompt.size),
                                  next(iter(fleet.replicas.values()))
                                  .engine.max_len)
                      for a in arrivals})
    for rep in fleet.replicas.values():
        for bucket in buckets:
            lp = min(bucket, rep.engine.max_len - 2)
            for _ in range(7):
                rep.gateway.submit(rng.integers(
                    0, cfg.vocab_size, size=lp).astype(np.int32), 2)
            rep.gateway.run()
        if rep.metrics is not None:
            rep.metrics.histograms.clear()
    for _ in range(3):
        fleet.step()
    if tracer is not None:
        tracer.spans.clear()     # warmup is not the measured trace

    inj = None
    if args.crash_replica >= 0:
        inj = chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_FLEET_REPLICA,
            chaos.Trigger(at=(args.crash_step,),
                          match={"replica": f"replica-{args.crash_replica}"}),
            chaos.ReplicaCrash(),
            note=f"soak: crash replica-{args.crash_replica}")],
            seed=args.seed, name="fleet-soak")
        chaos.install(inj)
    try:
        summary = run_fleet_load(fleet, arrivals)
    finally:
        if inj is not None:
            chaos.uninstall(inj)
    _dump_trace(tracer, args, summary)
    if args.soak:
        accounted = (summary["served"] + summary["rejected"]
                     + summary["deadline_exceeded"] + summary["cancelled"]
                     + summary["retry_exhausted"])
        ok = accounted == args.n_requests
        if args.crash_replica >= 0:
            ok = ok and summary["ejected"] >= 1
        summary["soak_ok"] = ok
        if not ok:
            print(json.dumps(summary))
            print(f"FLEET_SOAK_FAILED seed={args.seed} "
                  f"accounted={accounted}/{args.n_requests}")
            raise SystemExit(1)
        print(f"FLEET_SOAK_OK seed={args.seed}", file=sys.stderr)
    print(json.dumps(summary))
    return summary


class _VirtualClock:
    """Deterministic fleet time: one fixed increment per driver step.
    TTFT/queue-wait/cooldowns all derive from it, so the autoscaler's
    decision log is a pure function of (seed, flags) — byte-identical
    across runs, which is the property ``--autoscale --soak`` asserts."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def run_autoscale_trace(args, cfg, params, max_len, *,
                        enabled: bool = True,
                        trace: bool = False,
                        ledger_out: str = "") -> dict:
    """One seeded bursty trace through ServingFleet + FleetAutoscaler:
    the closed loop scrapes the fleet, patches the InferenceService's
    ``spec.replicas``, and applies the target back to the fleet. Returns
    the summary (decisions, replica trajectory, TTFT percentiles,
    zero-loss accounting). ``enabled=False`` is the control arm: same
    trace, same virtual clock, autoscaler never ticked — the fleet stays
    at ``min_replicas`` (what "TTFT before autoscaling" means).

    ``--autoscale-slo`` > 0 adds a ``spec.slo`` TTFT objective at that
    target (burn windows scaled to ``--autoscale-slo-window`` virtual
    seconds), so the burst pages the error budget and the page grants
    the scale-up its one cooldown bypass — the seeded SLO-regression
    story ``--ledger-out`` records. ``ledger_out`` attaches a
    `obs/ledger.DecisionLedger` on the SAME virtual clock and dumps it
    (with the SLO budget event log embedded) — byte-identical across
    runs of one seed, and the input `obs/why_report.py` resolves the
    page→decision→patch→recovery chain from."""
    from tpu_on_k8s_torch.api.core import ObjectMeta
    from tpu_on_k8s_torch.api.inference_types import (
        AutoscalePolicy,
        InferenceService,
        InferenceServiceSpec,
        SLOObjective,
        SLOPolicy,
    )
    from tpu_on_k8s_torch.api.types import GPUPolicy
    from tpu_on_k8s_torch.client import InMemoryCluster
    from tpu_on_k8s_torch.controller.config import JobControllerConfig
    from tpu_on_k8s_torch.controller.fleetautoscaler import FleetAutoscaler
    from tpu_on_k8s_torch.metrics import AutoscaleMetrics, LedgerMetrics
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.obs.ledger import DecisionLedger
    from tpu_on_k8s_torch.serve import (
        AdmissionConfig,
        ProbeConfig,
        Rejected,
        Router,
        ServingFleet,
    )

    vclock = _VirtualClock()
    # one tracer for fleet AND autoscaler: request spans and
    # autoscale.tick spans interleave on one virtual-clock timeline
    tracer = _make_tracer(args, vclock) if trace else None
    # the ledger rides the SAME virtual clock: records are a pure
    # function of (seed, flags): two runs' dumps byte-compare
    ledger = (DecisionLedger(vclock, metrics=LedgerMetrics())
              if ledger_out else None)

    def factory(name):
        # the engine's queue/slot timestamps read the SAME virtual clock
        # as the fleet — no wall time anywhere on the trace's timeline
        return ContinuousBatchingEngine(cfg, params, n_slots=args.n_slots,
                                        max_len=max_len,
                                        step_horizon=args.horizon,
                                        clock=vclock, device=args.device)

    fleet = ServingFleet(
        factory, args.min_replicas,
        admission=AdmissionConfig(max_queue_depth=args.queue_bound),
        probe=ProbeConfig(slow_start_steps=1),
        router=Router(prefix_bucket_len=args.prefix_bucket),
        clock=vclock, tracer=tracer)

    slo = None
    if args.autoscale_slo > 0:
        # burn windows scaled to the virtual trace, like the --slo mode:
        # the fast-short window must still cover a few driver steps or
        # it empties between arrivals and reads as no-data
        w = args.autoscale_slo_window
        slo = SLOPolicy(objectives=[SLOObjective(
            name="ttft", objective="ttft_p95", target=args.autoscale_slo,
            window_s=w, fast_short_s=w / 60, fast_long_s=w / 20,
            slow_short_s=w / 12, slow_long_s=w / 4)])
    cluster = InMemoryCluster()
    cluster.create(InferenceService(
        metadata=ObjectMeta(name="load"),
        spec=InferenceServiceSpec(
            image="inproc", replicas=args.min_replicas,
            gpu_policy=GPUPolicy(accelerator=args.accelerator,
                                 topology="1x4"),
            autoscale=AutoscalePolicy(
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                min_warm=args.min_warm,
                target_ttft_s=args.target_ttft,
                hysteresis=0.1, max_step=args.max_scale_step,
                scale_up_cooldown_s=args.up_cooldown,
                scale_down_cooldown_s=args.down_cooldown,
                flap_guard_s=args.flap_guard),
            slo=slo)))
    autoscaler = FleetAutoscaler(
        cluster,
        config=JobControllerConfig(autoscale_window_scrapes=3,
                                   autoscale_stale_scrapes=3),
        metrics=AutoscaleMetrics(), clock=vclock, tracer=tracer,
        ledger=ledger)
    autoscaler.attach_fleet("default", "load", fleet)

    rng = np.random.default_rng(args.seed)
    arrivals = build_workload(
        rng, args.n_requests, rate=args.rate,
        prompt_lens=(args.prompt_min, args.prompt_max),
        new_tokens=(args.new_min, args.new_max),
        vocab_size=cfg.vocab_size,
        burst_start=args.burst_start, burst_len=args.burst_len,
        burst_rate=args.burst_rate)

    by_step: dict = {}
    for a in arrivals:
        by_step.setdefault(a.step, []).append(a)
    first_token_t: dict = {}
    submit_t: dict = {}
    outcomes: dict = {}
    rejected = 0
    trajectory = []      # (driver step, active replicas) at each change
    first_up_step = None
    first_up_t = None    # virtual time the first scale-up executed
    step = 0
    # the idle tail is where scale-down is observed; the control arm has
    # nothing to scale down and drains straight to exit
    tail = max(int(args.tail_steps), 0) if enabled else 0

    def active_count():
        return sum(r.state.value in ("starting", "ready")
                   for r in fleet.replicas.values())

    def on_token(rid, _tok):
        if rid not in first_token_t:
            first_token_t[rid] = vclock.t

    while by_step or fleet.has_live_requests or fleet.queue_depth > 0 \
            or tail > 0:
        for a in by_step.pop(step, []):
            r = fleet.submit(a.prompt, a.max_new_tokens, tenant=a.tenant,
                             priority=a.priority, deadline_s=a.deadline_s,
                             on_token=on_token)
            if isinstance(r, Rejected):
                rejected += 1
            else:
                submit_t[r] = vclock.t
        for rid in fleet.step():
            res = fleet.result(rid)
            if res is not None:
                outcomes[rid] = res
        vclock.advance(args.step_dt)
        if enabled and step % args.autoscale_every == 0:
            ups0 = fleet.stats["scale_ups"]
            autoscaler.run_once()
            if first_up_step is None and fleet.stats["scale_ups"] > ups0:
                first_up_step = step
                first_up_t = vclock.t
        if not trajectory or trajectory[-1][1] != active_count():
            trajectory.append((step, active_count()))
        if not by_step and not fleet.has_live_requests \
                and fleet.queue_depth == 0:
            tail -= 1
        step += 1

    # split by when the first token LANDED, not when the request was
    # submitted: a burst's whole backlog arrives before the scale-up
    # executes, and the scale-up's effect is that queued requests start
    # decoding sooner once the new replicas are ready
    ttft = {rid: first_token_t[rid] - submit_t[rid]
            for rid in first_token_t if rid in submit_t}
    pre = [v for rid, v in ttft.items()
           if first_up_t is None or first_token_t[rid] <= first_up_t]
    post = [v for rid, v in ttft.items()
            if first_up_t is not None and first_token_t[rid] > first_up_t]
    states = [r.state.value for r in outcomes.values()]
    svc = cluster.get(InferenceService, "default", "load")
    summary = {
        "metric": "autoscale_trace",
        "requests": len(arrivals),
        "served": states.count("done"),
        "rejected": rejected,
        "deadline_exceeded": states.count("deadline_exceeded"),
        "cancelled": states.count("cancelled"),
        "retry_exhausted": states.count("retry_exhausted"),
        "driver_steps": step,
        "first_scale_up_step": first_up_step,
        "replica_trajectory": trajectory,
        "final_spec_replicas": svc.spec.replicas,
        "final_active_replicas": active_count(),
        "max_active_replicas": max(n for _, n in trajectory),
        "scale_ups": fleet.stats["scale_ups"],
        "scale_downs": fleet.stats["scale_downs"],
        # virtual-clock TTFT: deterministic, comparable across runs.
        # pre/post split by when the first token landed relative to the
        # first executed scale-up (the burst backlog counts as post: its
        # wait is exactly what the scale-up exists to cut short)
        "ttft_ms_p95": _pctl(list(ttft.values()), 0.95),
        "ttft_ms_p50": _pctl(list(ttft.values()), 0.50),
        "ttft_ms_p95_pre_scale": _pctl(pre, 0.95),
        "ttft_ms_p95_post_scale": _pctl(post, 0.95),
        "decisions": list(autoscaler.decision_log),
    }
    if slo is not None:
        final_slo = cluster.get(InferenceService, "default",
                                "load").status.slo
        summary["slo_final_state"] = {
            name: st.state for name, st in sorted(final_slo.items())}
        summary["slo_event_log"] = [
            line for lines in autoscaler.slo_event_lines().values()
            for line in lines]
    _dump_trace(tracer, args, summary)
    if ledger is not None:
        from tpu_on_k8s_torch import chaos

        # embed the sibling logs why_report joins against: the budget
        # event log (slo_page triggers) and, when a fault schedule is
        # installed, the injector's sequence-stamped events (chaos#N
        # triggers) — the ledger cites both; the dump must carry both
        extra = {"slo_event_log": autoscaler.slo_event_lines()}
        inj = chaos.active()
        if inj is not None and inj.events:
            extra["chaos_events"] = list(inj.events)
        ledger.dump(ledger_out, extra=extra)
        summary["ledger_out"] = ledger_out
        summary["ledger_records"] = len(ledger.records)
        # fold the resolved causal chains in: the shape the chip
        # window's serve_why stage records, and a cheap in-process
        # pre-check of what `obs/why_report.py --check` gates on
        from tpu_on_k8s_torch.obs.why_report import build_report
        doc = {"records": ledger.export(), **extra}
        rep = build_report(
            doc, tracer.export() if tracer is not None else None)
        summary["ledger_committed"] = rep["committed"]
        summary["ledger_page_chains"] = len(rep["pages"])
        summary["ledger_complete_page_chains"] = len(
            rep["complete_page_chains"])
    return summary


def _autoscale_main(args, cfg, params, max_len) -> dict:
    """``--autoscale``: the SLO-driven loop on a bursty trace, plus a
    static control arm (same trace, fleet pinned at ``--min-replicas``)
    so the summary shows TTFT before/after autoscaling on identical
    load. With ``--soak`` the autoscaled trace runs TWICE from scratch
    and the two decision logs must be byte-identical (plus
    zero-silent-loss accounting and an actual scale-up) —
    ``AUTOSCALE_SOAK_FAILED seed=N`` on violation."""
    baseline = run_autoscale_trace(args, cfg, params, max_len,
                                   enabled=False)
    summary = run_autoscale_trace(args, cfg, params, max_len, trace=True,
                                  ledger_out=args.ledger_out)
    summary["ttft_ms_p95_static_baseline"] = baseline["ttft_ms_p95"]
    summary["ttft_ms_p50_static_baseline"] = baseline["ttft_ms_p50"]
    summary["baseline_driver_steps"] = baseline["driver_steps"]
    if args.soak:
        rerun = run_autoscale_trace(args, cfg, params, max_len)
        accounted = (summary["served"] + summary["rejected"]
                     + summary["deadline_exceeded"] + summary["cancelled"]
                     + summary["retry_exhausted"])
        ok = (accounted == args.n_requests
              and summary["scale_ups"] >= 1
              and summary["decisions"] == rerun["decisions"])
        summary["soak_ok"] = ok
        summary["decision_log_replayed"] = (
            summary["decisions"] == rerun["decisions"])
        if not ok:
            print(json.dumps(summary))
            print(f"AUTOSCALE_SOAK_FAILED seed={args.seed} "
                  f"accounted={accounted}/{args.n_requests} "
                  f"scale_ups={summary['scale_ups']} "
                  f"replayed={summary['decision_log_replayed']}")
            raise SystemExit(1)
        print(f"AUTOSCALE_SOAK_OK seed={args.seed}", file=sys.stderr)
    print(json.dumps(summary))
    return summary


def run_slo_trace(args, cfg, params, max_len, *, trace: bool = False) -> dict:
    """One seeded virtual-clock trace through a ``ServingGateway`` with a
    latency regression injected mid-run (step costs multiply by
    ``--slo-regress-factor`` from ``--slo-regress-step`` on), watched by
    TWO detectors over the same requests:

    * the **burn-rate arm** — the error-budget engine
      (`obs/slo.py`): TTFT observations feed sliding windows;
      the fast 5m/1h-shaped window pair pages when both burn ≥ 14.4× the
      budget rate (detection = the first ``page``/``exhausted``
      transition);
    * the **static-threshold control arm** — what a naive alert does:
      p95 over the full trailing window crosses the target, sustained
      ``--slo-static-sustain`` evaluations (the sustain is what keeps a
      naive alert from flapping — and exactly what makes it slow; the
      multi-window burn construction gets its flap-resistance for free).

    The ``ServingAccountant`` rides along: per-tenant good vs degraded
    tokens (served within the TTFT SLO or not) and chip-seconds, folded
    into the summary. Deterministic per seed: the budget event log
    byte-compares across runs (``--soak``), and with ``--trace-out`` the
    page snapshot captures the breaching ``(ttft, trace_id)`` exemplars
    the reference's `tools/slo_report.py` joins back to span trees."""
    from tpu_on_k8s_torch.metrics import ServingMetrics, SLOMetrics
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.obs.account import ServingAccountant
    from tpu_on_k8s_torch.obs.slo import (
        BUDGET_EXHAUSTED,
        BUDGET_PAGE,
        SLOEngine,
        SLOSpec,
    )
    from tpu_on_k8s_torch.serve import (
        AdmissionConfig,
        Rejected,
        ServingGateway,
    )

    vclock = _VirtualClock()
    tracer = _make_tracer(args, vclock) if trace else None
    engine = ContinuousBatchingEngine(cfg, params, n_slots=args.n_slots,
                                      max_len=max_len,
                                      step_horizon=args.horizon,
                                      clock=vclock, device=args.device)
    metrics = ServingMetrics()
    gateway = ServingGateway(
        engine, AdmissionConfig(max_queue_depth=args.queue_bound),
        metrics=metrics, clock=vclock, tracer=tracer)

    target = args.slo_target_ttft
    w = args.slo_window
    slo_metrics = SLOMetrics()
    # burn windows scaled to the virtual trace: the SRE 5m/1h + 6h/3d
    # ratios assume a 30-day window — at trace scale the fast-short
    # window must still cover a few engine steps, or it empties between
    # arrivals and reads as no-data
    windows = dict(fast_short_s=w / 60, fast_long_s=w / 20,
                   slow_short_s=w / 12, slow_long_s=w / 4,
                   stale_after_s=w)
    slo = SLOEngine(
        [SLOSpec(name="ttft", objective="ttft_p95", target=target,
                 window_s=w, **windows),
         SLOSpec(name="availability", objective="availability",
                 target=0.99, window_s=w, **windows)],
        clock=vclock, metrics=slo_metrics)
    acct = ServingAccountant(ttft_slo_s=target, metrics=slo_metrics)

    rng = np.random.default_rng(args.seed)
    arrivals = build_workload(
        rng, args.n_requests, rate=args.rate,
        prompt_lens=(args.prompt_min, args.prompt_max),
        new_tokens=(args.new_min, args.new_max),
        vocab_size=cfg.vocab_size)
    by_step: dict = {}
    for a in arrivals:
        by_step.setdefault(a.step, []).append(a)

    submit_t: dict = {}
    tenant_of: dict = {}
    first_token_t: dict = {}
    outcomes: dict = {}
    rejected = 0
    # static-threshold control arm state: (t, ttft) samples + sustain
    static_samples: List = []
    static_streak = 0
    static_alarm_step = None
    static_alarm_t = None
    page_step = None
    page_t = None
    page_exemplars: List = []
    step = 0
    live = True

    def on_token(rid, _tok):
        if rid in first_token_t:
            return
        first_token_t[rid] = vclock.t
        ttft = vclock.t - submit_t[rid]
        slo.observe_latency("ttft", ttft)
        static_samples.append((vclock.t, ttft))

    while by_step or live:
        for a in by_step.pop(step, []):
            r = gateway.submit(a.prompt, a.max_new_tokens, tenant=a.tenant,
                               priority=a.priority, deadline_s=a.deadline_s,
                               on_token=on_token)
            if isinstance(r, Rejected):
                rejected += 1
                slo.observe_outcome(False)
                acct.observe_request(tenant=a.tenant, state="rejected",
                                     tokens=0)
            else:
                submit_t[r] = vclock.t
                tenant_of[r] = a.tenant
        # the cost model charges a step's device time BEFORE the step
        # retires its tokens: a token produced this step has waited this
        # step's cost, so the injected regression (slower decode steps)
        # shows up in TTFT exactly as a slower device would
        vclock.advance(args.step_dt * (args.slo_regress_factor
                                       if step >= args.slo_regress_step
                                       else 1.0))
        for rid in gateway.step():
            res = gateway.result(rid)
            if res is None:
                continue
            outcomes[rid] = res
            slo.observe_outcome(res.state.value == "done")
            acct.observe_request(
                tenant=tenant_of.get(rid, "default"),
                state=res.state.value, tokens=len(res.tokens),
                ttft=(first_token_t[rid] - submit_t[rid]
                      if rid in first_token_t else None),
                duration_s=vclock.t - submit_t.get(rid, vclock.t))
        if step % args.slo_eval_every == 0:
            statuses = slo.evaluate()
            st = statuses["ttft"]
            if page_step is None and st.state in (BUDGET_PAGE,
                                                  BUDGET_EXHAUSTED):
                page_step, page_t = step, vclock.t
                # the page's join key: the retained breaching exemplars
                # (value, trace_id) at the moment the budget blew —
                # what the reference's `tools/slo_report.py` dereferences
                # to span trees
                page_exemplars = [
                    (v, tid) for v, tid in
                    metrics.exemplars["time_to_first_token_seconds"]
                    if v > target][-8:]
            if static_alarm_step is None:
                recent = [v for t, v in static_samples
                          if vclock.t - t <= w]
                from tpu_on_k8s_torch.autoscale.signals import percentile
                p95 = percentile(recent, 0.95)
                static_streak = (static_streak + 1
                                 if p95 is not None and p95 > target
                                 else 0)
                if static_streak >= args.slo_static_sustain:
                    static_alarm_step, static_alarm_t = step, vclock.t
        live = gateway.queue_depth > 0 or gateway._live()
        step += 1

    states = [r.state.value for r in outcomes.values()]
    final = slo.evaluate()
    summary = {
        "metric": "slo_trace",
        "requests": len(arrivals),
        "served": states.count("done"),
        "rejected": rejected,
        "deadline_exceeded": states.count("deadline_exceeded"),
        "cancelled": states.count("cancelled"),
        "retry_exhausted": states.count("retry_exhausted"),
        "tokens": sum(len(r.tokens) for r in outcomes.values()),
        "driver_steps": step,
        "virtual_s": round(vclock.t, 6),
        "slo_target_ttft_s": target,
        "regress_step": args.slo_regress_step,
        "burn_page_step": page_step,
        "burn_page_t": None if page_t is None else round(page_t, 6),
        "static_alarm_step": static_alarm_step,
        "static_alarm_t": (None if static_alarm_t is None
                           else round(static_alarm_t, 6)),
        "detection_lead_steps": (
            static_alarm_step - page_step
            if page_step is not None and static_alarm_step is not None
            else None),
        "final_state": {name: st.state for name, st in final.items()},
        "budget_remaining": {
            name: round(st.budget_remaining, 6)
            for name, st in final.items()},
        "transitions": len(slo.event_log),
        "accounting": acct.summary(),
        "page_exemplars": [[round(v, 6), tid]
                           for v, tid in page_exemplars],
        "event_log": list(slo.event_log),
    }
    _dump_trace(tracer, args, summary)
    return summary


def _slo_main(args, cfg, params, max_len) -> dict:
    """``--slo``: the burn-rate engine vs the static-threshold control
    on one seeded regression trace. With ``--soak`` the trace runs TWICE
    from scratch and the budget event logs must byte-compare, the
    accounting must balance (every request good/degraded/rejected —
    token conservation), the burn arm must page BEFORE the static arm,
    and (with ``--trace-out``) the page must resolve to ≥1 exemplar
    trace id present in the span dump — ``SLO_SOAK_FAILED seed=N`` on
    any violation so a red run replays verbatim. ``--slo-out`` writes
    the budget timeline + page exemplars for the reference's
    `tools/slo_report.py`."""
    summary = run_slo_trace(args, cfg, params, max_len,
                            trace=bool(args.trace_out))
    event_log = summary["event_log"]
    if args.slo_out:
        doc = {
            "format": "tpu-on-k8s-slo/v1",
            "seed": args.seed,
            "slo_target_ttft_s": summary["slo_target_ttft_s"],
            "event_log": event_log,
            "pages": ([] if summary["burn_page_step"] is None else [{
                "t": summary["burn_page_t"],
                "slo": "ttft",
                "step": summary["burn_page_step"],
                "exemplars": summary["page_exemplars"],
            }]),
            "final_state": summary["final_state"],
            "budget_remaining": summary["budget_remaining"],
            "trace_file": args.trace_out or None,
        }
        with open(args.slo_out, "w") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.write("\n")
        summary["slo_out"] = args.slo_out
    if args.soak:
        rerun = run_slo_trace(args, cfg, params, max_len)
        accounting = summary["accounting"]
        accounted = (summary["served"] + summary["rejected"]
                     + summary["deadline_exceeded"] + summary["cancelled"]
                     + summary["retry_exhausted"])
        tokens_accounted = (accounting["good_tokens"]
                            + accounting["degraded_tokens"])
        replayed = event_log == rerun["event_log"]
        paged = summary["burn_page_step"] is not None
        beat_static = (paged and summary["static_alarm_step"] is not None
                       and summary["burn_page_step"]
                       < summary["static_alarm_step"])
        exemplar_ok = True
        if args.trace_out:
            from tpu_on_k8s_torch.obs.export import load_trace
            trace_ids = {s["trace"] for s in load_trace(args.trace_out)}
            exemplar_ok = any(tid in trace_ids
                              for _, tid in summary["page_exemplars"]
                              if tid is not None)
        ok = (accounted == args.n_requests
              and tokens_accounted == summary["tokens"]
              and replayed and paged and beat_static and exemplar_ok)
        summary["soak_ok"] = ok
        summary["event_log_replayed"] = replayed
        summary["page_resolves_exemplar"] = exemplar_ok
        if not ok:
            print(json.dumps(summary))
            print(f"SLO_SOAK_FAILED seed={args.seed} "
                  f"accounted={accounted}/{args.n_requests} "
                  f"tokens={tokens_accounted}/{summary['tokens']} "
                  f"replayed={replayed} paged={paged} "
                  f"beat_static={beat_static} exemplar={exemplar_ok}")
            raise SystemExit(1)
        print(f"SLO_SOAK_OK seed={args.seed}", file=sys.stderr)
    print(json.dumps(summary))
    return summary


def run_spec_trace(args, cfg, params, max_len, *, spec: bool = True,
                   trace: bool = False) -> dict:
    """One seeded virtual-clock trace through a ``ServingGateway`` whose
    engine decodes speculatively (``spec=True``: batched drafts in the
    continuous-batching engine, `models/serving.py`) or plain
    (the control arm — same arrivals, same engine config, no draft).

    Device time follows an explicit cost model, mirroring the disagg
    trace's: a plain engine step costs ``--step-dt`` virtual seconds; a
    speculative round costs ``step_dt * (1 + (k+1) * draft_frac)`` —
    the target verify reads the weights once like a plain step
    (bandwidth-bound), plus ``k+1`` draft forwards each charged
    ``--spec-draft-frac`` of a target forward. TPOT then measures real
    structure: the spec arm pays a costlier step but emits
    ``1 + acceptance*k`` tokens from it. Deterministic per seed — the
    event log byte-compares across runs (``--soak``; no timestamps in
    the log, so this holds on any clock), and greedy makes the two
    arms' OUTPUT TOKENS identical (the oracle the soak also asserts).

    ``--bench`` swaps the cost model for the WALL clock (with an
    off-trace warmup): on the card that measures the hardware TPOT
    delta, not the modeled one."""
    from tpu_on_k8s_torch.metrics import ServingMetrics, SpecMetrics
    from tpu_on_k8s_torch.models.decode import truncated_draft
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.serve import (
        AdmissionConfig,
        Rejected,
        ServingGateway,
    )

    wall = bool(args.bench)
    vclock = _VirtualClock()
    clock = time.monotonic if wall else vclock
    tracer = _make_tracer(args, clock) if trace else None
    spec_metrics = SpecMetrics() if spec else None
    draft_cfg = draft_params = None
    if spec:
        if args.spec_draft_layers > 0:
            draft_cfg, draft_params = truncated_draft(
                cfg, params, args.spec_draft_layers)
        else:
            # self-draft: the deterministic acceptance=1 upper bound —
            # the cost model still charges every draft forward, so the
            # TPOT comparison stays honest about overhead
            draft_cfg, draft_params = cfg, params
    engine = ContinuousBatchingEngine(
        cfg, params, n_slots=args.n_slots, max_len=max_len, clock=clock,
        draft_cfg=draft_cfg, draft_params=draft_params,
        spec_k=args.spec_k, spec_metrics=spec_metrics, device=args.device)
    metrics = ServingMetrics()
    gateway = ServingGateway(
        engine, AdmissionConfig(max_queue_depth=args.queue_bound),
        metrics=metrics, clock=clock, tracer=tracer)

    rng = np.random.default_rng(args.seed)
    # deadlines thread through like the monolithic gateway mode (the
    # shared-prefix flags stay fleet-only, as documented on their help).
    # NB deadlines make the two arms legitimately divergeable — a slow
    # control arm can expire a request the spec arm completes — so the
    # soak's token-identity gate is meant for deadline-free traces
    # (the default).
    arrivals = build_workload(
        rng, args.n_requests, rate=args.rate,
        prompt_lens=(args.prompt_min, args.prompt_max),
        new_tokens=(args.new_min, args.new_max),
        vocab_size=cfg.vocab_size,
        deadline_s=args.deadline_s or None,
        deadline_fraction=args.deadline_fraction)
    by_step: dict = {}
    for a in arrivals:
        by_step.setdefault(a.step, []).append(a)
    if wall:
        # hardware run: run the prefill/draft/verify paths for every
        # bucket the trace can hit OFF the measured trace (same guard as
        # the monolithic --bench path)
        from tpu_on_k8s_torch.models.decode import _bucket_len
        buckets = sorted({_bucket_len(int(a.prompt.size), engine.max_len)
                          for a in arrivals})
        for bucket in buckets:
            lp = min(bucket, engine.max_len - 2)
            for _ in range(7):
                gateway.submit(rng.integers(
                    0, cfg.vocab_size, size=lp).astype(np.int32), 8)
            gateway.run()
        metrics.histograms.clear()
        for key in ("spec_rounds", "spec_proposed", "spec_accepted",
                    "spec_rollbacks", "spec_draft_s", "spec_verify_s"):
            engine.stats[key] = type(engine.stats[key])()

    # per-step device cost (virtual seconds) under the model above
    step_cost = args.step_dt * (
        1.0 + (args.spec_k + 1) * args.spec_draft_frac) if spec \
        else args.step_dt
    outcomes: dict = {}
    event_log: List[str] = []
    rejected = 0
    step = 0
    live = True
    while by_step or live:
        due = by_step.pop(step, [])
        for a in due:
            r = gateway.submit(a.prompt, a.max_new_tokens, tenant=a.tenant,
                               priority=a.priority, deadline_s=a.deadline_s)
            if isinstance(r, Rejected):
                rejected += 1
        done = gateway.step()
        for rid in done:
            res = gateway.result(rid)
            if res is not None:
                outcomes[rid] = res
        if not wall:
            vclock.advance(step_cost)
        event_log.append(
            f"step={step} arrivals={len(due)} "
            f"finished={','.join(map(str, sorted(done)))} "
            f"emitted={engine.stats['emitted']} "
            f"spec={engine.stats['spec_accepted']}"
            f"/{engine.stats['spec_proposed']}")
        live = gateway.queue_depth > 0 or gateway._live()
        step += 1

    states = [r.state.value for r in outcomes.values()]
    tpot = list(metrics.histograms["time_per_output_token_seconds"])
    ttft = list(metrics.histograms["time_to_first_token_seconds"])
    st = engine.stats
    acceptance = (st["spec_accepted"] / st["spec_proposed"]
                  if st["spec_proposed"] else None)
    summary = {
        "metric": "spec_trace" if spec else "spec_control_trace",
        "requests": len(arrivals),
        "served": states.count("done"),
        "rejected": rejected,
        "deadline_exceeded": states.count("deadline_exceeded"),
        "cancelled": states.count("cancelled"),
        "retry_exhausted": states.count("retry_exhausted"),
        "tokens": sum(len(r.tokens) for r in outcomes.values()),
        "driver_steps": step,
        "clock": "wall" if wall else "cost-model",
        "virtual_s": None if wall else round(vclock.t, 6),
        "spec_draft_s": round(st["spec_draft_s"], 6),
        "spec_verify_s": round(st["spec_verify_s"], 6),
        "tpot_ms_p50": _pctl(tpot, 0.50),
        "tpot_ms_p95": _pctl(tpot, 0.95),
        "ttft_ms_p50": _pctl(ttft, 0.50),
        "ttft_ms_p95": _pctl(ttft, 0.95),
        "spec_rounds": st["spec_rounds"],
        "acceptance_rate": (round(acceptance, 4)
                            if acceptance is not None else None),
        "rollbacks": st["spec_rollbacks"],
        # the modeled share of device time the draft consumes — what the
        # win has to amortize ((k+1) draft forwards per round)
        "draft_overhead_share": round(
            (args.spec_k + 1) * args.spec_draft_frac
            / (1.0 + (args.spec_k + 1) * args.spec_draft_frac), 4)
        if spec else 0.0,
        "outputs": {rid: tuple(int(t) for t in r.tokens)
                    for rid, r in sorted(outcomes.items())},
        "event_log": event_log,
    }
    _dump_trace(tracer, args, summary)
    return summary


def _spec_main(args, cfg, params, max_len) -> dict:
    """``--spec``: speculative vs plain decode on the same seeded
    cost-model trace. With ``--soak`` the spec arm runs TWICE from
    scratch and the event logs must byte-compare, the outputs must be
    token-identical to the plain arm (the greedy oracle), acceptance
    must reach 0.7, and spec must win TPOT p95 —
    ``SPEC_SOAK_FAILED seed=N`` on any violation so a red run replays
    verbatim."""
    control = run_spec_trace(args, cfg, params, max_len, spec=False)
    summary = run_spec_trace(args, cfg, params, max_len,
                             trace=bool(args.trace_out))
    event_log = summary.pop("event_log")
    outputs = summary.pop("outputs")
    control_outputs = control.pop("outputs")
    summary["control"] = {k: control[k] for k in
                          ("tpot_ms_p50", "tpot_ms_p95", "ttft_ms_p95",
                           "served", "driver_steps", "virtual_s")}
    summary["token_identical"] = outputs == control_outputs
    summary["tpot_p95_win"] = (
        summary["tpot_ms_p95"] is not None
        and control["tpot_ms_p95"] is not None
        and summary["tpot_ms_p95"] < control["tpot_ms_p95"])
    if args.soak:
        rerun = run_spec_trace(args, cfg, params, max_len)
        accounted = (summary["served"] + summary["rejected"]
                     + summary["deadline_exceeded"] + summary["cancelled"]
                     + summary["retry_exhausted"])
        replayed = event_log == rerun["event_log"]
        acceptance_ok = (summary["acceptance_rate"] is not None
                         and summary["acceptance_rate"] >= 0.7)
        ok = (accounted == args.n_requests and replayed
              and summary["token_identical"] and acceptance_ok
              and summary["tpot_p95_win"])
        summary["soak_ok"] = ok
        summary["event_log_replayed"] = replayed
        if not ok:
            print(json.dumps(summary))
            print(f"SPEC_SOAK_FAILED seed={args.seed} "
                  f"accounted={accounted}/{args.n_requests} "
                  f"replayed={replayed} "
                  f"token_identical={summary['token_identical']} "
                  f"acceptance={summary['acceptance_rate']} "
                  f"tpot_win={summary['tpot_p95_win']}")
            raise SystemExit(1)
        print(f"SPEC_SOAK_OK seed={args.seed}", file=sys.stderr)
    print(json.dumps(summary))
    return summary


def run_paged_trace(args, cfg, params, max_len, *, paged=True) -> dict:
    """One seeded burst trace through a single engine, paged
    (``kv_pages``: the paged KV pool + shared-prefix page aliasing in
    `models/serving.py`) or dense (the control arm — the SAME
    KV memory spent as whole-sequence slots: ``budget_tokens //
    max_len`` of them). Every request extends one of
    ``--shared-prefixes`` fixed prefixes; the paged arm registers them
    once and submits suffixes, the dense arm submits the full prompt —
    exactly the recompute/copy the page pool exists to delete.

    All requests arrive at step 0 (a burst): peak concurrency then
    measures how many requests each arm can hold LIVE inside the same
    byte budget, which is the paper's memory-proportional-to-live-tokens
    claim made operational. The headline numbers — peak concurrency,
    ``prefill_positions`` (recompute) and ``admit_copy_positions``
    (copy) — are counters, not clock readings, so the comparison is
    identical on the cost-model and ``--bench`` wall clocks and the
    event log byte-compares across runs per seed (``--soak``)."""
    from tpu_on_k8s_torch.metrics import PagedKVMetrics
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine

    vclock = _VirtualClock()
    page = args.paged_page_tokens
    eff_len = max_len if max_len else cfg.max_seq_len
    budget_tokens = args.paged_pool_pages * page
    rng = np.random.default_rng(args.seed)
    prefixes = [rng.integers(0, cfg.vocab_size,
                             size=args.paged_prefix_len).astype(np.int32)
                for _ in range(args.shared_prefixes)]
    # suffix + new stay inside ONE page past the shared prefix (the
    # live-token working set the pool charges each request for)
    reqs = []
    for _ in range(args.n_requests):
        pj = int(rng.integers(0, len(prefixes)))
        suffix = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(2, 4))).astype(np.int32)
        reqs.append((pj, suffix, int(rng.integers(4, 6))))

    kv_metrics = PagedKVMetrics() if paged else None
    if paged:
        engine = ContinuousBatchingEngine(
            cfg, params, n_slots=args.paged_slots, max_len=max_len,
            queue_cap=args.n_requests + 8, step_horizon=args.horizon,
            clock=vclock, kv_pages=args.paged_pool_pages, page_tokens=page,
            kv_metrics=kv_metrics, device=args.device)
        pids = [engine.register_prefix(p) for p in prefixes]
    else:
        engine = ContinuousBatchingEngine(
            cfg, params, n_slots=max(1, budget_tokens // eff_len),
            max_len=max_len, queue_cap=args.n_requests + 8,
            step_horizon=args.horizon, clock=vclock, device=args.device)

    ids = []
    for pj, suffix, new in reqs:
        if paged:
            ids.append(engine.submit(suffix, new, prefix_id=pids[pj]))
        else:
            ids.append(engine.submit(
                np.concatenate([prefixes[pj], suffix]), new))

    peak = 0
    event_log: List[str] = []
    step = 0
    wall_t0 = time.monotonic()
    while (engine._queue or engine._kv_queue
           or engine._prefilling is not None
           or any(s is not None for s in engine._slots)):
        engine.step()
        active = sum(s is not None for s in engine._slots)
        peak = max(peak, active)
        vclock.advance(args.step_dt)
        st = engine.stats
        event_log.append(
            f"step={step} active={active} emitted={st['emitted']} "
            f"admitted={st['admitted']} stalls={st['admission_stalls']} "
            f"pages={st['pages_allocated']}+{st['pages_aliased']}")
        step += 1
    wall_s = time.monotonic() - wall_t0
    finished = engine.run()          # queue drained: collects results

    st = engine.stats
    summary = {
        "metric": "paged_trace" if paged else "paged_control_trace",
        "requests": len(reqs),
        "served": len(finished),
        "slots": engine.n_slots,
        "pool_pages": args.paged_pool_pages if paged else 0,
        "page_tokens": page if paged else eff_len,
        "budget_tokens": budget_tokens,
        "kv_slot_bytes": int(engine.kv_bytes_per_chip),
        "peak_concurrency": peak,
        "driver_steps": step,
        "virtual_s": round(vclock.t, 6),
        "wall_s": round(wall_s, 3),
        "recompute_positions": st["prefill_positions"],
        "copy_positions": st["admit_copy_positions"],
        "pages_allocated": st["pages_allocated"],
        "pages_aliased": st["pages_aliased"],
        "admission_stalls": st["admission_stalls"],
        "outputs": {j: tuple(int(t) for t in finished[rid])
                    for j, rid in enumerate(ids) if rid in finished},
        "event_log": event_log,
    }
    return summary


def _paged_main(args, cfg, params, max_len) -> dict:
    """``--paged``: the paged engine vs a dense control holding the same
    KV byte budget, on the same seeded shared-prefix burst. With
    ``--soak`` the paged arm runs TWICE from scratch and the event logs
    must byte-compare, outputs must be token-identical to the dense arm
    (the greedy oracle), peak concurrency must reach 4x the control's,
    and recompute + copy positions must be strictly below it —
    ``PAGED_SOAK_FAILED seed=N`` on any violation so a red run replays
    verbatim."""
    control = run_paged_trace(args, cfg, params, max_len, paged=False)
    summary = run_paged_trace(args, cfg, params, max_len)
    event_log = summary.pop("event_log")
    outputs = summary.pop("outputs")
    control_outputs = control.pop("outputs")
    control.pop("event_log")
    summary["control"] = {k: control[k] for k in
                          ("slots", "kv_slot_bytes", "peak_concurrency",
                           "driver_steps", "recompute_positions",
                           "copy_positions")}
    summary["token_identical"] = outputs == control_outputs
    summary["concurrency_ratio"] = round(
        summary["peak_concurrency"]
        / max(control["peak_concurrency"], 1), 2)
    summary["recompute_down"] = (summary["recompute_positions"]
                                 < control["recompute_positions"])
    summary["copy_down"] = (summary["copy_positions"]
                            < control["copy_positions"])
    if args.soak:
        rerun = run_paged_trace(args, cfg, params, max_len)
        replayed = event_log == rerun["event_log"]
        ok = (summary["served"] == args.n_requests and replayed
              and summary["token_identical"]
              and summary["concurrency_ratio"] >= 4.0
              and summary["recompute_down"] and summary["copy_down"])
        summary["soak_ok"] = ok
        summary["event_log_replayed"] = replayed
        if not ok:
            print(json.dumps(summary))
            print(f"PAGED_SOAK_FAILED seed={args.seed} "
                  f"served={summary['served']}/{args.n_requests} "
                  f"replayed={replayed} "
                  f"token_identical={summary['token_identical']} "
                  f"concurrency_ratio={summary['concurrency_ratio']} "
                  f"recompute_down={summary['recompute_down']} "
                  f"copy_down={summary['copy_down']}")
            raise SystemExit(1)
        print(f"PAGED_SOAK_OK seed={args.seed}", file=sys.stderr)
    print(json.dumps(summary))
    return summary


#: explicit device-time cost model for the disagg comparison: an
#: engine's step costs BASE plus PREFILL_COST per padded prefill
#: position it executed that step — a monolithic engine's co-resident
#: prefills inflate its decode token intervals; a dedicated decode
#: engine's never do. Units are abstract "device steps", so the
#: comparison is deterministic and host-speed-independent.
_DISAGG_STEP_BASE = 1.0
_DISAGG_PREFILL_COST = 0.05


def run_disagg_trace(args, cfg, params, max_len, *,
                     disagg: bool = True, trace: bool = False) -> dict:
    """One seeded shared-prefix bursty trace through a ``DisaggFleet``
    (or, with ``disagg=False``, the monolithic ``ServingFleet`` control
    arm with the same engine count) on a virtual clock. Returns outcome
    accounting, the cost-model decode TPOT percentiles, the fleet-wide
    prefix-prefill recomputation count, per-pool TTFT/TPOT breakdowns,
    and (disagg) the byte-comparable event log."""
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.serve import (
        DisaggFleet,
        ProbeConfig,
        Rejected,
        Router,
        ServingFleet,
    )

    vclock = _VirtualClock()
    tracer = _make_tracer(args, vclock) if trace else None

    def factory(name):
        # engine timestamps ride the trace's virtual clock (see
        # _autoscale factory note)
        return ContinuousBatchingEngine(cfg, params, n_slots=args.n_slots,
                                        max_len=max_len,
                                        step_horizon=args.horizon,
                                        clock=vclock, device=args.device)

    if disagg:
        fleet = DisaggFleet(
            factory, prefill_replicas=args.prefill_replicas,
            decode_replicas=args.decode_replicas,
            prefix_bucket_len=args.prefix_bucket,
            handoff_capacity=args.handoff_capacity,
            max_queue_depth=args.queue_bound, clock=vclock,
            tracer=tracer)
        decode_names = {n for n, r in fleet.replicas.items()
                        if r.pool == "decode"}
    else:
        fleet = ServingFleet(
            factory, args.prefill_replicas + args.decode_replicas,
            probe=ProbeConfig(slow_start_steps=1),
            router=Router(prefix_bucket_len=args.prefix_bucket,
                          spill_tokens=args.spill_tokens),
            clock=vclock)
        for _ in range(2):
            fleet.step()
        decode_names = set(fleet.replicas)

    rng = np.random.default_rng(args.seed)
    arrivals = build_workload(
        rng, args.n_requests, rate=args.rate,
        prompt_lens=(args.prompt_min, args.prompt_max),
        new_tokens=(args.new_min, args.new_max),
        vocab_size=cfg.vocab_size,
        shared_prefixes=args.shared_prefixes,
        shared_prefix_len=args.prefix_bucket if args.shared_prefixes
        else 0,
        shared_fraction=args.shared_fraction,
        burst_start=args.burst_start, burst_len=args.burst_len,
        burst_rate=args.burst_rate)

    by_step: dict = {}
    for a in arrivals:
        by_step.setdefault(a.step, []).append(a)
    outcomes: dict = {}
    rejected = 0
    tpot_cost: List[float] = []
    last: dict = {}
    step = 0
    while by_step or fleet.has_live_requests or fleet.queue_depth > 0:
        for a in by_step.pop(step, []):
            r = fleet.submit(a.prompt, a.max_new_tokens, tenant=a.tenant,
                             priority=a.priority, deadline_s=a.deadline_s)
            if isinstance(r, Rejected):
                rejected += 1
        for rid in fleet.step():
            res = fleet.result(rid)
            if res is not None:
                outcomes[rid] = res
        for name, rep in fleet.replicas.items():
            e = rep.engine
            if e is None:
                continue
            em0, ad0, pp0 = last.get(name, (e.stats["emitted"],
                                            e.stats["admitted"],
                                            e.stats["prefill_positions"]))
            em, ad, pp = (e.stats["emitted"], e.stats["admitted"],
                          e.stats["prefill_positions"])
            last[name] = (em, ad, pp)
            if name not in decode_names:
                continue
            cost = _DISAGG_STEP_BASE + _DISAGG_PREFILL_COST * (pp - pp0)
            decode_tokens = ((em - em0) - (ad - ad0) if not disagg
                             else em - em0)
            tpot_cost.extend([cost] * max(decode_tokens, 0))
        vclock.advance(args.step_dt)
        step += 1

    states = [r.state.value for r in outcomes.values()]
    total_tokens = sum(len(r.tokens) for r in outcomes.values())
    from tpu_on_k8s_torch.autoscale.signals import percentile
    tp = sorted(tpot_cost)

    def cost_pctl(q):
        # the repo's ONE nearest-rank definition — a local formula would
        # make one JSON blob disagree with itself
        p = percentile(tp, q)
        return None if p is None else round(p, 3)

    per_pool: dict = {}
    for name, rep in sorted(fleet.replicas.items()):
        pool = getattr(rep, "pool", "monolithic")
        m = rep.metrics
        if m is None:
            continue
        agg = per_pool.setdefault(pool, {"replicas": 0, "ttft": [],
                                         "queue_wait": [], "tpot": []})
        agg["replicas"] += 1
        agg["ttft"] += list(m.histograms["time_to_first_token_seconds"])
        agg["queue_wait"] += list(m.histograms["queue_wait_seconds"])
        agg["tpot"] += list(
            m.histograms["time_per_output_token_seconds"])
    breakdown = {
        pool: {
            "replicas": agg["replicas"],
            "ttft_ms_p50": _pctl(agg["ttft"], 0.50),
            "ttft_ms_p95": _pctl(agg["ttft"], 0.95),
            "queue_wait_ms_p95": _pctl(agg["queue_wait"], 0.95),
            "tpot_ms_p50": _pctl(agg["tpot"], 0.50),
            "tpot_ms_p95": _pctl(agg["tpot"], 0.95),
        } for pool, agg in sorted(per_pool.items())}

    if disagg:
        recompute = fleet.store.stats["misses"]
    else:
        recompute = sum(r.engine.stats["prefix_prefills"]
                        for r in fleet.replicas.values()
                        if r.engine is not None)
    summary = {
        "metric": "disagg_trace" if disagg else "disagg_control_trace",
        "requests": len(arrivals),
        "served": states.count("done"),
        "rejected": rejected,
        "deadline_exceeded": states.count("deadline_exceeded"),
        "cancelled": states.count("cancelled"),
        "retry_exhausted": states.count("retry_exhausted"),
        "tokens": total_tokens,
        "driver_steps": step,
        "decode_tpot_cost_p50": cost_pctl(0.50),
        "decode_tpot_cost_p95": cost_pctl(0.95),
        "prefix_prefill_recompute": recompute,
        "per_pool": breakdown,
    }
    _dump_trace(tracer, args, summary)
    if disagg:
        summary.update(
            handoffs_enqueued=fleet.stats["handoffs_enqueued"],
            handoffs_adopted=fleet.stats["handoffs_adopted"],
            handoffs_lost=fleet.stats["handoffs_lost"],
            handoffs_corrupt=fleet.stats["handoffs_corrupt"],
            replayed=fleet.stats["replayed"],
            prefix_store=dict(fleet.store.stats),
            event_log=list(fleet.event_log))
    return summary


def _disagg_main(args, cfg, params, max_len) -> dict:
    """``--disagg``: the shared-prefix bursty trace through the
    disaggregated fleet AND the monolithic control arm (same engine
    count, same trace), reporting decode TPOT p95 and fleet-wide
    prefix-prefill recomputation side by side. With ``--soak`` the
    disagg trace runs TWICE from scratch and the event logs must be
    byte-identical, the accounting must balance, and the disagg arm
    must win both headline comparisons — ``DISAGG_SOAK_FAILED seed=N``
    on any violation so a red run replays verbatim."""
    control = run_disagg_trace(args, cfg, params, max_len, disagg=False)
    summary = run_disagg_trace(args, cfg, params, max_len, trace=True)
    event_log = summary.pop("event_log")
    summary["control"] = {
        k: control[k] for k in ("decode_tpot_cost_p50",
                                "decode_tpot_cost_p95",
                                "prefix_prefill_recompute", "served",
                                "per_pool")}
    summary["tpot_p95_win"] = (
        summary["decode_tpot_cost_p95"] is not None
        and control["decode_tpot_cost_p95"] is not None
        and summary["decode_tpot_cost_p95"]
        < control["decode_tpot_cost_p95"])
    summary["recompute_win"] = (summary["prefix_prefill_recompute"]
                                < control["prefix_prefill_recompute"])
    if args.soak:
        rerun = run_disagg_trace(args, cfg, params, max_len)
        accounted = (summary["served"] + summary["rejected"]
                     + summary["deadline_exceeded"] + summary["cancelled"]
                     + summary["retry_exhausted"])
        replayed = event_log == rerun["event_log"]
        ok = (accounted == args.n_requests and replayed
              and summary["tpot_p95_win"] and summary["recompute_win"])
        summary["soak_ok"] = ok
        summary["event_log_replayed"] = replayed
        if not ok:
            print(json.dumps(summary))
            print(f"DISAGG_SOAK_FAILED seed={args.seed} "
                  f"accounted={accounted}/{args.n_requests} "
                  f"replayed={replayed} "
                  f"tpot_win={summary['tpot_p95_win']} "
                  f"recompute_win={summary['recompute_win']}")
            raise SystemExit(1)
        print(f"DISAGG_SOAK_OK seed={args.seed}", file=sys.stderr)
    print(json.dumps(summary))
    return summary


def run_shard_trace(args, cfg, params, max_len, *, model_axis: int,
                    baseline_bytes: Optional[int] = None,
                    trace: bool = False, mesh=None) -> dict:
    """One seeded virtual-clock trace through a ``ServingGateway`` whose
    engine is mesh-sharded with ``model=model_axis`` over the world's
    first ``model_axis`` ranks (``mesh``: a ``serving_mesh`` every rank
    made, as ``_shard_main`` makes them; ``model_axis=1`` is the
    single-program control arm — plain ``mesh=None`` engine, bit-for-bit
    today's serving path).

    Device time follows an explicit cost model, mirroring the
    spec/disagg arms': decode is HBM-bandwidth-bound, so one engine
    step costs ``step_dt`` scaled by the fraction of param+KV bytes
    each chip actually reads (measured off the REAL sharded arrays'
    shard shapes — `engine.shard_report`), plus ``--shard-comm-dt``
    per step for the `model`-axis collectives when sharded. TPOT then
    shows the real structure: per-chip bytes shrink ~linearly with the
    ``model`` axis, so steps get proportionally cheaper, minus the
    collective tax. Deterministic per seed — the event log
    byte-compares across runs and greedy makes every arm's OUTPUT
    TOKENS identical (the oracle the soak asserts).

    ``--bench`` swaps the cost model for the WALL clock (with an
    off-trace warmup), same contract as the spec arm: on cards it
    measures the hardware TPOT delta across meshes, not the modeled one
    (per-chip bytes are measured off the real shard shapes either
    way)."""
    from tpu_on_k8s_torch.metrics import ServingMetrics, ShardMetrics
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.serve import (
        AdmissionConfig,
        Rejected,
        ServingGateway,
    )

    if (mesh is None) != (model_axis == 1):
        raise ValueError(f"model_axis {model_axis} takes "
                         f"{'no mesh' if model_axis == 1 else 'a mesh'} "
                         f"(serving_mesh(model={model_axis}) made on every "
                         f"rank, as _shard_main makes it)")
    wall = bool(args.bench)
    vclock = _VirtualClock()
    clock = time.monotonic if wall else vclock
    tracer = _make_tracer(args, clock) if trace else None
    shard_metrics = ShardMetrics()
    engine = ContinuousBatchingEngine(
        cfg, params, n_slots=args.n_slots, max_len=max_len, clock=clock,
        mesh=mesh, shard_metrics=shard_metrics, device=args.device)
    report = engine.shard_report()
    my_bytes = (report["param_bytes_per_chip"]
                + report["kv_bytes_per_chip"])
    total = report["param_bytes_total"] + report["kv_bytes_total"]
    base = baseline_bytes if baseline_bytes is not None else total
    bytes_frac = my_bytes / base
    step_cost = args.step_dt * bytes_frac + (
        args.shard_comm_dt if model_axis > 1 else 0.0)
    metrics = ServingMetrics()
    gateway = ServingGateway(
        engine, AdmissionConfig(max_queue_depth=args.queue_bound),
        metrics=metrics, clock=clock, tracer=tracer)

    rng = np.random.default_rng(args.seed)
    arrivals = build_workload(
        rng, args.n_requests, rate=args.rate,
        prompt_lens=(args.prompt_min, args.prompt_max),
        new_tokens=(args.new_min, args.new_max),
        vocab_size=cfg.vocab_size,
        deadline_s=args.deadline_s or None,
        deadline_fraction=args.deadline_fraction)
    by_step: dict = {}
    for a in arrivals:
        by_step.setdefault(a.step, []).append(a)
    if wall:
        # hardware run: run this mesh's prefill/step paths for every
        # bucket the trace can hit OFF the measured trace (same guard as
        # the --spec and monolithic --bench paths)
        from tpu_on_k8s_torch.models.decode import _bucket_len
        buckets = sorted({_bucket_len(int(a.prompt.size), engine.max_len)
                          for a in arrivals})
        for bucket in buckets:
            lp = min(bucket, engine.max_len - 2)
            for _ in range(7):
                gateway.submit(rng.integers(
                    0, cfg.vocab_size, size=lp).astype(np.int32), 8)
            gateway.run()
        metrics.histograms.clear()
    outcomes: dict = {}
    event_log: List[str] = []
    rejected = 0
    step = 0
    live = True
    while by_step or live:
        due = by_step.pop(step, [])
        for a in due:
            r = gateway.submit(a.prompt, a.max_new_tokens, tenant=a.tenant,
                               priority=a.priority, deadline_s=a.deadline_s)
            if isinstance(r, Rejected):
                rejected += 1
        done = gateway.step()
        for rid in done:
            res = gateway.result(rid)
            if res is not None:
                outcomes[rid] = res
        if not wall:
            vclock.advance(step_cost)
        event_log.append(
            f"step={step} arrivals={len(due)} "
            f"finished={','.join(map(str, sorted(done)))} "
            f"emitted={engine.stats['emitted']}")
        live = gateway.queue_depth > 0 or gateway._live()
        step += 1

    states = [r.state.value for r in outcomes.values()]
    tpot = list(metrics.histograms["time_per_output_token_seconds"])
    ttft = list(metrics.histograms["time_to_first_token_seconds"])
    summary = {
        "metric": "shard_trace",
        "mesh_model": model_axis,
        "mesh_axes": report["mesh_axes"],
        "n_chips": report["n_chips"],
        "requests": len(arrivals),
        "served": states.count("done"),
        "rejected": rejected,
        "deadline_exceeded": states.count("deadline_exceeded"),
        "cancelled": states.count("cancelled"),
        "retry_exhausted": states.count("retry_exhausted"),
        "tokens": sum(len(r.tokens) for r in outcomes.values()),
        "driver_steps": step,
        "clock": "wall" if wall else "cost-model",
        "virtual_s": None if wall else round(vclock.t, 6),
        "param_bytes_per_chip": report["param_bytes_per_chip"],
        "kv_bytes_per_chip": report["kv_bytes_per_chip"],
        "bytes_frac": round(bytes_frac, 6),
        "step_cost": None if wall else round(step_cost, 6),
        "tpot_ms_p50": _pctl(tpot, 0.50),
        "tpot_ms_p95": _pctl(tpot, 0.95),
        "ttft_ms_p50": _pctl(ttft, 0.50),
        "ttft_ms_p95": _pctl(ttft, 0.95),
        "outputs": {rid: tuple(int(t) for t in r.tokens)
                    for rid, r in sorted(outcomes.items())},
        "event_log": event_log,
    }
    _dump_trace(tracer, args, summary)
    return summary


def _shard_main(args, cfg, params, max_len) -> dict:
    """``--shard``: the same seeded cost-model trace across mesh sizes
    (``--shard-meshes``, default 1,2,4 — the ranks of the job's
    ``torch.distributed`` world: torchrun's, else a world of one rank in
    this process), reporting TPOT p50/p95 and per-chip param+KV bytes per
    arm, with greedy token identity across every arm. Rank 0 drives and
    prints; every other rank serves its share of each mesh engine
    (``parallel/serving.serve_mesh_worker``) and returns ``{}``. With
    ``--soak`` the largest arm runs TWICE from scratch and the event logs
    must byte-compare, the accounting must balance, every arm must be
    token-identical to the unsharded arm, and per-chip bytes must shrink
    ~linearly with the `model` axis — ``SHARD_SOAK_FAILED seed=N`` on
    any violation so a red run replays verbatim."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.parallel.mesh import serving_mesh
    from tpu_on_k8s_torch.parallel.serving import (
        serve_mesh_worker,
        shutdown_mesh_workers,
    )
    from tpu_on_k8s_torch.train.distributed import initialize, local_world

    meshes = sorted({int(m) for m in str(args.shard_meshes).split(",")})
    if meshes[0] != 1:
        meshes = [1] + meshes
    dev = resolve_device(args.device)
    made = not dist.is_initialized()
    initialize(device=dev)
    if not dist.is_initialized():
        local_world(dev)
    try:
        n_dev = dist.get_world_size()
        skipped = [m for m in meshes if m > n_dev]
        meshes = [m for m in meshes if m <= n_dev]
        # every rank makes every mesh, in the same order
        built = {m: serving_mesh(model=m, ranks=list(range(m)), device=dev)
                 for m in meshes if m > 1}
        if dist.get_rank() != 0:
            serve_mesh_worker(list(built.values()))
            return {}
        if skipped:
            # never silently shrink coverage: the summary says what was cut
            print(f"[serve_load] skipping mesh sizes {skipped}: only "
                  f"{n_dev} devices visible", file=sys.stderr)
        try:
            return _shard_arms(args, cfg, params, max_len, meshes, skipped,
                               built)
        finally:
            shutdown_mesh_workers()
    finally:
        if made:
            dist.destroy_process_group()


def _shard_arms(args, cfg, params, max_len, meshes, skipped, built) -> dict:
    """The driver's half of ``_shard_main``: every arm, then the summary
    and the soak."""
    arms = {}
    baseline_bytes = None
    for m in meshes:
        arm = run_shard_trace(args, cfg, params, max_len, model_axis=m,
                              baseline_bytes=baseline_bytes,
                              trace=bool(args.trace_out) and m == meshes[-1],
                              mesh=built.get(m))
        if m == 1:
            baseline_bytes = (arm["param_bytes_per_chip"]
                              + arm["kv_bytes_per_chip"])
        arms[m] = arm
    outputs = {m: arm.pop("outputs") for m, arm in arms.items()}
    event_logs = {m: arm.pop("event_log") for m, arm in arms.items()}
    top = meshes[-1]
    summary = {
        "metric": "shard_trace",
        "meshes": meshes,
        "skipped_meshes": skipped,
        "token_identical": all(outputs[m] == outputs[1] for m in meshes),
        "tpot_ms_p95_mesh1": arms[1]["tpot_ms_p95"],
        f"tpot_ms_p95_mesh{top}": arms[top]["tpot_ms_p95"],
        "arms": {str(m): arms[m] for m in meshes},
    }
    if args.soak:
        rerun = run_shard_trace(args, cfg, params, max_len, model_axis=top,
                                baseline_bytes=baseline_bytes,
                                mesh=built.get(top))
        a = arms[top]
        accounted = (a["served"] + a["rejected"] + a["deadline_exceeded"]
                     + a["cancelled"] + a["retry_exhausted"])
        replayed = event_logs[top] == rerun["event_log"]
        # per-chip param+KV memory shrinks ~linearly with the model
        # axis: replicated leaves (norms, non-dividing dims) keep it
        # from exact 1/m, so allow 35% slack over the ideal
        linear_ok = all(
            (arms[m]["param_bytes_per_chip"] + arms[m]["kv_bytes_per_chip"])
            <= baseline_bytes / m * 1.35 for m in meshes)
        ok = (accounted == args.n_requests and replayed
              and summary["token_identical"] and linear_ok)
        summary["soak_ok"] = ok
        summary["event_log_replayed"] = replayed
        summary["per_chip_bytes_linear"] = linear_ok
        if not ok:
            print(json.dumps(summary))
            print(f"SHARD_SOAK_FAILED seed={args.seed} "
                  f"accounted={accounted}/{args.n_requests} "
                  f"replayed={replayed} "
                  f"token_identical={summary['token_identical']} "
                  f"linear={linear_ok}")
            raise SystemExit(1)
        print(f"SHARD_SOAK_OK seed={args.seed}", file=sys.stderr)
    print(json.dumps(summary))
    return summary


def build_parser() -> argparse.ArgumentParser:
    """The driver's flags: the reference's, with ``--device``."""
    p = argparse.ArgumentParser(description="gateway load generator")
    p.add_argument("--bench", action="store_true",
                   help="350M flagship (bench_config) instead of tiny — "
                        "the hardware TTFT measurement")
    p.add_argument("--n-slots", type=int, default=4)
    p.add_argument("--n-requests", type=int, default=32)
    p.add_argument("--rate", type=float, default=2.0,
                   help="mean Poisson arrivals per engine step")
    p.add_argument("--queue-bound", type=int, default=64)
    p.add_argument("--prompt-min", type=int, default=4)
    p.add_argument("--prompt-max", type=int, default=24)
    p.add_argument("--new-min", type=int, default=4)
    p.add_argument("--new-max", type=int, default=16)
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help=">0: this deadline on --deadline-fraction of "
                        "requests")
    p.add_argument("--deadline-fraction", type=float, default=0.0)
    p.add_argument("--horizon", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--replicas", type=int, default=0,
                   help=">0: route the trace through a ServingFleet of "
                        "this many replicas (router + per-replica "
                        "TTFT/queue-wait breakdown)")
    p.add_argument("--prefix-bucket", type=int, default=PAGE_TOKENS,
                   help="router prefix-affinity bucket length "
                        "(with --replicas)")
    p.add_argument("--shared-prefixes", type=int, default=3,
                   help="fixed system prompts (of --prefix-bucket tokens) "
                        "a --shared-fraction of fleet requests prepend — "
                        "0 leaves the affinity path structurally cold")
    p.add_argument("--shared-fraction", type=float, default=0.6,
                   help="fraction of fleet requests carrying a shared "
                        "prefix")
    p.add_argument("--trace-out", default="",
                   help="write the request-span dump "
                        "(obs/trace.py format) here and fold the TTFT "
                        "critical-path segment breakdown into the "
                        "summary — works in every mode; virtual-clock "
                        "modes (--disagg/--autoscale) produce "
                        "byte-identical dumps for a given seed")
    p.add_argument("--soak", action="store_true",
                   help="assert zero-silent-loss accounting; print "
                        "FLEET_SOAK_FAILED seed=N and exit 1 on violation "
                        "(with --autoscale: also run the trace twice and "
                        "require byte-identical decision logs)")
    # --- disaggregated serving mode (serve/disagg.py) ---
    p.add_argument("--disagg", action="store_true",
                   help="drive the shared-prefix bursty trace through a "
                        "DisaggFleet plus a monolithic control arm: "
                        "per-pool TTFT/TPOT breakdown, cost-model decode "
                        "TPOT p95, fleet-wide prefix recompute count")
    p.add_argument("--prefill-replicas", type=int, default=1,
                   help="prefill pool size (--disagg; the control arm "
                        "runs prefill+decode replicas monolithically)")
    p.add_argument("--decode-replicas", type=int, default=1,
                   help="decode pool size (--disagg)")
    p.add_argument("--handoff-capacity", type=int, default=16,
                   help="bounded prefill→decode handoff queue (--disagg)")
    p.add_argument("--spill-tokens", type=int, default=24,
                   help="control-arm router bounded-load threshold "
                        "(--disagg): a bursty shared prefix spills past "
                        "its affinity replica and recomputes there — the "
                        "monolithic cost the fleet store eliminates")
    # --- mesh-sharded serving mode (models/serving.py mesh path) ---
    p.add_argument("--shard", action="store_true",
                   help="drive the same seeded cost-model trace across "
                        "mesh sizes (--shard-meshes) over the ranks of "
                        "the torch.distributed world: TPOT p50/p95 + "
                        "per-chip param+KV bytes per arm, greedy token "
                        "identity across arms")
    p.add_argument("--shard-meshes", default="1,2,4",
                   help="comma-separated `model`-axis sizes to compare "
                        "(--shard); 1 is always included as the control")
    p.add_argument("--shard-comm-dt", type=float, default=0.004,
                   help="cost-model price of one step's model-axis "
                        "collectives in virtual seconds (--shard); "
                        "charged only on sharded arms")
    # --- speculative decoding mode (models/serving.py batched drafts) ---
    p.add_argument("--spec", action="store_true",
                   help="drive the trace through a speculative-decoding "
                        "engine AND a plain control arm on the seeded "
                        "cost-model virtual clock: TPOT p50/p95 both "
                        "arms, acceptance rate, draft-overhead share, "
                        "greedy token-identity")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft proposals per speculative round (--spec)")
    p.add_argument("--spec-draft-frac", type=float, default=0.15,
                   help="cost-model price of one draft forward as a "
                        "fraction of a target forward (--spec); a spec "
                        "round costs step_dt*(1+(k+1)*frac)")
    p.add_argument("--spec-draft-layers", type=int, default=0,
                   help="draft with the target's first N layers instead "
                        "of the self-draft (--spec): measured acceptance "
                        "instead of the =1 upper bound")
    # --- SLO burn-rate mode (obs/slo.py engine) ---
    p.add_argument("--paged", action="store_true",
                   help="paged-KV concurrency probe: the paged engine "
                        "vs a dense control spending the SAME KV bytes "
                        "as whole-sequence slots, on one seeded "
                        "shared-prefix burst; greedy makes the arms "
                        "token-identical and the win is peak "
                        "concurrency + recompute/copy positions")
    p.add_argument("--paged-pool-pages", type=int, default=40,
                   help="KV page pool size (--paged); the dense control "
                        "gets pool_pages*page_tokens // max_len slots")
    p.add_argument("--paged-page-tokens", type=int, default=8,
                   help="tokens per page (--paged); must divide the "
                        "128-token position granule")
    p.add_argument("--paged-prefix-len", type=int, default=40,
                   help="shared-prefix length (--paged); each of "
                        "--shared-prefixes prefixes is registered once "
                        "on the paged arm, resubmitted whole by the "
                        "dense arm")
    p.add_argument("--paged-slots", type=int, default=48,
                   help="slot count for the paged arm (--paged): set "
                        "above the pool's reach so PAGES, not slots, "
                        "bound concurrency")
    p.add_argument("--slo", action="store_true",
                   help="drive a seeded virtual-clock trace with a "
                        "latency regression injected mid-run, watched by "
                        "the error-budget burn-rate engine AND a "
                        "static-threshold control arm: detection steps "
                        "both arms, budget event log, per-tenant "
                        "good/degraded tokens + chip-seconds")
    p.add_argument("--slo-target-ttft", type=float, default=0.3,
                   help="TTFT p95 SLO target in virtual seconds (--slo)")
    p.add_argument("--slo-window", type=float, default=60.0,
                   help="error-budget compliance window, virtual seconds "
                        "(--slo); burn windows derive from it")
    p.add_argument("--slo-regress-step", type=int, default=60,
                   help="driver step the latency regression begins at")
    p.add_argument("--slo-regress-factor", type=float, default=6.0,
                   help="step-cost multiplier once the regression is on")
    p.add_argument("--slo-eval-every", type=int, default=2,
                   help="evaluate both detectors every N driver steps")
    p.add_argument("--slo-static-sustain", type=int, default=3,
                   help="consecutive breached evaluations the naive "
                        "static-threshold arm requires before alarming "
                        "(its flap protection — and its lag)")
    p.add_argument("--slo-out", default="",
                   help="write the budget timeline + page exemplars "
                        "(the input of the reference's tools/slo_report.py) "
                        "here (--slo)")
    # --- SLO autoscaler mode (autoscale/ closed loop) ---
    p.add_argument("--autoscale", action="store_true",
                   help="drive a bursty trace through ServingFleet + "
                        "FleetAutoscaler on a virtual clock: decisions, "
                        "replica trajectory, TTFT before/after scale-up")
    p.add_argument("--burst-start", type=int, default=6,
                   help="driver step the burst begins at (--autoscale)")
    p.add_argument("--burst-len", type=int, default=10,
                   help="burst length in driver steps (--autoscale)")
    p.add_argument("--burst-rate", type=float, default=6.0,
                   help="mean arrivals per step during the burst")
    p.add_argument("--autoscale-every", type=int, default=2,
                   help="autoscaler tick every N driver steps")
    p.add_argument("--autoscale-slo", type=float, default=0.0,
                   help=">0: add a spec.slo TTFT p95 objective at this "
                        "target (virtual seconds) to the autoscaled "
                        "service — the burst pages the error budget and "
                        "the page grants the scale-up its cooldown "
                        "bypass (--autoscale); 0 is byte-identical to "
                        "the SLO-free trace")
    p.add_argument("--autoscale-slo-window", type=float, default=6.0,
                   help="the SLO compliance window in virtual seconds "
                        "(burn windows derive from it)")
    p.add_argument("--ledger-out", default="",
                   help="write the decision ledger "
                        "(obs/ledger.py dump; the obs/why_report.py "
                        "input) here — autoscale "
                        "mode, virtual clock, byte-identical per seed")
    p.add_argument("--step-dt", type=float, default=0.05,
                   help="virtual seconds per driver step")
    p.add_argument("--min-replicas", type=int, default=1)
    p.add_argument("--max-replicas", type=int, default=4)
    p.add_argument("--min-warm", type=int, default=0,
                   help="warm floor: pre-provisioned burst capacity")
    p.add_argument("--target-ttft", type=float, default=0.4,
                   help="TTFT p95 SLO in virtual seconds (--autoscale)")
    p.add_argument("--max-scale-step", type=int, default=2,
                   help="slice-legal quanta one decision may jump")
    p.add_argument("--up-cooldown", type=float, default=0.5,
                   help="scale-up cooldown, virtual seconds")
    p.add_argument("--down-cooldown", type=float, default=2.0,
                   help="scale-down cooldown, virtual seconds")
    p.add_argument("--flap-guard", type=float, default=1.0,
                   help="minimum spacing of direction reversals, "
                        "virtual seconds")
    p.add_argument("--tail-steps", type=int, default=120,
                   help="idle steps after the trace drains (the window "
                        "in which scale-down is observed)")
    p.add_argument("--accelerator", default="nvidia-h100-80gb",
                   help="accelerator whose legal host counts scale "
                        "steps snap to (--autoscale)")
    p.add_argument("--crash-replica", type=int, default=-1,
                   help=">=0: chaos-crash replica-N mid-trace "
                        "(with --replicas)")
    p.add_argument("--crash-step", type=int, default=5,
                   help="fleet step (per replica, 1-based) the crash "
                        "fires on")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    return p


def bench_config() -> TransformerConfig:
    """The ~350M-parameter flagship shape, field for field the
    reference's ``bench.bench_config``: flash attention, the int8-forward
    MLP (on ``int8_impl="xla"``, the ``torch._int_mm`` route) with the
    fused gate+up product, remat ``mlp``. The tuning its docstring cites
    was measured on the reference's TPUs, not here."""
    return TransformerConfig(vocab_size=32768, d_model=1024, n_layers=16,
                             n_heads=16, n_kv_heads=8, d_ff=4096,
                             max_seq_len=1024, remat=True,
                             remat_policy="mlp", scan_unroll=16,
                             attn_impl="flash", mlp_int8=True,
                             mlp_fused_gateup=True)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)

    from tpu_on_k8s_torch.metrics import ServingMetrics
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.serve import AdmissionConfig, ServingGateway

    if args.bench:
        cfg = bench_config()
        max_len = 512
    else:
        cfg = dataclasses.replace(TransformerConfig.tiny(),
                                  dtype=torch.float32, max_seq_len=64)
        if args.shard:
            # all four kv heads: the KV pool then shards on `model` up
            # to a 4-way mesh (tiny's GQA 2 would cap KV sharding at 2)
            cfg = dataclasses.replace(cfg, n_kv_heads=4)
        max_len = None
    # the weights are fixed whatever --seed says (it seeds the traffic),
    # as the reference's are; bf16 under --bench, norm scales in fp32
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)

    if args.shard:
        return _shard_main(args, cfg, params, max_len)
    if args.slo:
        return _slo_main(args, cfg, params, max_len)
    if args.spec:
        return _spec_main(args, cfg, params, max_len)
    if args.paged:
        return _paged_main(args, cfg, params, max_len)
    if args.disagg:
        return _disagg_main(args, cfg, params, max_len)
    if args.autoscale:
        return _autoscale_main(args, cfg, params, max_len)
    if args.replicas > 0:
        return _fleet_main(args, cfg, params, max_len)

    metrics = ServingMetrics()
    tracer = _make_tracer(args, time.monotonic)
    engine = ContinuousBatchingEngine(cfg, params, n_slots=args.n_slots,
                                      max_len=max_len,
                                      step_horizon=args.horizon, device=dev)
    gateway = ServingGateway(
        engine, AdmissionConfig(max_queue_depth=args.queue_bound),
        metrics=metrics, tracer=tracer)
    rng = np.random.default_rng(args.seed)
    arrivals = build_workload(
        rng, args.n_requests, rate=args.rate,
        prompt_lens=(args.prompt_min, args.prompt_max),
        new_tokens=(args.new_min, args.new_max),
        vocab_size=cfg.vocab_size,
        deadline_s=args.deadline_s or None,
        deadline_fraction=args.deadline_fraction)
    # warmup outside the measured trace: run the step/admit paths AND
    # every (bucket, batch) prefill shape the trace can hit — bursts admit
    # as groups of 4/2/1 (engine._ADMIT_BATCH_SIZES), and a shape's first
    # run mid-trace (the card's library and allocator warm-up) would land
    # outliers in the hardware TTFT percentiles. The draws come from the
    # same rng after build_workload, as the reference's do
    from tpu_on_k8s_torch.models.decode import _bucket_len
    buckets = sorted({_bucket_len(int(a.prompt.size), engine.max_len)
                      for a in arrivals})
    for bucket in buckets:
        lp = min(bucket, engine.max_len - 2)
        for _ in range(7):
            gateway.submit(rng.integers(0, cfg.vocab_size,
                                        size=lp).astype(np.int32), 2)
        gateway.run()
    metrics.histograms.clear()
    if tracer is not None:
        # warmup requests are not the measured trace (same rationale as
        # the histogram clear); ids keep counting — only spans drop
        tracer.spans.clear()
    summary = run_load(gateway, arrivals)
    _dump_trace(tracer, args, summary)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
