"""Job, serving and training metrics: counters, histograms and gauges,
scrapeable at /metrics.

Counterpart of ``tpu_on_k8s/metrics/metrics.py``: the job controller's
``JobMetrics`` (lifecycle counters and launch delays, labelled by kind),
``ServingMetrics`` (request counters, time-to-first-token, queue-wait and
latency histograms, slot and queue gauges), ``PagedKVMetrics`` (page
occupancy, allocations, aliases, admission stalls) and ``SpecMetrics``
(speculative decoding's proposals, acceptances, rollbacks and draft
crashes), the serving plane's ``FleetMetrics`` (routing, rollouts,
handoffs and the fleet prefix store, labelled by replica or pool) and
``ModelPoolMetrics`` (model swaps and per-model counters, labelled by
model), the serving control plane's ``AutoscaleMetrics`` (the fleet
autoscaler's decisions and signals, labelled by action or service) and
``SLOMetrics`` (burn rates, budget states and the goodput ledger,
labelled by objective, state or tenant), the decision ledger's
``LedgerMetrics`` (decisions by loop and outcome, commit failures, open
effect horizons) and the capacity broker's ``BrokerMetrics`` (grants,
refusals, ladder rungs, fills, lane conflicts; free chips and lanes under
pressure), with the training half's
``TrainMetrics`` (the training loop's gauges and counters). Each is
backed by
``prometheus_client`` when it imports and always mirrored in plain dicts,
so tests and drivers read them without a scrape. ``exposition`` renders
the scrape body with the client or, without it, with ``render_text`` over
the mirrors; ``serve`` answers /metrics with that body from a stdlib HTTP
server thread either way.
"""
from __future__ import annotations

import bisect
import http.server
import threading
import warnings
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

try:
    import prometheus_client as _prom
except ImportError:
    _prom = None

# exemplar-capable Histogram.observe (prometheus_client >= 0.9), detected
# once: the exemplar rides into the client's bucket storage, so an
# OpenMetrics scrape carries it (classic text-format scrapes ignore it)
if _prom is not None:
    import inspect as _inspect
    _PROM_EXEMPLARS = "exemplar" in _inspect.signature(
        _prom.Histogram.observe).parameters
else:
    _PROM_EXEMPLARS = False


@dataclass(frozen=True)
class _Family:
    """Schema of one exported metric family, declared by every metrics
    class with or without prometheus, so the pure-Python ``render_text``
    exports the families the prometheus backend would."""

    full: str                      # exported family name (with namespace)
    kind: str                      # "counter" | "gauge" | "histogram"
    labels: Tuple[str, ...]        # label names ((), or exactly one)
    help: str
    buckets: Optional[Tuple[float, ...]] = None


class _MetricsBase:
    """Shared mirror scaffolding: a lock, plain-dict counters, gauges and
    histograms (readable without a scrape) and the optional prometheus
    twins. The histogram mirror is a bounded deque: serving observes per
    request, so an unbounded list would grow for the life of a server;
    prometheus keeps the full-precision aggregates."""

    #: raw observations retained per histogram (newest win)
    MIRROR_CAP = 10_000
    #: (value, trace_id) exemplars retained per histogram
    EXEMPLAR_CAP = 64

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = defaultdict(int)
        self.gauges: Dict[str, float] = {}
        cap = self.MIRROR_CAP
        self.histograms: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=cap))
        # monotone observation counts per histogram: the bounded mirror
        # stops growing at its cap, so delta readers position by these
        self.histogram_counts: Dict[str, int] = defaultdict(int)
        # trace-id exemplars per histogram (newest win)
        self.exemplars: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self.EXEMPLAR_CAP))
        # the exposition schema (mirror name -> _Family)
        self._families: Dict[str, _Family] = {}
        # running sums and per-bucket counts for render_text (the bounded
        # mirror rotates, so they accrue here, never recomputed from it)
        self.histogram_sums: Dict[str, float] = defaultdict(float)
        self._bucket_counts: Dict[str, list] = {}
        self._prom_counters = {}
        self._prom_hists = {}
        self._prom_gauges = {}
        self.registry = None

    def _declare(self, name: str, full: str, kind: str, help: str,
                 labels: Tuple[str, ...] = (),
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        """Register one family: the schema always, the prometheus twin when
        the client imported."""
        self._families[name] = _Family(full, kind, tuple(labels), help,
                                       tuple(buckets) if buckets else None)
        if kind == "histogram":
            self._bucket_counts[name] = [0] * (len(buckets or ()) + 1)
        if _prom is None or self.registry is None:
            return
        if kind == "counter":
            self._prom_counters[name] = _prom.Counter(
                full, help, list(labels), registry=self.registry)
        elif kind == "gauge":
            self._prom_gauges[name] = _prom.Gauge(
                full, help, list(labels), registry=self.registry)
        else:
            self._prom_hists[name] = _prom.Histogram(
                full, help, list(labels), buckets=buckets,
                registry=self.registry)

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            g.set(value)

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n
        c = self._prom_counters.get(name)
        if c is not None:
            c.inc(n)

    def observe(self, name: str, seconds: float, exemplar=None) -> None:
        """Record one histogram sample; ``exemplar`` (a trace id) rides
        along in a bounded deque beside the mirror."""
        with self._lock:
            self.histograms[name].append(seconds)
            self.histogram_counts[name] += 1
            self.histogram_sums[name] += seconds
            slots = self._bucket_counts.get(name)
            if slots is not None:
                fam = self._families[name]
                slots[bisect.bisect_left(fam.buckets, seconds)] += 1
            if exemplar is not None:
                self.exemplars[name].append((seconds, exemplar))
        h = self._prom_hists.get(name)
        if h is not None:
            if exemplar is not None and _PROM_EXEMPLARS:
                # an over-long label value (the client caps exemplars at
                # 128 runes) falls back to the plain observation: the
                # sample must never be lost to its annotation
                try:
                    h.observe(seconds,
                              exemplar={"trace_id": str(exemplar)})
                except ValueError:
                    h.observe(seconds)
            else:
                h.observe(seconds)


_BUCKETS = (0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600)


class JobMetrics(_MetricsBase):
    """One instance per controller manager (kind-labelled like the reference):
    job lifecycle counters, controller errors, conflict retries, the
    launch-delay histograms and the running / pending / per-queue gauges."""

    def __init__(self, kind: str = "TorchJob", registry=None) -> None:
        super().__init__()
        self.kind = kind
        self.gauges: Dict[Tuple[str, str], float] = {}
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s"
        for name in ("created", "deleted", "successful", "failed", "restarted"):
            self._declare(name, f"{ns}_jobs_{name}", "counter",
                          f"Jobs {name} for kind {kind}")
        self._declare("errors", f"{ns}_controller_errors_total", "counter",
                      "Exceptions caught in controller run loops")
        # optimistic-concurrency health: every retried 409 in a
        # read-modify-write loop (client update_with_retry/patch_meta)
        self._declare("conflict_retries", f"{ns}_conflict_retries_total",
                      "counter",
                      "Conflict (409) retries across client write loops")
        for name in ("first_pod_launch_delay_seconds",
                     "all_pods_launch_delay_seconds"):
            self._declare(name, f"{ns}_jobs_{name}", "histogram",
                          f"Job {name}", buckets=_BUCKETS)
        for name in ("running", "pending"):
            self._declare(name, f"{ns}_jobs_{name}", "gauge",
                          f"Jobs currently {name}")
        self._declare("queue_pending",
                      f"{ns}_tenant_queue_jobs_pending_count", "gauge",
                      "Pending jobs per tenant queue", labels=("queue",))

    def set_gauge(self, name: str, value: float, label: str = "") -> None:
        with self._lock:
            self.gauges[(name, label)] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            (g.labels(label) if label else g).set(value)

    # convenience wrappers matching reference call sites
    def created(self) -> None:
        self.inc("created")

    def deleted(self) -> None:
        self.inc("deleted")

    def success(self) -> None:
        self.inc("successful")

    def failure(self) -> None:
        self.inc("failed")

    def restarted(self) -> None:
        self.inc("restarted")

    def error(self) -> None:
        self.inc("errors")

    def first_pod_launch_delay(self, seconds: float) -> None:
        self.observe("first_pod_launch_delay_seconds", seconds)

    def all_pods_launch_delay(self, seconds: float) -> None:
        self.observe("all_pods_launch_delay_seconds", seconds)


_SERVING_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1,
                    2.5, 5, 10, 30)


class ServingMetrics(_MetricsBase):
    """Continuous-batching serving: request counters, time-to-first-token,
    queue-wait and request-latency histograms, slot and queue gauges. The
    families are the reference's, gateway and crash-recovery counters
    included, so one scrape schema serves both packages."""

    def __init__(self, registry=None) -> None:
        super().__init__()
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_serving"
        for name in ("requests_submitted", "requests_finished",
                     "tokens_emitted",
                     # gateway lifecycle: rejection, client cancel,
                     # deadline abort
                     "requests_rejected", "requests_cancelled",
                     "deadline_exceeded",
                     # per-reason rejection breakdown
                     "rejected_queue_full", "rejected_load_shed",
                     "rejected_quota", "rejected_deadline",
                     "rejected_draining",
                     # crash recovery: engine deaths, re-admitted requests,
                     # requests whose replay budget ran out
                     "engine_crashes", "requests_replayed",
                     "retry_exhausted",
                     # streaming callbacks that raised and were detached
                     "callback_errors"):
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Serving {name}")
        for name in ("time_to_first_token_seconds",
                     "queue_wait_seconds", "request_latency_seconds",
                     # inter-token latency (TPOT)
                     "time_per_output_token_seconds"):
            self._declare(name, f"{ns}_{name}", "histogram",
                          f"Serving {name}", buckets=_SERVING_BUCKETS)
        for name in ("slots_active", "queue_depth"):
            self._declare(name, f"{ns}_{name}", "gauge", f"Serving {name}")


class PagedKVMetrics(_MetricsBase):
    """Paged KV (the engine's ``kv_metrics=``): pool capacity and live-page
    gauges (their ratio is the memory signal), fresh-page allocations
    against prefix-page aliases (the copy-on-write sharing), admission
    stalls (a request held in the queue because the pool could not supply
    its reservation) and ``programs_compiled``. That last counter counts
    the reference's compiled-program cache misses; the port runs eagerly
    and compiles no programs, so its engine declares it and never
    increments it."""

    def __init__(self, registry=None) -> None:
        super().__init__()
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_paged"
        for name in ("page_allocs", "pages_aliased", "admission_stalls",
                     "programs_compiled"):
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Paged KV {name}")
        for name in ("pages_total", "pages_in_use"):
            self._declare(name, f"{ns}_{name}", "gauge",
                          f"Paged KV {name}")


class SpecMetrics(_MetricsBase):
    """Speculative decoding (the engine's ``spec_metrics=``): draft tokens
    proposed and accepted (their ratio is the acceptance rate, the number
    that decides whether speculation pays), rollbacks (a slot-round in
    which the target rejected at least one proposal), draft crashes (the
    engine degraded to plain decode) and the running acceptance-rate
    gauge."""

    def __init__(self, registry=None) -> None:
        super().__init__()
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_spec"
        for name in ("spec_tokens_proposed", "spec_tokens_accepted",
                     "spec_rollbacks", "spec_draft_crashes"):
            self._declare(name, f"{ns}_{name[5:]}", "counter",
                          f"Speculative decoding {name[5:]}")
        self._declare("spec_acceptance_rate", f"{ns}_acceptance_rate",
                      "gauge", "Running draft-token acceptance rate "
                      "(accepted / proposed over the engine's lifetime)")


class TrainMetrics(_MetricsBase):
    """The training loop's (``train/loop.py``'s ``TrainLoop``, fed at every
    host-sync window): step-time, tokens-per-second and MFU gauges (MFU's
    numerator from ``train/compile.py``'s ``train_step_flops``), the
    unsynced dispatch depth, host-sync and async-checkpoint counters, the
    watchdog's stalled-step counter, profiling hooks that degraded to
    warnings, and the goodput gauge the ``TrainingAccountant`` feeds. The
    reference's families, so one scrape schema serves both packages."""

    def __init__(self, registry=None) -> None:
        super().__init__()
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_train"
        for name in ("host_syncs", "checkpoints_enqueued",
                     "checkpoint_failures", "stalled_steps",
                     "profiling_failures"):
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Training loop {name}")
        for name in ("step_seconds", "tokens_per_sec", "mfu",
                     "steps_inflight", "goodput_fraction"):
            self._declare(name, f"{ns}_{name}", "gauge",
                          f"Training loop {name}")


class ReshardMetrics(_MetricsBase):
    """Live mesh reconfiguration (``parallel/reshard.py``'s transforms,
    driven through ``train/loop.py``): reshards applied, reshards that fell
    back to the checkpoint-restart path, acknowledgements that raised, the
    bytes the plans moved (leaves whose layout changed) and the last
    transform's pause in seconds, which the goodput ledger's ``reshard``
    bucket adds up. The reference's families."""

    def __init__(self, registry=None) -> None:
        super().__init__()
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_reshard"
        for name, help in (("reshards", "Live mesh reshards applied"),
                           ("reshard_fallbacks",
                            "Live reshards aborted and fallen back to "
                            "checkpoint-restart"),
                           ("reshard_ack_failures",
                            "Reshard ack callbacks that raised (the "
                            "transform outcome stands; the control-plane "
                            "write did not land)"),
                           ("bytes_moved",
                            "Bytes moved by reshard transfer plans")):
            self._declare(name, f"{ns}_{name}", "counter", help)
        self._declare("transform_seconds", f"{ns}_transform_seconds",
                      "gauge", "Last reshard transform pause in seconds")


class FleetMetrics(_MetricsBase):
    """Serving-fleet observability (`tpu_on_k8s_torch/serve/fleet.py`): the
    router/rollout layer above per-replica ``ServingMetrics``. Counters
    and gauges carry a ``replica`` label so one scrape shows the whole
    fleet's balance (in-flight per replica, routed/rerouted per replica)
    next to the fleet-wide rollout state — the per-replica breakdown an
    operator needs to see a hot replica or a stuck drain. Mirror dicts
    key by ``(name, replica)`` like ``JobMetrics`` keys by label."""

    #: rollout phase gauge encoding (stable — lands in dashboards)
    ROLLOUT_PHASE_CODES = {"idle": 0, "surging": 1, "shifting": 2,
                           "draining": 3, "complete": 4}

    _LABELED_COUNTERS = ("requests_routed", "requests_rerouted",
                         "requests_rebalanced")
    _PLAIN_COUNTERS = ("replicas_ejected", "prefix_cache_hits",
                       "prefix_cache_misses", "rollout_interrupts",
                       "rollouts_completed", "readiness_flaps",
                       "scale_ups", "scale_downs",
                       # disaggregated serving (serve/disagg.py):
                       # the prefill→decode KV handoff link — lost/corrupt
                       # are the chaos-injected failures whose replays the
                       # zero-silent-loss proof counts
                       "handoffs_enqueued", "handoffs_adopted",
                       "handoffs_lost", "handoffs_corrupt",
                       "requests_replayed",
                       # fleet prefix/KV store (serve/kvstore.py):
                       # misses ARE the fleet-wide prefix-prefill recompute
                       # count the disagg acceptance test compares
                       "prefix_store_hits", "prefix_store_misses",
                       "prefix_store_promotes", "prefix_store_evictions",
                       "prefix_store_demotes",
                       # streaming callbacks that raised and were
                       # detached (disagg token hook) — warned AND
                       # counted, mirroring ServingMetrics
                       "callback_errors")
    _LABELED_GAUGES = ("in_flight", "queue_depth", "outstanding_tokens")
    _PLAIN_GAUGES = ("replicas_ready", "replicas_total", "rollout_phase",
                     "handoff_queue_depth", "prefix_store_overflow_bytes")
    #: per-pool view of a disaggregated fleet (label value: "prefill" /
    #: "decode") — one scrape shows both pools' load side by side, which
    #: is exactly what the per-pool autoscaler loops act on
    _POOL_GAUGES = ("pool_replicas_ready", "pool_queue_depth",
                    "pool_inflight_tokens", "pool_slots")

    def __init__(self, registry=None) -> None:
        super().__init__()
        self.counters: Dict[Tuple[str, str], int] = defaultdict(int)
        self.gauges: Dict[Tuple[str, str], float] = {}
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_fleet"
        for name in self._LABELED_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter", f"Fleet {name}",
                          labels=("replica",))
        for name in self._PLAIN_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter", f"Fleet {name}")
        for name in self._LABELED_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge", f"Fleet {name}",
                          labels=("replica",))
        for name in self._PLAIN_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge", f"Fleet {name}")
        for name in self._POOL_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge", f"Fleet {name}",
                          labels=("pool",))
        # handoff queue wait: enqueue → adoption on a decode replica
        # (the latency the handoff link adds to TTFT)
        self._declare("handoff_wait_seconds", f"{ns}_handoff_wait_seconds",
                      "histogram", "Fleet handoff_wait_seconds",
                      buckets=_SERVING_BUCKETS)

    def inc(self, name: str, n: int = 1, replica: str = "") -> None:
        with self._lock:
            self.counters[(name, replica)] += n
        c = self._prom_counters.get(name)
        if c is not None:
            (c.labels(replica) if name in self._LABELED_COUNTERS
             else c).inc(n)

    def set_gauge(self, name: str, value: float, replica: str = "",
                  pool: str = "") -> None:
        label = pool or replica
        with self._lock:
            self.gauges[(name, label)] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            if name in self._LABELED_GAUGES:
                g.labels(replica).set(value)
            elif name in self._POOL_GAUGES:
                g.labels(pool).set(value)
            else:
                g.set(value)

    def set_rollout_phase(self, phase: str) -> None:
        self.set_gauge("rollout_phase",
                       self.ROLLOUT_PHASE_CODES.get(phase, -1))


class ModelPoolMetrics(_MetricsBase):
    """Multi-model density telemetry (`tpu_on_k8s_torch/serve/modelpool.py`):
    the hot-swap plane one replica gang runs when it hosts several
    ModelVersion serving trees. Counters: swaps applied (a params-tree
    replace, no recompile), swap failures (the replace died mid-flight —
    previous params stayed live; a climbing rate means the artifact
    store or staging path is sick), swap retries, residency evictions
    (a model pushed out of the LRU set — its prefix pages flushed
    surgically), and the per-model token/request counters (labelled by
    model, the tenant-accounting join key). The ``swap_seconds``
    histogram is the measured swap-in latency — the cold-start signal
    the FleetAutoscaler reads beside TTFT. Gauges: models resident
    (prefixes warm on device) and queued requests across the per-model
    lanes. Same prometheus + plain-dict mirror pattern as the other
    classes; mirror dicts key by ``(name, label)`` like
    ``AutoscaleMetrics``."""

    _MODEL_COUNTERS = ("model_tokens", "model_requests")
    _PLAIN_COUNTERS = ("swaps", "swap_failures", "swap_retries",
                       "evictions", "prefix_flushes")
    _PLAIN_GAUGES = ("resident_models", "queued_requests")

    def __init__(self, registry=None) -> None:
        super().__init__()
        self.counters: Dict[Tuple[str, str], int] = defaultdict(int)
        self.gauges: Dict[Tuple[str, str], float] = {}
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_modelpool"
        for name in self._MODEL_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Model pool {name}", labels=("model",))
        for name in self._PLAIN_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Model pool {name}")
        for name in self._PLAIN_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge",
                          f"Model pool {name}")
        self._declare("swap_seconds", f"{ns}_swap_seconds", "histogram",
                      "Model pool swap_seconds (swap-in latency: the "
                      "cold-start signal beside TTFT)",
                      buckets=_SERVING_BUCKETS)

    def inc(self, name: str, n: int = 1, label: str = "") -> None:
        with self._lock:
            self.counters[(name, label)] += n
        c = self._prom_counters.get(name)
        if c is not None:
            (c.labels(label) if name in self._MODEL_COUNTERS else c).inc(n)

    def set_gauge(self, name: str, value: float, label: str = "") -> None:
        with self._lock:
            self.gauges[(name, label)] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            g.set(value)


class ShardMetrics(_MetricsBase):
    """Mesh-sharded serving observability (the engine's ``shard_metrics=``
    and ``serve/fleet.py``'s reshard rollouts), the reference's
    ``ShardMetrics``: the replica's mesh shape as axis-labelled
    ``mesh_axis_size`` gauges, the per-chip parameter and KV byte gauges,
    the ``export_gather_bytes`` counter (what every KV or prefix export
    gathered to the driver's host) and the ``reshard_rollouts`` counter.
    Mirror dicts key by ``(name, label)`` like ``ModelPoolMetrics``."""

    _AXIS_GAUGES = ("mesh_axis_size",)
    _PLAIN_GAUGES = ("param_bytes_per_chip", "kv_bytes_per_chip")
    _PLAIN_COUNTERS = ("reshard_rollouts", "export_gather_bytes")
    #: the serving mesh's standard axes: every ``set_mesh_axes`` writes at
    #: least these, so a reshard that drops an axis overwrites its gauge
    #: (absent = 1) instead of leaving it stale
    MESH_AXES = ("data", "model", "expert")

    def __init__(self, registry=None) -> None:
        super().__init__()
        self.counters: Dict[Tuple[str, str], int] = defaultdict(int)
        self.gauges: Dict[Tuple[str, str], float] = {}
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_shard"
        for name in self._AXIS_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge", f"Shard {name}",
                          labels=("axis",))
        for name in self._PLAIN_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge", f"Shard {name}")
        for name in self._PLAIN_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter", f"Shard {name}")

    def inc(self, name: str, n: int = 1, label: str = "") -> None:
        with self._lock:
            self.counters[(name, label)] += n
        c = self._prom_counters.get(name)
        if c is not None:
            c.inc(n)

    def set_gauge(self, name: str, value: float, label: str = "") -> None:
        with self._lock:
            self.gauges[(name, label)] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            (g.labels(label) if name in self._AXIS_GAUGES else g).set(value)

    def set_mesh_axes(self, mesh_axes) -> None:
        """Publish a replica's mesh shape: every standard axis (absent = 1)
        and any other non-trivial one. The engine and the fleet both call
        it; the last writer wins (``engine.shard_report()`` is the
        per-replica view)."""
        axes = {a: 1 for a in self.MESH_AXES}
        axes.update(mesh_axes or {})
        for axis, size in sorted(axes.items()):
            self.set_gauge("mesh_axis_size", size, label=axis)


class AutoscaleMetrics(_MetricsBase):
    """Serving-autoscaler observability (`controller/fleetautoscaler.py`
    + `tpu_on_k8s_torch/autoscale/`): every decision (labelled by action,
    so a thrashing loop is visible as alternating up/down increments),
    patch failures, stale scrapes, and per-service gauges for the closed
    loop's input (observed TTFT/queue-wait p95, queue depth, tokens per
    slot) next to its output (``desired_replicas``) — an operator can
    read SLO breach → decision → target off one scrape. Mirror dicts
    key by ``(name, label)`` like ``JobMetrics``."""

    _ACTION_COUNTERS = ("decisions",)
    _PLAIN_COUNTERS = ("patch_failures", "stale_scrapes", "ticks",
                       "tick_errors", "broker_harvests", "broker_degrades")
    _SERVICE_GAUGES = ("desired_replicas", "current_replicas",
                       "observed_ttft_p95", "observed_queue_wait_p95",
                       "observed_tpot_p95",
                       "observed_queue_depth", "observed_tokens_per_slot",
                       "signal_stale")

    def __init__(self, registry=None) -> None:
        super().__init__()
        self.counters: Dict[Tuple[str, str], int] = defaultdict(int)
        self.gauges: Dict[Tuple[str, str], float] = {}
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_autoscale"
        for name in self._ACTION_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Autoscale {name}", labels=("action",))
        for name in self._PLAIN_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Autoscale {name}")
        for name in self._SERVICE_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge",
                          f"Autoscale {name}", labels=("service",))

    def inc(self, name: str, n: int = 1, label: str = "") -> None:
        with self._lock:
            self.counters[(name, label)] += n
        c = self._prom_counters.get(name)
        if c is not None:
            (c.labels(label) if name in self._ACTION_COUNTERS else c).inc(n)

    def set_gauge(self, name: str, value: float, label: str = "") -> None:
        with self._lock:
            self.gauges[(name, label)] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            (g.labels(label) if name in self._SERVICE_GAUGES else g).set(
                value)

    def decision(self, action: str) -> None:
        self.inc("decisions", label=action)


class SLOMetrics(_MetricsBase):
    """The SLO/error-budget telemetry plane (`obs/slo.py`'s engine and
    `obs/account.py`'s accountants): per-objective multi-window burn-rate
    gauges (fast pair pages, slow pair warns), the remaining error-budget
    fraction, the encoded budget state, and the staleness bit — plus the
    goodput/cost ledger: per-tenant good vs degraded tokens (served within
    SLO or not), rejected/replayed requests, and chip-seconds attributed
    through router capacity weights. Same prometheus + plain-dict mirror
    pattern as the other classes; mirror dicts key by ``(name, label)``
    like ``AutoscaleMetrics``."""

    #: budget-state gauge encoding (stable — lands in dashboards);
    #: mirrors `obs/slo.BUDGET_STATE_CODES`
    BUDGET_STATE_CODES = {"ok": 0, "warn": 1, "page": 2, "exhausted": 3}

    _SLO_GAUGES = ("burn_rate_fast", "burn_rate_slow", "budget_remaining",
                   "budget_state", "slo_stale")
    _STATE_COUNTERS = ("budget_transitions",)
    _TENANT_COUNTERS = ("good_tokens", "degraded_tokens",
                        "rejected_requests", "replayed_requests",
                        "chip_seconds")

    def __init__(self, registry=None) -> None:
        super().__init__()
        self.counters: Dict[Tuple[str, str], int] = defaultdict(int)
        self.gauges: Dict[Tuple[str, str], float] = {}
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_slo"
        for name in self._SLO_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge", f"SLO {name}",
                          labels=("slo",))
        for name in self._STATE_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter", f"SLO {name}",
                          labels=("state",))
        for name in self._TENANT_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter", f"SLO {name}",
                          labels=("tenant",))

    def inc(self, name: str, n=1, label: str = "") -> None:
        with self._lock:
            self.counters[(name, label)] += n
        c = self._prom_counters.get(name)
        if c is not None:
            c.labels(label).inc(n)

    def set_gauge(self, name: str, value: float, label: str = "") -> None:
        with self._lock:
            self.gauges[(name, label)] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            g.labels(label).set(value)


class LedgerMetrics(_MetricsBase):
    """Decision-ledger telemetry (`obs/ledger.py`, fed by
    every control loop riding `controller/loopkernel.LoopKernel`): the
    per-loop decision counter labelled ``<loop>|<outcome>`` (outcome
    class: ``landed`` / ``conflict`` / ``fallback`` / ``hold`` /
    ``skip`` — one combined label because the mirror/fallback
    exposition schema carries at most one label per family, and the
    loop×outcome product is what an operator actually filters on),
    commit failures (patches that never landed — the loop retries at
    full speed, but a climbing rate means writers are fighting), and
    the ``open_effect_horizons`` gauge — committed decisions whose
    effect (replicas ready, rollout complete, burn recovered) has not
    yet been observed; a climbing gauge means the loops are committing
    changes whose effects never land. Same prometheus + plain-dict
    mirror pattern as the other classes; mirror dicts key by
    ``(name, label)`` like ``AutoscaleMetrics``."""

    _LOOP_COUNTERS = ("decisions",)
    _PLAIN_COUNTERS = ("commit_failures",)

    def __init__(self, registry=None) -> None:
        super().__init__()
        self.counters: Dict[Tuple[str, str], int] = defaultdict(int)
        self.gauges: Dict[Tuple[str, str], float] = {}
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_ledger"
        for name in self._LOOP_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Ledger {name}", labels=("loop_outcome",))
        for name in self._PLAIN_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Ledger {name}")
        self._declare("open_effect_horizons", f"{ns}_open_effect_horizons",
                      "gauge", "Committed decisions whose effect horizon "
                      "is still open")

    def inc(self, name: str, n: int = 1, label: str = "") -> None:
        with self._lock:
            self.counters[(name, label)] += n
        c = self._prom_counters.get(name)
        if c is not None:
            (c.labels(label) if name in self._LOOP_COUNTERS else c).inc(n)

    def set_gauge(self, name: str, value: float, label: str = "") -> None:
        with self._lock:
            self.gauges[(name, label)] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            g.set(value)


class BrokerMetrics(_MetricsBase):
    """Capacity-market telemetry (`coordinator/broker.py`):
    clearing counters — grants admitted through the ``request_capacity``
    gate, refusals (pressure opened), degrades (rung 1), harvests /
    preempts (rungs 2–3), final typed refusals (rung 4), managed-lane
    fills, expired grants, lane commit conflicts, and crashed clearing
    ticks — next to the
    market gauges: free chips after clearing, lanes under pressure, and
    the configured capacity. One label-free family each: the market is
    one per operator, and per-lane attribution already lives in the
    decision ledger's ``broker/<lane>`` loops. Mirror dicts key by
    ``(name, label)`` like ``AutoscaleMetrics``."""

    _PLAIN_COUNTERS = ("grants", "refusals", "degrades", "harvests",
                       "preempts", "refuse_final", "fills",
                       "grant_expired", "lane_conflicts", "tick_errors")
    _MARKET_GAUGES = ("free_chips", "pressure_lanes", "capacity_chips")

    def __init__(self, registry=None) -> None:
        super().__init__()
        self.counters: Dict[Tuple[str, str], int] = defaultdict(int)
        self.gauges: Dict[Tuple[str, str], float] = {}
        if _prom is not None:
            self.registry = registry or _prom.CollectorRegistry()
        ns = "tpu_on_k8s_broker"
        for name in self._PLAIN_COUNTERS:
            self._declare(name, f"{ns}_{name}", "counter",
                          f"Broker {name}")
        for name in self._MARKET_GAUGES:
            self._declare(name, f"{ns}_{name}", "gauge",
                          f"Broker {name}")

    def inc(self, name: str, n: int = 1, label: str = "") -> None:
        with self._lock:
            self.counters[(name, label)] += n
        c = self._prom_counters.get(name)
        if c is not None:
            c.inc(n)

    def set_gauge(self, name: str, value: float, label: str = "") -> None:
        with self._lock:
            self.gauges[(name, label)] = value
        g = self._prom_gauges.get(name)
        if g is not None:
            g.set(value)


def count_detached_callback(metrics, message: str) -> None:
    """The count-and-warn tail of every streaming-callback isolation site
    (the engine's ``on_token`` and ``on_retire``): the caller has already
    detached the raising callback; this counts it on ``callback_errors``
    (when a metrics sink is attached) and warns with the site's message."""
    if metrics is not None:
        metrics.inc("callback_errors")
    warnings.warn(message, stacklevel=3)


def _escape_label(v: str) -> str:
    """Label-value escaping per the exposition format: backslash first,
    then double quote, then newline."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """HELP-text escaping: backslash and newline (quotes are legal)."""
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Sample values as prometheus_client renders them (integers carry a
    trailing ``.0``)."""
    return repr(float(v))


def _mirror_entries(mirror: dict, name: str):
    """All (label_value, value) pairs of family ``name`` in a mirror dict
    keyed by plain names or ``(name, label)`` tuples, sorted by label."""
    out = []
    for key, val in mirror.items():
        mname, label = key if isinstance(key, tuple) else (key, "")
        if mname == name:
            out.append((label, val))
    return sorted(out, key=lambda kv: str(kv[0]))


def _bucket_exemplars(fam: _Family, exemplars) -> dict:
    """Bucket index → newest retained ``(value, trace_id)`` exemplar whose
    value falls in that bucket's ``(prev, bound]`` range; index
    ``len(buckets)`` is the ``+Inf`` bucket."""
    out: dict = {}
    bounds = fam.buckets or ()
    for value, trace_id in exemplars:     # oldest → newest: newest wins
        out[bisect.bisect_left(bounds, value)] = (value, trace_id)
    return out


def _exemplar_suffix(ex) -> str:
    """The OpenMetrics exemplar clause of a bucket sample,
    ``# {trace_id="..."} value`` (no timestamp, so deterministic runs
    render byte-identical bodies)."""
    if ex is None:
        return ""
    value, trace_id = ex
    return f' # {{trace_id="{_escape_label(str(trace_id))}"}} {_fmt(value)}'


def render_text(metrics, *, openmetrics: bool = False) -> str:
    """Prometheus text format over the mirror dicts and the declared
    families: what ``exposition()`` returns without prometheus_client.
    Counter families carry the ``_total`` suffix, histograms render
    cumulative ``le`` buckets, ``_count`` and ``_sum``, and label values
    escape backslash, double quote and newline. ``openmetrics=True``
    renders the OpenMetrics dialect: counter ``# TYPE`` lines name the bare
    family, histogram buckets carry the retained exemplars, and the body
    ends with ``# EOF``."""
    with metrics._lock:
        counters = dict(metrics.counters)
        gauges = dict(metrics.gauges)
        hist_counts = dict(metrics.histogram_counts)
        hist_sums = dict(metrics.histogram_sums)
        bucket_counts = {k: list(v)
                         for k, v in metrics._bucket_counts.items()}
        exemplars = {k: list(v) for k, v in metrics.exemplars.items()}
    lines = []

    def sample(fname: str, fam: _Family, label, value) -> None:
        lbl = ""
        if fam.labels and label is not None:
            lbl = f'{{{fam.labels[0]}="{_escape_label(str(label))}"}}'
        lines.append(f"{fname}{lbl} {_fmt(value)}")

    for name, fam in metrics._families.items():
        if fam.kind == "counter":
            fname = (fam.full if fam.full.endswith("_total")
                     else fam.full + "_total")
            # OpenMetrics declares the family (no _total); samples keep it
            tname = fname[:-len("_total")] if openmetrics else fname
            lines.append(f"# HELP {tname} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {tname} counter")
            entries = _mirror_entries(counters, name)
            if not entries and not fam.labels:
                entries = [("", 0)]       # prom exports unlabeled at 0
            for label, val in entries:
                sample(fname, fam, label if fam.labels else None, val)
        elif fam.kind == "gauge":
            lines.append(f"# HELP {fam.full} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.full} gauge")
            entries = _mirror_entries(gauges, name)
            if not entries and not fam.labels:
                entries = [("", 0.0)]
            for label, val in entries:
                sample(fam.full, fam, label if fam.labels else None, val)
        else:
            lines.append(f"# HELP {fam.full} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {fam.full} histogram")
            slots = bucket_counts.get(name, [0])
            by_bucket = (_bucket_exemplars(fam, exemplars.get(name, ()))
                         if openmetrics else {})
            cum = 0
            for i, (bound, n) in enumerate(zip(fam.buckets or (), slots)):
                cum += n
                lines.append(f'{fam.full}_bucket{{le="{_fmt(bound)}"}} '
                             f"{_fmt(cum)}"
                             f"{_exemplar_suffix(by_bucket.get(i))}")
            cum += slots[-1]
            inf = _exemplar_suffix(by_bucket.get(len(fam.buckets or ())))
            lines.append(f'{fam.full}_bucket{{le="+Inf"}} {_fmt(cum)}{inf}')
            lines.append(f"{fam.full}_count "
                         f"{_fmt(hist_counts.get(name, 0))}")
            lines.append(f"{fam.full}_sum "
                         f"{_fmt(hist_sums.get(name, 0.0))}")
    if openmetrics:
        lines.append("# EOF")
    return "\n".join(lines) + "\n"


def exposition(metrics, *, openmetrics: bool = False) -> str:
    """The scrape body of a metrics instance (what ``serve()`` answers):
    prometheus_client's rendering when it imported, else ``render_text``
    over the mirrors, never an error. ``openmetrics=True`` is the
    exemplar-carrying dialect."""
    if _prom is not None and metrics.registry is not None:
        if openmetrics:
            from prometheus_client.openmetrics import (
                exposition as _om_exposition,
            )
            return _om_exposition.generate_latest(
                metrics.registry).decode()
        return _prom.generate_latest(metrics.registry).decode()
    return render_text(metrics, openmetrics=openmetrics)


def serve(metrics, port: int = 8443):
    """Answer ``GET /metrics`` on ``port`` with ``exposition(metrics)``
    from a stdlib ``ThreadingHTTPServer`` on a daemon thread, returned so
    the caller can ``shutdown()`` it. One server with or without
    prometheus_client: ``exposition`` already picks the client's rendering
    when it imported."""
    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self) -> None:
            if self.path.split("?")[0] != "/metrics":
                self.send_error(404)
                return
            body = exposition(metrics).encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args) -> None:   # no per-scrape stderr line
            pass

    server = http.server.ThreadingHTTPServer(("", port), Handler)
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="metrics-http").start()
    return server
