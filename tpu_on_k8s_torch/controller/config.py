"""Controller configuration: the counterpart of
``tpu_on_k8s/controller/config.py``.

Analog of the reference operator's controllers/common/config.go:26-44 (a pflag-set package
global there; an explicit dataclass threaded through constructors here — the
reference's hard-coded tunables from SURVEY §5.6 are surfaced as fields).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class JobControllerConfig:
    enable_gang_scheduling: bool = True
    max_concurrent_reconciles: int = 1
    sync_period_seconds: float = 30.0
    hostnetwork_port_range: Tuple[int, int] = (20000, 30000)
    model_image_builder: str = "gcr.io/kaniko-project/executor:latest"

    # Surfaced tunables (hard-coded in the reference — SURVEY §5.6):
    coordinator_period_seconds: float = 0.1        # plugins/registry.go:27
    quota_assume_ttl_seconds: float = 60.0         # plugins/quota.go:48
    elastic_loop_period_seconds: float = 30.0      # elastictorchjob_controller.go:60
    elastic_metric_count: int = 5
    # Profiling hooks (tpu_on_k8s_torch/utils/profiling.py): when set, the
    # TorchJob reconciler injects TPU_ON_K8S_PROFILE_DIR /
    # TPU_ON_K8S_PROFILER_PORT into every slice-host pod and `train/loop.py`
    # activates trace capture / the live profiler server. Empty/zero (the default) injects
    # nothing — behavior-neutral.
    profile_dir: str = ""
    profiler_port: int = 0
    # Serving autoscaler (controller/fleetautoscaler.py): tick period,
    # scrapes aggregated per observation window, consecutive dead scrapes
    # before the signal is stale (hold, don't scale), and the pod-log tail
    # depth the out-of-process signal source reads per tick.
    serving_autoscale_period_seconds: float = 15.0
    autoscale_window_scrapes: int = 4
    autoscale_stale_scrapes: int = 3
    autoscale_log_tail: int = 20
    # Time-based staleness on the scrape window (autoscale/signals.py
    # SignalAggregator max_age_s): samples older than this stop
    # contributing, so a clock jump past the whole window surfaces as
    # STALE instead of acting on ancient data. 0 derives the default —
    # stale_scrapes worth of tick periods; negative disables aging.
    autoscale_signal_max_age_s: float = 0.0
    # Consecutive autoscaler ticks tolerating Pending pods at a grown size
    # before reverting (the reference polls up to 1min, elastic_scale.go:440).
    elastic_pending_grace_ticks: int = 2
    # Reconcile passes the elastic controller HOLDS the world for a
    # pending live-reshard ack before giving up (the pod-side agent died
    # mid-transform without clearing the request): past this, the
    # request is withdrawn and the cold checkpoint-restart path runs.
    # Pass-counted in controller memory, not clock-based — deterministic.
    reshard_hold_max_passes: int = 40
    failover_concurrency: int = 50                 # failover.go semaphore widths
    # One dead host kills its slice's collective program — restart the
    # slice's surviving workers together (SURVEY §5.3).
    slice_atomic_failover: bool = True
    scale_concurrency: int = 100                   # elastic_scale.go:258
    victim_cleanup_concurrency: int = 10           # elastic_scale.go:492
    expectation_ttl_seconds: float = 300.0
