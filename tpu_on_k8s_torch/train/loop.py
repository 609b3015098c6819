"""The zero-stall step-driving loop: bounded async dispatch,
device-resident metrics, non-blocking checkpoints, a stalled-step
watchdog. The counterpart of ``tpu_on_k8s/train/loop.py``, with its
arguments, its ``step_fn(state, batch) -> (state, metrics)`` contract and
its bookkeeping.

* **Metrics stay on the device.** The loop holds each step's metrics (0-d
  tensors) unsynced and copies them to the host only every ``log_every``
  steps: one copy a window (``_host_sync``: one ``torch.stack`` of the
  window's last metrics, one ``.tolist()``), at most ⌈steps/log_every⌉
  over a run. The card runs a stream's work in order, so that copy waits
  for every earlier step: the window sync is also the window's clock.

* **Dispatch is bounded.** Past ``max_inflight`` unsynced steps the loop
  waits on the oldest one's CUDA event, recorded on the stream that ran
  the step just after it was dispatched (``_device_wait``): a wait on that
  step alone, not ``torch.cuda.synchronize()``, and not a host copy. On
  the CPU the wait returns at once.

* **Checkpoints are enqueued, not awaited.** ``checkpoint_every`` saves go
  through ``CheckpointManager.save(wait=False)`` (``train/checkpoint.py``:
  a device snapshot, then a writer thread); the loop drains with
  ``wait_until_finished`` only at exit and on a preemption notice
  (``preemption_signal``, ``stop()`` or the chaos site: a final save, the
  drain, a clean stop).

* **Hangs become events.** Past ``stall_timeout`` seconds without sync
  progress the watchdog thread emits one structured ``stalled_step`` event
  (a log line, ``on_stall``, the ``TrainMetrics`` counter) per stall.

* **A rescale is a transform, not a restart.** A ``reshard_signal``
  returning a ``ReshardNotice`` (``parallel/reshard.py``) makes the loop
  sync its window, drain pending saves, move the state onto the notice's
  mesh and rules, swap in the rebuilt step, and go on counting global
  steps (``LoopResult.reshards``). A transform that fails before any leaf
  moves (validation, an injected ``ReshardAbort``) leaves the state
  intact: the loop counts the fallback and leaves through the preemption
  path (``reshard_fallback``, ``preempted``).
"""
from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch

from tpu_on_k8s_torch import chaos, constants
from tpu_on_k8s_torch.obs.trace import ensure as ensure_tracer
from tpu_on_k8s_torch.utils import profiling
from tpu_on_k8s_torch.utils.logging import get_logger, kv

log = get_logger("train.loop")


class _Inflight:
    """A dispatched, unsynced step: its metrics and, when they live on a
    card, a CUDA event recorded on the step's stream just after dispatch."""

    __slots__ = ("metrics", "event")

    def __init__(self, metrics: Dict[str, Any]):
        self.metrics = metrics
        self.event = None
        for v in metrics.values():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                self.event = torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(v.device))
                break


def _host_sync(step: _Inflight) -> Dict[str, Any]:
    """THE host-transfer point: one device-to-host copy of a step's
    metrics. The one-element tensors are stacked (per device) and copied
    with one ``.tolist()``, which waits for the step and every step before
    it on its stream: the sync and the proof of progress. One-element
    values come back as Python floats, as the reference's. Module level so
    tests can count transfers by wrapping it."""
    host: Dict[str, Any] = {}
    by_device: Dict[torch.device, List[str]] = {}
    for k, v in step.metrics.items():
        if isinstance(v, torch.Tensor) and v.numel() == 1:
            by_device.setdefault(v.device, []).append(k)
        elif isinstance(v, torch.Tensor):
            host[k] = v.cpu()
        else:
            host[k] = float(v) if isinstance(v, (int, float)) else v
    for names in by_device.values():
        values = torch.stack([step.metrics[k].reshape(()).double()
                              for k in names]).tolist()
        host.update(zip(names, values))
    return {k: host[k] for k in step.metrics}


def _device_wait(step: _Inflight) -> None:
    """Bound the dispatch queue without a host copy: wait for one
    dispatched step to finish on the card (its event), and for nothing
    else. Returns at once for a step that ran on the CPU. Module level so
    tests can observe the backpressure path."""
    if step.event is not None:
        step.event.synchronize()


@dataclass
class LoopResult:
    """What a ``TrainLoop.run`` returns: final state plus the run's
    bookkeeping (every host-synced metrics window, in order)."""

    state: Any
    history: List[Tuple[int, Dict[str, Any]]] = field(default_factory=list)
    steps: int = 0
    host_syncs: int = 0
    checkpoints_enqueued: int = 0
    checkpoint_failures: int = 0
    seconds: float = 0.0
    preempted: bool = False
    reshards: int = 0
    reshard_fallback: bool = False

    @property
    def last_metrics(self) -> Dict[str, Any]:
        return self.history[-1][1] if self.history else {}


class TrainLoop:
    """Drive ``step_fn`` over ``batches`` with bounded async dispatch.

    Args:
      step_fn: ``(state, batch) -> (state, metrics)``, e.g. the step
        ``Trainer.fit`` drives (metrics: a dict of 0-d device tensors, or
        Python numbers).
      state: initial train state, passed through each step.
      batches: iterator/iterable of device-ready batches (pair with
        ``data/prefetch.py``'s ``device_prefetch`` so the host-to-device
        copy overlaps compute).
      log_every: steps per host sync window. The ONLY host transfers the
        loop performs happen at window boundaries (and the final partial
        window): ⌈steps/log_every⌉ total.
      max_inflight: cap on unsynced dispatched steps (default
        ``2*log_every``); enforced with a device wait, not a host transfer.
      checkpoint_manager / checkpoint_every / generation: enqueue
        ``manager.save(state, step=..., generation=..., wait=False)`` every
        N steps; drained at exit and on preemption.
      preemption_signal: polled once per step; returning True triggers
        final save + drain + clean stop (``LoopResult.preempted``).
      reshard_signal: the live-rescale sibling of ``preemption_signal``
        (``parallel/reshard.py``): polled once per step; a returned
        ``ReshardNotice`` makes the loop drain its window and pending
        saves, transform params and optimizer state onto the notice's
        (mesh, rules), swap in the rebuilt step and continue counting
        global steps: the run never exits. A transform that fails before
        any leaf moves leaves the state intact; the loop counts the
        fallback and exits through the preemption path, so the
        orchestrator's checkpoint-restart rescale takes over.
      reshard_metrics: optional ``ReshardMetrics``: reshards and fallback
        counters, bytes moved, the transform's pause.
      on_metrics: ``(step, metrics_dict, step_seconds)`` per sync window.
      on_stall / stall_timeout: watchdog — with ``stall_timeout > 0`` a
        daemon thread emits one structured stall event per episode when no
        sync progress happens for that long.
      metrics: optional ``TrainMetrics`` — step-time/tokens-per-sec/MFU
        gauges and sync/stall counters, fed at each window.
      tokens_per_step / flops_per_step / peak_flops: throughput/MFU gauge
        inputs (``flops_per_step`` from ``compile.train_step_flops``: on a
        mesh this rank's count, so ``peak_flops`` is one card's).
      tracer: optional ``obs.Tracer`` — one ``train.window`` span per
        host-sync window (step range, loss, step time).
      accountant: optional ``obs.account.TrainingAccountant`` — the
        goodput ledger: each sync window reports its (novel vs
        replayed) step time, and the run's close attributes the
        residual wall time as preempt/overhead waste; the accountant
        publishes the ``TrainMetrics`` ``goodput_fraction`` gauge. An
        orchestrator that restarts a preempted job calls
        ``accountant.resume(checkpoint_step)`` between incarnations so
        re-executed steps count as replay waste, not progress.
      profile_dir / profiler_port / annotate_steps: the
        ``utils/profiling.py`` hooks: a ``torch.profiler`` trace of the run
        written into ``profile_dir``, the live profiler server on
        ``profiler_port`` (PyTorch has none: that degrades to a warning and
        the ``profiling_failures`` counter), and each dispatched step
        wrapped in a ``train.step`` region (``record_function``) so the
        timeline is attributable. Defaults come from the
        ``TPU_ON_K8S_PROFILE_DIR`` / ``TPU_ON_K8S_PROFILER_PORT`` env the
        operator's ``--profile-dir``/``--profiler-port`` flags inject; unset
        (the default) is behavior-neutral.
    """

    def __init__(self, step_fn: Callable[[Any, Any], Tuple[Any, Dict]],
                 state: Any, batches: Iterable, *,
                 log_every: int = 10,
                 max_inflight: Optional[int] = None,
                 checkpoint_manager: Any = None,
                 checkpoint_every: int = 0,
                 generation: int = 0,
                 preemption_signal: Optional[Callable[[], bool]] = None,
                 reshard_signal: Optional[Callable[[], Optional[Any]]] = None,
                 reshard_metrics: Any = None,
                 on_metrics: Optional[Callable[[int, Dict, float], None]] = None,
                 on_stall: Optional[Callable[[Dict], None]] = None,
                 stall_timeout: float = 0.0,
                 metrics: Any = None,
                 tokens_per_step: int = 0,
                 flops_per_step: float = 0.0,
                 peak_flops: float = 0.0,
                 tracer: Any = None,
                 accountant: Any = None,
                 profile_dir: Optional[str] = None,
                 profiler_port: Optional[int] = None,
                 annotate_steps: Optional[bool] = None):
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        self.step_fn = step_fn
        self.state = state
        self.batches = batches
        self.log_every = log_every
        self.max_inflight = (2 * log_every if max_inflight is None
                             else max_inflight)
        if self.max_inflight < 1:
            raise ValueError(
                f"max_inflight must be >= 1, got {self.max_inflight}")
        self.checkpoint_manager = checkpoint_manager
        self.checkpoint_every = checkpoint_every
        self.generation = generation
        self.preemption_signal = preemption_signal
        self.reshard_signal = reshard_signal
        self.reshard_metrics = reshard_metrics
        self.on_metrics = on_metrics
        self.on_stall = on_stall
        self.stall_timeout = stall_timeout
        self.metrics = metrics
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        # observability: one ``train.window`` span per host-sync window
        # (``obs/trace.py``); the per-step timeline bridge is
        # ``utils/profiling.annotate`` below, not host-side spans: a span
        # per dispatched step would put host work on the zero-stall hot
        # path the loop exists to keep empty
        self._tracer = ensure_tracer(tracer)
        self._window_span: Any = None
        # goodput ledger (``obs/account.py``): fed from the quantities the
        # loop already measures, no new clock reads on the hot path, and
        # None is a strict no-op
        self.accountant = accountant
        # profiling hooks (``utils/profiling.py``): the operator's
        # ``--profile-dir``/``--profiler-port`` flags inject
        # ENV_PROFILE_DIR / ENV_PROFILER_PORT into pods, and the loop, the
        # one code path every trainer drives, reads them here
        if profile_dir is None:
            profile_dir = os.environ.get(constants.ENV_PROFILE_DIR) or None
        if profiler_port is None:
            raw = os.environ.get(constants.ENV_PROFILER_PORT, "")
            profiler_port = int(raw) if raw.strip().isdigit() else None
        self.profile_dir = profile_dir
        self.profiler_port = profiler_port or None
        # step annotation rides along whenever a trace is captured (the
        # named regions are what make the timeline attributable);
        # explicit True forces it for an externally-started trace
        self.annotate_steps = (annotate_steps if annotate_steps is not None
                               else profile_dir is not None)
        self._profiler_started = False

        self._should_stop = False
        self._running = False
        self._inflight = 0
        self._dispatched = 0
        self._heartbeat = time.perf_counter()
        self._stall_latched = False
        self._watchdog_stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None

    # ------------------------------------------------------------- control
    def stop(self) -> None:
        """Request a clean stop before the next dispatch (callback/signal
        safe). Treated like a preemption notice: final save + drain."""
        self._should_stop = True

    # ------------------------------------------------------------ watchdog
    def _touch(self) -> None:
        self._heartbeat = time.perf_counter()
        self._stall_latched = False

    def _watchdog_run(self) -> None:
        poll = max(min(self.stall_timeout / 4.0, 1.0), 0.01)
        while not self._watchdog_stop.wait(poll):
            if not self._running or self._stall_latched:
                continue
            gap = time.perf_counter() - self._heartbeat
            if gap <= self.stall_timeout:
                continue
            # one event per stall episode: latch until the next heartbeat
            self._stall_latched = True
            event = {"event": "stalled_step",
                     "step": self._dispatched,
                     "inflight": self._inflight,
                     "seconds_since_progress": round(gap, 3),
                     "stall_timeout": self.stall_timeout}
            kv(log, logging.WARNING, "stalled_step", **event)
            if self.metrics is not None:
                self.metrics.inc("stalled_steps")
            if self.on_stall is not None:
                self.on_stall(event)

    # ----------------------------------------------------------- profiling
    @contextlib.contextmanager
    def _profiling_session(self):
        """Activate the `utils/profiling.py` hooks for one ``run``: the
        live profiler server (tried once per loop, ever) and trace
        capture into ``profile_dir``. Either hook failing degrades to a
        warning (profiling must never take down training), and with
        neither configured this is a pass-through."""
        if self.profiler_port is not None and not self._profiler_started:
            self._profiler_started = True
            try:
                profiling.start_server(self.profiler_port)
            except Exception as e:  # noqa: BLE001 — no server, port taken
                if self.metrics is not None:
                    self.metrics.inc("profiling_failures")
                warnings.warn(f"profiler server on :{self.profiler_port} "
                              f"unavailable: {e}")
        if self.profile_dir is None:
            yield
            return
        capture = contextlib.ExitStack()
        try:
            capture.enter_context(profiling.trace(self.profile_dir))
        except Exception as e:  # noqa: BLE001
            if self.metrics is not None:
                self.metrics.inc("profiling_failures")
            warnings.warn(f"trace capture into {self.profile_dir} "
                          f"unavailable: {e}")
        try:
            yield
        finally:
            # the trace WRITES at stop — a full disk here must not eat a
            # run whose every training step succeeded
            try:
                capture.close()
            except Exception as e:  # noqa: BLE001
                if self.metrics is not None:
                    self.metrics.inc("profiling_failures")
                warnings.warn(f"trace capture into {self.profile_dir} "
                              f"failed to finalize: {e}")

    def _annotate_step(self):
        """Per-dispatch timeline region (``train.step``): the bridge that
        makes a captured trace attributable to loop steps. A plain
        nullcontext when annotation is off: nothing on the hot path."""
        return (profiling.annotate("train.step") if self.annotate_steps
                else contextlib.nullcontext())

    # ----------------------------------------------------------------- run
    def run(self, steps: int) -> LoopResult:
        """Drive ``steps`` training steps; returns the :class:`LoopResult`.
        Host syncs happen only at ``log_every`` windows (+ the final
        partial window); checkpoints drain before returning."""
        result = LoopResult(state=self.state)
        pending: collections.deque = collections.deque()
        batches = iter(self.batches)
        self._running = True
        self._touch()
        t0 = time.perf_counter()
        t_window = t0
        hooks = contextlib.ExitStack()
        try:
            hooks.enter_context(self._profiling_session())
            for i in range(1, steps + 1):
                # the chaos site is a second preemption source: a scheduled
                # PreemptNotice lands exactly like a SIGTERM-handler flag
                if self._should_stop or (self.preemption_signal is not None
                                         and self.preemption_signal()) or (
                        chaos.fire(chaos.SITE_TRAIN_PREEMPT, step=i)
                        is not None):
                    result.preempted = True
                    break
                if self.reshard_signal is not None:
                    notice = self.reshard_signal()
                    if notice is not None:
                        t_window = self._do_reshard(result, pending, notice,
                                                    t_window)
                        if result.reshard_fallback:
                            # the transform failed before any leaf moved:
                            # the state is the intact source; leave through
                            # the preemption path (final save + drain) and
                            # let the checkpoint-restart rescale take over
                            result.preempted = True
                            break
                try:
                    batch = next(batches)
                except StopIteration:
                    break
                step_fault = chaos.fire(chaos.SITE_TRAIN_STEP, step=i)
                if step_fault is not None:
                    raise step_fault.to_exception()
                if self._window_span is None:
                    # one span per host-sync window, closed by
                    # _sync_window: per-step host spans would put work on
                    # the zero-stall path; the profiler's timeline carries
                    # the per-step story via _annotate_step
                    self._window_span = self._tracer.start(
                        "train.window", start_step=i)
                with self._annotate_step():
                    self.state, step_metrics = self.step_fn(self.state,
                                                            batch)
                pending.append(_Inflight(step_metrics))
                self._dispatched = result.steps = i
                self._inflight = len(pending)
                # a returned dispatch is host progress; on a hung device
                # dispatches stop within max_inflight steps (backpressure or
                # the window sync blocks), so staleness still detects it
                self._touch()
                if i == 1 and self.stall_timeout > 0:
                    # arm the watchdog only once the first dispatch has
                    # returned: a first step may legitimately spend long
                    # building kernels and allocating, which must not read
                    # as a stall
                    self._watchdog_stop.clear()
                    self._watchdog = threading.Thread(
                        target=self._watchdog_run,
                        name="trainloop-watchdog", daemon=True)
                    self._watchdog.start()
                # backpressure: a device wait on the oldest unsynced step,
                # NOT a host transfer: the sync cadence is unaffected
                while len(pending) > self.max_inflight:
                    _device_wait(pending.popleft())
                    self._inflight = len(pending)
                    self._touch()
                if self.checkpoint_every and i % self.checkpoint_every == 0:
                    self._enqueue_save(result, i)
                if i % self.log_every == 0 or i == steps:
                    t_window = self._sync_window(result, pending, i, t_window)

            # still inside the watchdog's watch: the exit path can hang in
            # exactly the ways the loop body can (a wedged collective under
            # the partial-window sync, a stuck checkpoint drain) and must
            # surface as stall events too, not die silently
            if pending:
                # an early exit (preemption / stop / data end) leaves a
                # partial window in flight: surface it before saving
                self._sync_window(result, pending, result.steps, t_window)
            if result.preempted and self.checkpoint_manager is not None:
                # preemption notice: persist the exact stopping point, then
                # drain: the restarted pod resumes here instead of
                # replaying the window
                self._enqueue_save(result, result.steps)
            if self.checkpoint_manager is not None:
                try:
                    self.checkpoint_manager.wait_until_finished()
                except Exception as e:  # noqa: BLE001 — async save failed
                    # an async save that failed in the background surfaces
                    # here; the training that happened since is still real:
                    # record the failure, keep the state we computed
                    result.checkpoint_failures += 1
                    kv(log, logging.WARNING, "checkpoint_drain_failed",
                       error=f"{type(e).__name__}: {e}")
                    if self.metrics is not None:
                        self.metrics.inc("checkpoint_failures")
        finally:
            hooks.close()
            if self._window_span is not None:
                # an aborted run (chaos StepFailure, preemption between
                # dispatch and sync) leaves a window open — close it so
                # the dump shows where training stopped
                self._window_span.finish("aborted")
                self._window_span = None
            self._running = False
            if self._watchdog is not None:
                self._watchdog_stop.set()
                self._watchdog.join(timeout=5.0)
                self._watchdog = None
        result.state = self.state
        result.seconds = time.perf_counter() - t0
        if self.accountant is not None:
            # close the goodput ledger for this run: wall time the
            # windows didn't account (compile, checkpoint drains, the
            # preemption save) is waste, attributed by how the run ended
            self.accountant.run_complete(result.seconds,
                                         preempted=result.preempted)
        return result

    # ------------------------------------------------------------- reshard
    def _do_reshard(self, result: LoopResult, pending: collections.deque,
                    notice: Any, t_window: float) -> float:
        """Apply one live-reshard notice: sync the in-flight window, drain
        pending saves, transform the state and the step, continue. Returns
        the new window clock (the pause is accounted as ``reshard`` waste,
        never charged to the next window's step time). A failed transform
        sets ``result.reshard_fallback``; the state is then the intact
        source (every failure path fires before the first leaf moves)."""
        if pending:
            # pre-reshard steps are attributed at the pre-reshard cadence
            t_window = self._sync_window(result, pending, result.steps,
                                         t_window)
        if self.checkpoint_manager is not None:
            # a save of the old layout must finish before its tensors go
            try:
                self.checkpoint_manager.wait_until_finished()
            except Exception as e:  # noqa: BLE001 — as the exit drain
                result.checkpoint_failures += 1
                kv(log, logging.WARNING, "checkpoint_drain_failed",
                   error=f"{type(e).__name__}: {e}")
                if self.metrics is not None:
                    self.metrics.inc("checkpoint_failures")
        span = self._tracer.start("train.reshard", step=result.steps,
                                  **({"tag": notice.tag}
                                     if getattr(notice, "tag", "") else {}))
        t0 = time.perf_counter()
        try:
            new_state, new_step, plan = notice.apply(self.state, self.step_fn)
        except Exception as e:  # noqa: BLE001 — fall back, never corrupt
            result.reshard_fallback = True
            if self.reshard_metrics is not None:
                self.reshard_metrics.inc("reshard_fallbacks")
            kv(log, logging.WARNING, "reshard_fallback", step=result.steps,
               error=f"{type(e).__name__}: {e}")
            span.set(error=f"{type(e).__name__}: {e}")
            span.finish("aborted")
            self._notify_reshard(notice, "on_failed")
            return t_window
        dt = time.perf_counter() - t0
        self.state = new_state
        self.step_fn = new_step
        if getattr(notice, "generation", None) is not None:
            # later checkpoints land in the rescale's generation
            self.generation = notice.generation
        result.reshards += 1
        if self.accountant is not None:
            # a live-reshard pause is neither a restart nor a preemption
            self.accountant.pause("reshard", dt)
        if self.reshard_metrics is not None:
            self.reshard_metrics.inc("reshards")
            self.reshard_metrics.inc("bytes_moved", plan.bytes_moved)
            self.reshard_metrics.set_gauge("transform_seconds", dt)
        span.set(bytes_moved=plan.bytes_moved, leaves_moved=plan.n_moved,
                 seconds=round(dt, 6))
        span.finish()
        kv(log, logging.INFO, "reshard", step=result.steps,
           plan=plan.describe(), seconds=round(dt, 3))
        self._notify_reshard(notice, "on_applied")
        self._touch()
        return time.perf_counter()

    def _notify_reshard(self, notice: Any, hook: str) -> None:
        """Fire a notice's ack (``on_applied`` / ``on_failed``): a
        control-plane write whose failure must not kill a run whose
        transform already reached its outcome; warned and counted."""
        cb = getattr(notice, hook, None)
        if cb is None:
            return
        try:
            cb()
        except Exception as e:  # noqa: BLE001 — the run outlives its ack
            if self.reshard_metrics is not None:
                self.reshard_metrics.inc("reshard_ack_failures")
            kv(log, logging.WARNING, "reshard_ack_failed", hook=hook,
               error=f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------- windows
    def _sync_window(self, result: LoopResult, pending: collections.deque,
                     step: int, t_window: float) -> float:
        """One host transfer for the whole window: the last step's metrics
        (stream order on the card makes it wait for every prior step).
        Earlier steps are drained with device waits first so each completed
        step feeds the watchdog heartbeat — a long healthy window must not
        read as a stall; only a step that never completes does."""
        if self.metrics is not None:
            # unsynced dispatch depth at window close (the gauge's scrape
            # cadence is coarser than a step, so the window edge is the
            # meaningful sample point)
            self.metrics.set_gauge("steps_inflight", float(len(pending)))
        last = pending.pop()
        while pending:
            _device_wait(pending.popleft())
            self._inflight = len(pending) + 1
            self._touch()
        self._inflight = 0
        host = _host_sync(last)
        self._touch()
        now = time.perf_counter()
        result.host_syncs += 1
        window_steps = max(step - (result.history[-1][0]
                                   if result.history else 0), 1)
        step_seconds = (now - t_window) / window_steps
        result.history.append((step, host))
        loss = host.get("loss")
        kv(log, logging.INFO, "train_window", step=step,
           loss=(round(loss, 4) if isinstance(loss, float) else loss),
           step_ms=round(step_seconds * 1e3, 1))
        if self._window_span is not None:
            self._window_span.set(
                step=step, steps=window_steps,
                step_seconds=round(step_seconds, 6),
                **({"loss": round(loss, 6)}
                   if isinstance(loss, float) else {}))
            self._window_span.finish()
            self._window_span = None
        if self.accountant is not None:
            # novel steps are productive, re-executed ones (a resume
            # replaying past the last checkpoint) are replay waste —
            # the accountant tells them apart by the global step
            self.accountant.window(step, window_steps, step_seconds)
        if self.metrics is not None:
            m = self.metrics
            m.inc("host_syncs")
            m.set_gauge("step_seconds", step_seconds)
            if self.tokens_per_step:
                m.set_gauge("tokens_per_sec",
                            self.tokens_per_step / step_seconds)
            if self.flops_per_step and self.peak_flops:
                m.set_gauge("mfu", self.flops_per_step / step_seconds
                            / self.peak_flops)
        if self.on_metrics is not None:
            self.on_metrics(step, host, step_seconds)
        return now

    # --------------------------------------------------------- checkpoints
    def _enqueue_save(self, result: LoopResult, step: int) -> None:
        """Enqueue an async save. A FAILING save (full disk, revoked
        credentials, injected ``SaveFailure``) must not kill the run —
        training state is intact and the next cadence save gets a fresh
        chance; resume falls back to the last checkpoint that did land
        (the chaos soak proves the fallback reproduces the trajectory)."""
        try:
            fault = chaos.fire(chaos.SITE_TRAIN_SAVE, step=step)
            if fault is not None:
                raise fault.to_exception()
            self.checkpoint_manager.save(self.state, step=step,
                                         generation=self.generation,
                                         wait=False)
        except Exception as e:  # noqa: BLE001 — saves are best-effort
            result.checkpoint_failures += 1
            kv(log, logging.WARNING, "checkpoint_save_failed", step=step,
               error=f"{type(e).__name__}: {e}")
            if self.metrics is not None:
                self.metrics.inc("checkpoint_failures")
            return
        result.checkpoints_enqueued += 1
        if self.metrics is not None:
            self.metrics.inc("checkpoints_enqueued")
