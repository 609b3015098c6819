"""The port's training loop (``tpu_on_k8s_torch/train/loop.py``), its FLOP
count and ``Trainer.fit``, on the CPU.

The reference's oracles of ``tests/test_train_loop.py`` run against the
port on toy torch steps: the sync cadence (at most ⌈steps/log_every⌉ host
copies, counted by wrapping the loop module's one host-copy point),
backpressure by device waits, non-blocking checkpoints drained at exit and
on preemption, the watchdog, the metrics feed, the profiling hooks and the
window spans. The XLA-only cases (the compilation cache, the perf env, a
backend without cost analysis) are replaced: the port leaves ``os.environ``
as the user set it, and ``train_step_flops`` on ``tiny`` equals the
analytic count of the model's products. Against the JAX package: 6 steps of
``TrainLoop`` in both packages from the same weights and batches agree
window for window within ``tests/test_torch_train_step.py``'s fp32
tolerances, and a JAX state stopped at step 3, carried across by
``from_jax_train_state``, continues to JAX's steps 4-6 within them.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_on_k8s_torch.train.loop as loop_mod
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s.train import trainer as jtrainer
from tpu_on_k8s.train.loop import TrainLoop as JTrainLoop
from tpu_on_k8s_torch import constants
from tpu_on_k8s_torch.metrics import TrainMetrics
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.obs import NOOP, Tracer
from tpu_on_k8s_torch.train import Trainer, default_optimizer
from tpu_on_k8s_torch.train.compile import (
    analytic_train_flops,
    train_step_flops,
)
from tpu_on_k8s_torch.train.loop import LoopResult, TrainLoop

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

# fp32 end to end, the tolerances of tests/test_torch_train_step.py: the
# packages differ only in summation order (losses within 9.5e-7, weights
# after five steps within 2.8e-7, measured there)
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _toy_step(state, batch):
    return ({"x": state["x"] + batch.sum()},
            {"loss": batch.mean(), "step": state["x"]})


def _toy_state():
    return {"x": torch.zeros((), dtype=torch.float32)}


def _repeat(x):
    while True:
        yield x


def _batches():
    return _repeat(torch.ones(4))


@pytest.fixture()
def sync_counter(monkeypatch):
    """Count host transfers by wrapping THE host-transfer point."""
    calls = {"host": 0, "device": 0}
    real_sync, real_wait = loop_mod._host_sync, loop_mod._device_wait

    def counting_sync(tree):
        calls["host"] += 1
        return real_sync(tree)

    def counting_wait(tree):
        calls["device"] += 1
        return real_wait(tree)

    monkeypatch.setattr(loop_mod, "_host_sync", counting_sync)
    monkeypatch.setattr(loop_mod, "_device_wait", counting_wait)
    return calls


class TestSyncCadence:
    def test_at_most_ceil_steps_over_log_every_host_syncs(self, sync_counter):
        loop = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=3)
        result = loop.run(10)
        assert result.steps == 10
        assert result.host_syncs == 4          # ceil(10/3)
        assert sync_counter["host"] == 4
        assert [s for s, _ in result.history] == [3, 6, 9, 10]
        # window metrics are host floats, not tensors
        assert isinstance(result.last_metrics["loss"], float)

    def test_single_sync_when_log_every_covers_run(self, sync_counter):
        result = TrainLoop(_toy_step, _toy_state(), _batches(),
                           log_every=50).run(20)
        assert result.host_syncs == 1 and sync_counter["host"] == 1

    def test_exhausted_batches_sync_partial_window(self, sync_counter):
        batches = iter([torch.ones(4)] * 5)
        result = TrainLoop(_toy_step, _toy_state(), batches,
                           log_every=4).run(100)
        assert result.steps == 5
        assert [s for s, _ in result.history] == [4, 5]

    def test_on_metrics_callback_sees_host_values(self):
        seen = []
        TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                  on_metrics=lambda step, m, dt: seen.append((step, m, dt))
                  ).run(4)
        assert [s for s, _, _ in seen] == [2, 4]
        assert all(isinstance(m["loss"], float) for _, m, _ in seen)
        assert all(dt > 0 for _, _, dt in seen)


class TestBoundedDispatch:
    def test_backpressure_uses_device_waits_not_host_syncs(self, sync_counter):
        loop = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=10,
                         max_inflight=2)
        result = loop.run(10)
        # steps 3..10 each push pending past 2: 8 backpressure waits, plus 1
        # drain wait at the window sync; the host sync count is untouched
        assert sync_counter["device"] == 9
        assert result.host_syncs == 1 and sync_counter["host"] == 1

    def test_default_bound_adds_no_waits_beyond_window_drain(self, sync_counter):
        result = TrainLoop(_toy_step, _toy_state(), _batches(),
                           log_every=5).run(10)
        # each window drains its pending steps with device waits and copies
        # only the last to the host: exactly steps - syncs waits
        assert sync_counter["device"] == 10 - result.host_syncs
        assert result.host_syncs == 2 == sync_counter["host"]

    def test_bad_config_rejected(self):
        with pytest.raises(ValueError):
            TrainLoop(_toy_step, _toy_state(), _batches(), log_every=0)
        with pytest.raises(ValueError):
            TrainLoop(_toy_step, _toy_state(), _batches(), max_inflight=0)


class _FakeManager:
    """Records the CheckpointManager calls the loop makes."""

    def __init__(self):
        self.events = []

    def save(self, state, *, step, generation=0, wait=True):
        self.events.append(("save", step, generation, wait))

    def wait_until_finished(self):
        self.events.append(("drain",))


class TestAsyncCheckpoints:
    def test_saves_enqueue_nonblocking_and_drain_at_exit(self):
        mgr = _FakeManager()
        result = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=3,
                           checkpoint_manager=mgr, checkpoint_every=2,
                           generation=7).run(5)
        saves = [e for e in mgr.events if e[0] == "save"]
        assert [s[1] for s in saves] == [2, 4]
        assert all(s[2] == 7 and s[3] is False for s in saves)
        assert mgr.events[-1] == ("drain",)
        assert result.checkpoints_enqueued == 2

    def test_preemption_saves_stopping_point_then_drains(self, sync_counter):
        mgr = _FakeManager()
        fired = {"n": 0}

        def preempted():
            fired["n"] += 1
            return fired["n"] > 3          # notice arrives before step 4

        result = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=10,
                           checkpoint_manager=mgr, checkpoint_every=100,
                           preemption_signal=preempted).run(10)
        assert result.preempted and result.steps == 3
        # the partial window synced before the final save
        assert [s for s, _ in result.history] == [3]
        assert mgr.events == [("save", 3, 0, False), ("drain",)]

    def test_stop_requests_clean_preemption(self):
        mgr = _FakeManager()
        loop = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                         checkpoint_manager=mgr,
                         on_metrics=lambda step, m, dt:
                             loop.stop() if step >= 4 else None)
        result = loop.run(100)
        assert result.preempted and result.steps == 4
        assert mgr.events[-2:] == [("save", 4, 0, False), ("drain",)]


class TestWatchdog:
    def test_stalled_step_fires_structured_event(self):
        events = []
        metrics = TrainMetrics(registry=None)

        def slow_step(state, batch):
            time.sleep(0.5)                # an artificially hung step
            return state, {"loss": torch.tensor(1.0)}

        TrainLoop(slow_step, _toy_state(), _batches(), log_every=1,
                  stall_timeout=0.1, on_stall=events.append,
                  metrics=metrics).run(2)
        assert events, "watchdog never fired on a stalled step"
        ev = events[0]
        assert ev["event"] == "stalled_step"
        # the watchdog fires once the unrounded gap exceeds the timeout and
        # reports the gap rounded to 3 decimals: at least the timeout
        assert ev["seconds_since_progress"] >= 0.1
        assert ev["stall_timeout"] == 0.1
        assert metrics.counters["stalled_steps"] >= 1

    def test_healthy_run_emits_no_stall_events(self):
        events = []
        TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                  stall_timeout=30.0, on_stall=events.append).run(6)
        assert events == []

    def test_long_window_with_per_step_progress_is_not_a_stall(self):
        """A window whose total time exceeds stall_timeout must not fire as
        long as each step's dispatch keeps returning: every dispatch feeds
        the heartbeat."""
        events = []

        def paced_step(state, batch):
            time.sleep(0.05)
            return state, {"loss": torch.tensor(1.0)}

        TrainLoop(paced_step, _toy_state(), _batches(), log_every=8,
                  stall_timeout=0.2, on_stall=events.append).run(8)
        # 8 steps x 0.05 s = 0.4 s window, twice the 0.2 s stall_timeout
        assert events == []

    def test_watchdog_thread_stops_with_loop(self):
        before = {t.name for t in threading.enumerate()}
        TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                  stall_timeout=5.0).run(4)
        lingering = [t for t in threading.enumerate()
                     if t.name == "trainloop-watchdog"
                     and t.name not in before]
        assert not lingering


class TestMetricsFeed:
    def test_gauges_fed_per_window(self):
        metrics = TrainMetrics(registry=None)
        TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                  metrics=metrics, tokens_per_step=64,
                  flops_per_step=1e6, peak_flops=1e9).run(4)
        assert metrics.counters["host_syncs"] == 2
        assert metrics.gauges["step_seconds"] > 0
        assert metrics.gauges["tokens_per_sec"] > 0
        assert metrics.gauges["steps_inflight"] == 2.0  # depth at window close
        assert metrics.gauges["mfu"] > 0


def _tiny_trainer(**changes):
    cfg = dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float32,
                              **changes)
    params = pparams.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", dtype=torch.float32)
    model = pparams.load_model(cfg, params, "cpu")
    return cfg, Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=1, decay_steps=10))


def _tokens(b, l, seed=1, vocab=256):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (b, l)).astype(np.int32))


class TestFlopCount:
    def test_train_step_flops_within_tolerance_of_6nt(self):
        """The exact count sits near the 6·N·T estimate: below it by about
        the embedding's share (a gather does no products), above it where
        attention counts; a units error would be off by orders."""
        cfg, trainer = _tiny_trainer(remat=False)
        batch, seqlen = 2, 32
        tokens = _tokens(batch, seqlen + 1)
        state = trainer.state()
        before = [p.detach().clone() for p in trainer.model.parameters()]
        flops, step_fn = train_step_flops(trainer, state, tokens)
        n = sum(p.numel() for p in trainer.model.parameters())
        assert 0.3 < flops / analytic_train_flops(n, batch * seqlen) < 1.7
        # counting changed nothing; the step function drives the loop
        assert all(torch.equal(a, b) for a, b in
                   zip(before, trainer.model.parameters()))
        assert state.step == 0
        result = TrainLoop(step_fn, state, _repeat(tokens),
                           log_every=2).run(2)
        assert np.isfinite(result.last_metrics["loss"])

    @pytest.mark.parametrize("remat_policy", ["mlp", "dots_kernels"])
    def test_train_step_flops_is_the_models_products(self, remat_policy):
        """The count is every product of the step, by hand: each dense
        layer's forward 2·T·in·out and its backward twice that (dx and dw),
        the fp32 head likewise, and each layer's flash forward, dq and
        dk/dv over the L(L+1)/2 causal pairs (2, 3 and 4 products of
        2·B·H·d a pair). Neither policy recomputes a product."""
        cfg, trainer = _tiny_trainer(remat=True, remat_policy=remat_policy,
                                     attn_impl="flash")
        b, l = 2, 32
        t = b * l
        d, hd = cfg.d_model, cfg.head_dim
        dense = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                 + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
        pairs = l * (l + 1) // 2
        want = (3 * 2 * t * (cfg.n_layers * dense + d * cfg.vocab_size)
                + cfg.n_layers * (4 + 6 + 8) * b * cfg.n_heads * hd * pairs)
        flops, _ = train_step_flops(trainer, trainer.state(),
                                    _tokens(b, l + 1))
        assert flops == want

    @pytest.mark.parametrize("shape", [dict(fsdp=1), dict(fsdp=1, model=1)],
                             ids=["fsdp", "fsdp_model"])
    def test_train_step_flops_on_a_world_1_mesh_is_the_meshless_count(
            self, shape):
        """F5: on a mesh of one rank (what the card runs) the count is the
        meshless step's exactly, the state is unchanged, and a
        ``TrainLoop`` fed with it sets its ``mfu`` gauge."""
        import torch.distributed as dist

        from tpu_on_k8s_torch.models.transformer import (
            flagship_partition_rules,
        )
        from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
        from tpu_on_k8s_torch.train.distributed import local_world

        tokens = _tokens(2, 33)
        _, plain = _tiny_trainer(attn_impl="flash")
        want, _ = train_step_flops(plain, plain.state(), tokens)
        assert local_world("cpu")
        try:
            cfg, trainer = _tiny_trainer(attn_impl="flash")
            trainer = Trainer(trainer.model, rules=flagship_partition_rules(),
                              mesh=create_mesh(MeshConfig(**shape),
                                               device="cpu"))
            state = trainer.state()
            before = [p.full_tensor().clone()
                      for p in trainer.model.parameters()]
            flops, step_fn = train_step_flops(trainer, state, tokens)
            assert flops == want
            assert all(torch.equal(a, b.full_tensor()) for a, b in
                       zip(before, trainer.model.parameters()))
            assert all(p.grad is None for p in trainer.model.parameters())
            metrics = TrainMetrics(registry=None)
            TrainLoop(step_fn, state, _repeat(tokens), log_every=2,
                      metrics=metrics, flops_per_step=flops,
                      peak_flops=1e12).run(2)
            assert metrics.gauges["mfu"] > 0
        finally:
            dist.destroy_process_group()

    def test_the_port_leaves_the_environment_as_the_user_set_it(
            self, monkeypatch):
        """The reference's compile-cache and libtpu flags have no eager
        counterpart: building a trainer, counting its FLOPs and running
        its loop set no environment variable and change none."""
        monkeypatch.setenv("LIBTPU_INIT_ARGS", "--mine=1")
        before = dict(os.environ)
        cfg, trainer = _tiny_trainer()
        tokens = _tokens(2, 17)
        state = trainer.state()
        _, step_fn = train_step_flops(trainer, state, tokens)
        trainer.fit(state, _repeat(tokens), 2, log_every=2)
        assert dict(os.environ) == before


class TestTrainerFit:
    def test_lm_trainer_fit_drives_loop(self, sync_counter):
        cfg, trainer = _tiny_trainer()
        tokens = _tokens(2, 17)
        state = trainer.state()
        result = trainer.fit(state, _repeat(tokens), 4, log_every=2)
        assert isinstance(result, LoopResult)
        assert result.host_syncs == 2 == sync_counter["host"]
        assert np.isfinite(result.last_metrics["loss"])
        assert result.state.step == 4 == trainer.optimizer.count


class TestProfilingHooksAndWindowSpans:
    """The ``utils/profiling.py`` hooks the loop activates (env-driven,
    fed by the operator's flags) and the ``train.window`` spans."""

    def _clear_env(self, monkeypatch):
        monkeypatch.delenv(constants.ENV_PROFILE_DIR, raising=False)
        monkeypatch.delenv(constants.ENV_PROFILER_PORT, raising=False)

    def test_env_flags_feed_profiling_config(self, monkeypatch):
        self._clear_env(monkeypatch)
        monkeypatch.setenv(constants.ENV_PROFILE_DIR, "/tmp/prof")
        monkeypatch.setenv(constants.ENV_PROFILER_PORT, "9999")
        loop = TrainLoop(_toy_step, _toy_state(), _batches())
        assert loop.profile_dir == "/tmp/prof"
        assert loop.profiler_port == 9999
        assert loop.annotate_steps is True      # rides along with capture

    def test_unset_env_is_behavior_neutral(self, monkeypatch):
        self._clear_env(monkeypatch)
        loop = TrainLoop(_toy_step, _toy_state(), _batches())
        assert loop.profile_dir is None
        assert loop.profiler_port is None
        assert loop.annotate_steps is False

    def test_profiling_session_activates_both_hooks(self, monkeypatch,
                                                    tmp_path):
        import contextlib
        self._clear_env(monkeypatch)
        calls = {"annotations": 0}

        @contextlib.contextmanager
        def fake_trace(d):
            calls["dir"] = d
            yield

        @contextlib.contextmanager
        def fake_annotate(name):
            assert name == "train.step"
            calls["annotations"] += 1
            yield

        monkeypatch.setattr(loop_mod.profiling, "start_server",
                            lambda port: calls.setdefault("port", port))
        monkeypatch.setattr(loop_mod.profiling, "trace", fake_trace)
        monkeypatch.setattr(loop_mod.profiling, "annotate", fake_annotate)
        loop = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                         profile_dir=str(tmp_path), profiler_port=8791)
        result = loop.run(4)
        assert result.steps == 4
        assert calls["port"] == 8791
        assert calls["dir"] == str(tmp_path)
        assert calls["annotations"] == 4        # one region per dispatch

    def test_profiling_failure_degrades_to_warning(self, monkeypatch):
        self._clear_env(monkeypatch)

        def boom(*a, **k):
            raise OSError("port in use")

        monkeypatch.setattr(loop_mod.profiling, "start_server", boom)
        monkeypatch.setattr(loop_mod.profiling, "trace", boom)
        metrics = TrainMetrics(registry=None)
        loop = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                         profile_dir="/nope", profiler_port=1,
                         metrics=metrics)
        with pytest.warns(UserWarning):
            result = loop.run(4)                # training survives
        assert result.steps == 4
        assert metrics.counters["profiling_failures"] == 2

    def test_window_spans_one_per_host_sync(self, monkeypatch):
        self._clear_env(monkeypatch)
        tracer = Tracer(time.monotonic)
        result = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                           tracer=tracer).run(5)
        windows = [s for s in tracer.export() if s["name"] == "train.window"]
        assert len(windows) == result.host_syncs == 3
        assert [w["attrs"]["start_step"] for w in windows] == [1, 3, 5]
        assert [w["attrs"]["step"] for w in windows] == [2, 4, 5]
        assert all(w["status"] == "ok" for w in windows)
        assert all(isinstance(w["attrs"].get("loss"), float)
                   for w in windows)

    def test_aborted_run_closes_open_window_span(self, monkeypatch):
        self._clear_env(monkeypatch)
        tracer = Tracer(time.monotonic)
        calls = {"n": 0}

        def failing_step(state, batch):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("device fell over")
            return _toy_step(state, batch)

        loop = TrainLoop(failing_step, _toy_state(), _batches(),
                         log_every=10, tracer=tracer)
        with pytest.raises(RuntimeError):
            loop.run(5)
        windows = [s for s in tracer.export() if s["name"] == "train.window"]
        assert len(windows) == 1
        assert windows[0]["status"] == "aborted"

    def test_no_tracer_is_neutral(self, monkeypatch):
        self._clear_env(monkeypatch)
        loop = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2)
        assert loop._tracer is NOOP
        assert loop.run(4).steps == 4

    def test_profiling_teardown_failure_degrades_to_warning(
            self, monkeypatch):
        import contextlib
        self._clear_env(monkeypatch)

        @contextlib.contextmanager
        def trace_fails_at_stop(d):
            yield
            raise OSError("disk full at trace stop")

        monkeypatch.setattr(loop_mod.profiling, "trace",
                            trace_fails_at_stop)
        loop = TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
                         profile_dir="/full")
        with pytest.warns(UserWarning, match="finalize"):
            result = loop.run(4)        # the trace writes at STOP: a full
        assert result.steps == 4        # disk must not eat the run


def test_torch_profiler_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    """The real hook: a run under ``profile_dir`` leaves a Chrome trace
    holding the ``train.step`` regions."""
    monkeypatch.delenv(constants.ENV_PROFILER_PORT, raising=False)
    TrainLoop(_toy_step, _toy_state(), _batches(), log_every=2,
              profile_dir=str(tmp_path)).run(2)
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1 and "train.step" in traces[0].read_text()


def test_reshard_signal_drives_a_live_reshard():
    """A ``ReshardNotice`` from ``reshard_signal`` moves the loop's state
    onto the notice's layout and the run goes on counting global steps
    (here on a world of one rank in this process;
    ``tests/test_torch_reshard.py`` holds the reference's cases on four)."""
    from torch.distributed.tensor import distribute_tensor

    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.parallel.partition import (
        PartitionRule,
        shard_pytree,
    )
    from tpu_on_k8s_torch.parallel.reshard import ReshardNotice
    from tpu_on_k8s_torch.train.distributed import local_world

    def step(state, batch):
        w = state["w"]
        return ({"w": distribute_tensor(w.full_tensor() + batch,
                                        w.device_mesh, w.placements,
                                        src_data_rank=None)},
                {"loss": batch.mean()})

    made = local_world("cpu")
    try:
        mesh = create_mesh(MeshConfig(), device="cpu")
        sharded = [PartitionRule("w", ("fsdp",))]
        state = shard_pytree({"w": torch.zeros(4)}, mesh, sharded)
        applied = []
        notice = ReshardNotice(mesh, sharded, mesh, [], tag="replicate",
                               on_applied=lambda: applied.append(True))
        calls = {"n": 0}

        def signal():
            calls["n"] += 1
            return notice if calls["n"] == 3 else None

        result = TrainLoop(step, state, _batches(), log_every=2,
                           reshard_signal=signal).run(6)
        assert result.steps == 6 and result.reshards == 1
        assert not result.reshard_fallback and applied == [True]
        assert [s for s, _ in result.history] == [2, 4, 6]
        assert torch.equal(result.state["w"].full_tensor(),
                           torch.full((4,), 6.0))
    finally:
        if made:
            torch.distributed.destroy_process_group()


# ---- against the JAX package ----------------------------------------------

def _jax_setup(**changes):
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32, **changes)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (4, 25)).astype(np.int32)
               for _ in range(6)]
    jparams = JTransformer(jcfg).init(jax.random.key(1),
                                      jnp.asarray(batches[0]))["params"]
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(JConfig)}
    fields["dtype"] = _DTYPES[jcfg.dtype]
    fields["param_dtype"] = _DTYPES[jcfg.param_dtype]
    return jcfg, TransformerConfig(**fields), jparams, batches


def _jax_loop(jcfg, jparams, batches, steps, log_every, **opt_kw):
    opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=6, **opt_kw)
    step = jtrainer.make_train_step(JTransformer(jcfg), opt)
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                                params=jparams, opt_state=opt.init(jparams))
    return JTrainLoop(step, state, iter(jnp.asarray(b) for b in batches),
                      log_every=log_every).run(steps)


def test_loop_windows_match_jax():
    """6 steps of TrainLoop in both packages, windows of 2: each window's
    loss and grad norm agree."""
    jcfg, pcfg, jparams, batches = _jax_setup()
    # a copy first: the JAX step donates the parameters' buffers
    tree = jax.tree.map(np.array, jparams)
    want = _jax_loop(jcfg, jparams, batches, 6, 2)
    model = pparams.load_model(pcfg, pparams.from_jax_params(
        tree, torch.float32, "cpu"), "cpu")
    trainer = Trainer(model, default_optimizer(model.parameters(),
                                               warmup_steps=2,
                                               decay_steps=6))
    got = trainer.fit(trainer.state(),
                      iter(torch.from_numpy(b) for b in batches), 6,
                      log_every=2)
    assert [s for s, _ in got.history] == [s for s, _ in want.history] == [
        2, 4, 6]
    for (_, g), (_, w) in zip(got.history, want.history):
        assert abs(g["loss"] - w["loss"]) <= FP32_TOL["loss"]
        assert abs(g["grad_norm"] - w["grad_norm"]) <= (
            FP32_TOL["grad_norm"] * w["grad_norm"])
        assert g["step"] == w["step"]


@pytest.mark.parametrize("moments", [None, "bf16"])
def test_from_jax_train_state_continues_the_jax_run(moments):
    """A JAX run stopped at step 3 continues in the port: its steps 4-6
    (losses, grad norms, and the weights after step 6) agree with the JAX
    run's, with fp32 or bf16 Adam moments."""
    jdt = jnp.bfloat16 if moments else None
    tdt = torch.bfloat16 if moments else None
    jcfg, pcfg, jparams, batches = _jax_setup()
    opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=6,
                                     mu_dtype=jdt, nu_dtype=jdt)
    step = jtrainer.make_train_step(JTransformer(jcfg), opt)
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                                params=jparams, opt_state=opt.init(jparams))
    want = []
    for i in range(6):
        if i == 3:
            # a copy: the step donates the state's buffers
            at3 = jax.tree.map(np.array, state)
        state, m = step(state, jnp.asarray(batches[i]))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    pstate = pparams.from_jax_train_state(
        pcfg, at3, "cpu", warmup_steps=2, decay_steps=6, mu_dtype=tdt,
        nu_dtype=tdt)
    assert pstate.step == 3 == pstate.optimizer.count
    trainer = Trainer(pstate.model, pstate.optimizer)
    got = trainer.fit(pstate, iter(torch.from_numpy(b)
                                   for b in batches[3:]), 3, log_every=1)
    for (_, g), (loss, norm) in zip(got.history, want[3:]):
        assert abs(g["loss"] - loss) <= FP32_TOL["loss"]
        assert abs(g["grad_norm"] - norm) <= FP32_TOL["grad_norm"] * norm
    final = pparams.from_jax_params(jax.tree.map(np.asarray, state.params),
                                    torch.float32, "cpu")
    for name, p in pstate.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   rtol=0, atol=FP32_TOL["params"])
