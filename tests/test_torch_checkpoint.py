"""The port's checkpoints (``tpu_on_k8s_torch/train/checkpoint.py``), its
training chaos, goodput accounting and device prefetch, on the CPU.

The reference's oracles run against the port: four cases of
``tests/test_checkpoint.py`` (round trip, newest generation, empty
directory, the agent's annotation protocol over the reference's in-memory
cluster), the training cases of ``tests/test_chaos.py`` (a preemption whose
save fails resumes from the periodic checkpoint bit for bit, a failed save
is survived and counted, an injected step failure raises its type),
``tests/test_slo.py::TestTrainingAccountant`` (``goodput_from_spans``
too) and the prefetch case of ``tests/test_plane_integration.py``. The
port's own: a ``tiny`` model's preempted-and-resumed run equals its
uninterrupted run bit for bit, an async save holds the state of its step
while the next step runs, and restores check shapes and dtypes. The mesh
cases of ``tests/test_checkpoint.py``: a ``TrainState`` saved by a
``Trainer`` on one mesh restores onto another (a spawned world of 4 gloo
ranks, ``test_torch_mesh_train.run_world``) with equal values and trains
there, and ``migrate_param_layout`` is exact both ways and agrees with the
reference's.
"""
from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from tpu_on_k8s.api.core import Container, ObjectMeta, PodSpec, PodTemplateSpec
from tpu_on_k8s.api.types import TaskSpec, TaskType, TPUJob, TPUJobSpec
from tpu_on_k8s.client import InMemoryCluster
from tpu_on_k8s_torch import chaos, constants
from tpu_on_k8s_torch.data import DataLoader, FixedRecordDataset, write_records
from tpu_on_k8s_torch.data.prefetch import device_prefetch
from tpu_on_k8s_torch.metrics import TrainMetrics
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.obs import TrainingAccountant, goodput_from_spans
from tpu_on_k8s_torch.train import (
    Trainer,
    default_optimizer,
    train_state_template,
)
from tpu_on_k8s_torch.train.checkpoint import (
    CheckpointAgent,
    CheckpointManager,
    load_params,
)
from tpu_on_k8s_torch.train.loop import TrainLoop

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

OPT = dict(warmup_steps=1, decay_steps=10)


@pytest.fixture(autouse=True)
def _no_injector():
    chaos.uninstall()
    yield
    chaos.uninstall()


def _trainer(seed=1, **changes):
    cfg = dataclasses.replace(TransformerConfig.tiny(), **changes)
    params = pparams.init_params(cfg, torch.Generator().manual_seed(seed),
                                 "cpu", dtype=torch.float32)
    model = pparams.load_model(cfg, params, "cpu")
    return cfg, Trainer(model, default_optimizer(model.parameters(), **OPT))


def _tokens(i, b=4, l=65):
    return torch.from_numpy(np.random.default_rng((0, i)).integers(
        0, 256, (b, l)).astype(np.int32))


@pytest.fixture(scope="module")
def setup():
    cfg, trainer = _trainer()
    state = trainer.state()
    trainer.train_step(state, _tokens(0))
    return cfg, trainer, state


def _states_equal(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k


def test_save_restore_roundtrip(tmp_path, setup):
    cfg, trainer, state = setup
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=1, generation=0)
    restored, gen, step = mgr.restore(train_state_template(cfg, "cpu",
                                                           **OPT))
    assert (gen, step) == (0, 1)
    _states_equal(state, restored)
    assert restored.step == state.step == 1
    assert restored.optimizer.count == state.optimizer.count == 1
    mgr.close()


def test_latest_prefers_highest_generation(tmp_path, setup):
    *_, state = setup
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=5, generation=0)
    mgr.save(state, step=3, generation=2)
    assert mgr.latest() == (2, 3)
    assert mgr.generations() == [0, 2]
    mgr.close()


def test_restore_empty_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(None)


def test_agent_protocol(tmp_path):
    """Controller requests a checkpoint via annotation → agent saves + acks."""
    cluster = InMemoryCluster()
    template = PodTemplateSpec(spec=PodSpec(containers=[Container(name="t",
                                                                  image="i")]))
    job = TPUJob(metadata=ObjectMeta(name="cj"),
                 spec=TPUJobSpec(tasks={TaskType.MASTER: TaskSpec(
                     num_tasks=1, template=template)}))
    cluster.create(job)

    saved = []
    agent = CheckpointAgent(cluster, "default", "cj", saved.append,
                            job_cls=TPUJob)
    assert agent.poll_once() is None  # nothing requested

    cluster.patch_meta(TPUJob, "default", "cj", annotations={
        constants.ANNOTATION_CKPT_REQUESTED_VERSION: "3"})
    assert agent.poll_once() == 3
    assert saved == [3]

    got = cluster.get(TPUJob, "default", "cj")
    assert got.metadata.annotations[
        constants.ANNOTATION_CKPT_COMPLETED_VERSION] == "3"
    # acknowledged request is not re-run
    assert agent.poll_once() is None
    assert saved == [3]


def test_max_to_keep_and_partial_restore(tmp_path, setup):
    """``max_to_keep`` prunes the oldest steps of a generation; a dict
    template reads only its keys (serving restores the parameters alone,
    ``load_params``, cast to the serving dtype, norm scales fp32)."""
    cfg, trainer, state = setup
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(state, step=step, wait=False)
    mgr.wait_until_finished()
    assert mgr.steps(0) == [2, 3]
    sub, _, _ = mgr.restore({"params": {"embed": torch.zeros(256, 64)}})
    assert torch.equal(sub["params"]["embed"], state.params["embed"])
    params, gen, step = load_params(str(tmp_path), "cpu", torch.bfloat16)
    assert (gen, step) == (0, 3) and set(params) == set(state.params)
    assert params["embed"].dtype == torch.bfloat16
    assert params["final_norm.scale"].dtype == torch.float32
    mgr.close()


def test_restore_checks_shapes_and_dtypes(tmp_path, setup):
    cfg, trainer, state = setup
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=1)
    with pytest.raises(ValueError, match="mu/embed"):
        mgr.restore(train_state_template(cfg, "cpu", mu_dtype=torch.bfloat16,
                                         **OPT))
    with pytest.raises(ValueError, match="embed"):
        mgr.restore({"params/embed": torch.zeros(8, 8)})
    with pytest.raises(ValueError, match="mesh and rules together"):
        mgr.restore(state, mesh=object())
    mgr.close()


def test_async_save_holds_its_step_while_training_goes_on(tmp_path):
    """``save(wait=False)`` captures step 2's state; steps 3 and 4, which
    update the parameters in place while the write is in flight, do not
    reach the file."""
    cfg, trainer = _trainer()
    state = trainer.state()
    for i in range(2):
        trainer.train_step(state, _tokens(i))
    at2 = {k: v.clone() for k, v in state.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, step=2, wait=False)
    for i in range(2, 4):
        trainer.train_step(state, _tokens(i))
    mgr.wait_until_finished()
    restored, _, _ = mgr.restore(train_state_template(cfg, "cpu", **OPT))
    got = restored.state_dict()
    assert all(torch.equal(got[k], at2[k]) for k in at2)
    assert not torch.equal(got["params/embed"], state.params["embed"])
    mgr.close()


def test_tiny_preempted_run_resumes_bit_exact(tmp_path):
    """The port's ``tiny`` model under ``train_preemption(7)``: it stops
    with step 6 saved (and step 4's periodic save pruned, max_to_keep 1),
    a fresh template restores it, and steps 7-10 give the uninterrupted
    run's losses and final weights bit for bit."""
    steps, losses = 10, {}

    def recording(trainer, run):
        def step_fn(state, batch):
            state, m = trainer.train_step(state, batch)
            run[state.step] = m["loss"]
            return state, m
        return step_fn

    def batches(start):
        return (_tokens(i, 2, 33) for i in range(start, steps + 1))

    cfg, base = _trainer()
    base_state = base.state()
    TrainLoop(recording(base, losses.setdefault("base", {})), base_state,
              batches(1), log_every=4).run(steps)

    _, first = _trainer()
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1)
    with chaos.train_preemption(7).injector():
        r = TrainLoop(recording(first, losses.setdefault("resumed", {})),
                      first.state(), batches(1), log_every=4,
                      checkpoint_manager=mgr, checkpoint_every=4).run(steps)
    assert r.preempted and r.steps == 6 and r.checkpoints_enqueued == 2
    assert mgr.steps(0) == [6]
    state, _, step = mgr.restore(train_state_template(cfg, "cpu", **OPT))
    assert step == state.step == state.optimizer.count == 6
    resumed = Trainer(state.model, state.optimizer)
    TrainLoop(recording(resumed, losses["resumed"]), state,
              batches(step + 1), log_every=4).run(steps - step)
    mgr.close()
    assert losses["resumed"].keys() == losses["base"].keys()
    assert all(torch.equal(losses["resumed"][s], losses["base"][s])
               for s in losses["base"])
    _states_equal(state, base_state)


# ---- the training cases of tests/test_chaos.py -----------------------------

def _toy_train():
    def step_fn(state, batch):
        x, y = batch
        w = state["w"].detach().requires_grad_()
        loss = torch.mean((x @ w - y) ** 2)
        (grad,) = torch.autograd.grad(loss, w)
        return ({"w": state["w"] - 0.1 * grad,
                 "step": state["step"] + 1}, {"loss": loss.detach()})

    def init_state():
        return {"w": torch.zeros(4, 2), "step": torch.zeros((),
                                                            dtype=torch.int32)}

    def batches_from(start, seed=0):
        i = start
        while True:
            brng = np.random.default_rng((seed, i))
            yield (torch.from_numpy(brng.normal(size=(8, 4)).astype(
                np.float32)), torch.from_numpy(brng.normal(
                    size=(8, 2)).astype(np.float32)))
            i += 1

    return step_fn, init_state, batches_from


def test_injected_preemption_resumes_bit_exact(tmp_path):
    """Preemption notice at an injected step, the preemption-time save
    FAILS, resume falls back to the last periodic checkpoint, and the
    stitched loss trajectory equals the no-fault run bit for bit."""
    step_fn, init_state, batches_from = _toy_train()
    steps, preempt_at, every = 12, 8, 3
    base = TrainLoop(step_fn, init_state(), batches_from(1),
                     log_every=1).run(steps)
    base_losses = {s: float(h["loss"]) for s, h in base.history}

    mgr = CheckpointManager(str(tmp_path))
    inj = chaos.train_preemption(preempt_at, fail_save=True).injector()
    loop = TrainLoop(step_fn, init_state(), batches_from(1), log_every=1,
                     checkpoint_manager=mgr, checkpoint_every=every)
    with inj:
        first = loop.run(steps)
    assert first.preempted and first.steps == preempt_at - 1
    assert first.checkpoint_failures == 1

    restored, _, step = mgr.restore(init_state())
    assert step == ((preempt_at - 1) // every) * every   # periodic fallback
    resumed = TrainLoop(step_fn, restored, batches_from(step + 1),
                        log_every=1).run(steps - step)
    mgr.close()
    stitched = {s: float(h["loss"]) for s, h in first.history}
    stitched.update({s + step: float(h["loss"])
                     for s, h in resumed.history})
    assert stitched == base_losses, "resume must replay the exact trajectory"


def test_save_failure_is_survivable_and_counted(tmp_path):
    step_fn, init_state, batches_from = _toy_train()
    mgr = CheckpointManager(str(tmp_path))
    metrics = TrainMetrics()
    inj = chaos.FaultInjector([chaos.FaultRule(
        chaos.SITE_TRAIN_SAVE, chaos.on_call(1), chaos.SaveFailure())])
    loop = TrainLoop(step_fn, init_state(), batches_from(1), log_every=1,
                     checkpoint_manager=mgr, checkpoint_every=3,
                     metrics=metrics)
    with inj:
        result = loop.run(7)
    assert result.steps == 7, "a failed save must not stop training"
    assert result.checkpoint_failures == 1
    assert result.checkpoints_enqueued == 1          # step 6 landed
    assert metrics.counters["checkpoint_failures"] == 1
    assert mgr.latest() == (0, 6)
    mgr.close()


def test_injected_step_failure_raises_typed():
    step_fn, init_state, batches_from = _toy_train()
    inj = chaos.FaultInjector([chaos.FaultRule(
        chaos.SITE_TRAIN_STEP, chaos.on_call(3), chaos.StepFailure())])
    loop = TrainLoop(step_fn, init_state(), batches_from(1), log_every=1)
    with inj, pytest.raises(chaos.ChaosStepError):
        loop.run(10)


def test_failed_async_write_is_counted_at_the_drain(tmp_path, monkeypatch):
    """A save whose background write fails surfaces at the loop's drain as
    a checkpoint failure; the run keeps its state."""
    from tpu_on_k8s_torch.train import checkpoint as ckpt

    def full_disk(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.dcp, "save", full_disk)
    step_fn, init_state, batches_from = _toy_train()
    metrics = TrainMetrics()
    result = TrainLoop(step_fn, init_state(), batches_from(1), log_every=1,
                       checkpoint_manager=CheckpointManager(str(tmp_path)),
                       checkpoint_every=2, metrics=metrics).run(4)
    assert result.steps == 4 and result.checkpoints_enqueued == 2
    assert result.checkpoint_failures == 1
    assert metrics.counters["checkpoint_failures"] == 1
    assert float(result.state["step"]) == 4


# ---- tests/test_slo.py::TestTrainingAccountant -----------------------------

class TestTrainingAccountant:
    def test_scripted_preemption_trace_hand_computed(self):
        # 14 steps, preempt at 9 (so 8 complete), checkpoint every 3, the
        # preemption save FAILS -> resume falls back to checkpoint 6 and
        # re-executes steps 7..8 before novel work resumes.
        m = TrainMetrics()
        acct = TrainingAccountant(metrics=m)
        for step in range(1, 9):               # first incarnation, 1s/step
            acct.window(step, 1, 1.0)
        acct.run_complete(9.0, preempted=True)  # 1s preemption drain
        acct.resume(6)
        for step in range(1, 9):               # resumed: local 1..8 ->
            acct.window(step, 1, 1.0)          # global 7..14
        acct.run_complete(8.5)                  # 0.5s restart overhead
        s = acct.summary()
        assert s["productive_s"] == pytest.approx(14.0)   # 14 novel steps
        assert s["waste_s"]["replay"] == pytest.approx(2.0)   # steps 7,8
        assert s["waste_s"]["preempt"] == pytest.approx(1.0)
        assert s["waste_s"]["overhead"] == pytest.approx(0.5)
        assert s["preemptions"] == 1
        assert s["goodput_fraction"] == pytest.approx(14.0 / 17.5)
        assert m.gauges["goodput_fraction"] == pytest.approx(
            s["goodput_fraction"])

    def test_train_loop_integration_preempt_resume(self):
        step_fn, init_state, _ = _toy_train()

        def batches_from(start):
            i = start
            while True:
                rng = np.random.default_rng((7, i))
                yield (torch.from_numpy(rng.normal(size=(8, 4)).astype(
                    np.float32)), torch.from_numpy(rng.normal(
                        size=(8, 2)).astype(np.float32)))
                i += 1

        steps, preempt_at, every = 14, 9, 3
        metrics = TrainMetrics()
        acct = TrainingAccountant(metrics=metrics)
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            inj = chaos.train_preemption(preempt_at, fail_save=True,
                                         seed=7).injector()
            loop = TrainLoop(step_fn, init_state(), batches_from(1),
                             log_every=1, checkpoint_manager=mgr,
                             checkpoint_every=every, accountant=acct)
            with inj:
                first = loop.run(steps)
            assert first.preempted and first.steps == preempt_at - 1
            restored, _gen, step = mgr.restore(init_state())
            assert step == 6
            acct.resume(step)
            TrainLoop(step_fn, restored, batches_from(step + 1),
                      log_every=1, checkpoint_manager=mgr,
                      checkpoint_every=every,
                      accountant=acct).run(steps - step)
            mgr.close()
        s = acct.summary()
        assert s["preemptions"] == 1
        # steps 7,8 re-executed after the fallback resume: replay waste
        assert s["waste_s"]["replay"] > 0
        assert s["steps_accounted"] == steps
        assert 0 < s["goodput_fraction"] < 1
        assert metrics.gauges["goodput_fraction"] == pytest.approx(
            s["goodput_fraction"])


    def test_goodput_from_spans(self):
        spans = [
            {"name": "train.window", "start": 0.0, "end": 4.0,
             "attrs": {"steps": 4, "step_seconds": 1.0}},
            {"name": "train.window", "start": 6.0, "end": 10.0,
             "attrs": {"steps": 4, "step_seconds": 1.0}},
            {"name": "request", "start": 0.0, "end": 1.0},   # ignored
        ]
        g = goodput_from_spans(spans)
        assert g["windows"] == 2
        assert g["productive_s"] == pytest.approx(8.0)
        assert g["gap_s"] == pytest.approx(2.0)
        assert g["goodput_fraction"] == pytest.approx(0.8)
        assert goodput_from_spans([])["goodput_fraction"] is None

    def test_goodput_of_a_loops_window_spans(self):
        """The port's loop's own spans feed ``goodput_from_spans``: one
        window a sync, each carrying its steps and step time."""
        from tpu_on_k8s_torch.obs import Tracer
        step_fn, init_state, batches_from = _toy_train()
        tracer = Tracer()
        TrainLoop(step_fn, init_state(), batches_from(1), log_every=2,
                  tracer=tracer).run(6)
        g = goodput_from_spans(tracer.export())
        assert g["windows"] == 3 and 0 < g["goodput_fraction"] <= 1


# ---- tests/test_plane_integration.py: device_prefetch -----------------------

def test_device_prefetch_feeds_train_step(tmp_path):
    """Native loader → device_prefetch → LM train step."""
    path = tmp_path / "tokens.bin"
    rng = np.random.default_rng(0)
    write_records(str(path), rng.integers(0, 256, (256, 65), dtype=np.int32))
    ds = FixedRecordDataset(str(path), record_shape=(65,), dtype=np.int32)
    loader = DataLoader(ds, batch_size=8, seed=1)
    _, trainer = _trainer()
    state = trainer.state()
    stream = device_prefetch(loader, "cpu", depth=2)
    for _ in range(3):
        batch = next(stream)
        assert isinstance(batch, torch.Tensor) and batch.shape == (8, 65)
        state, metrics = trainer.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"])) and state.step == 3
    loader.close()


def test_device_prefetch_keeps_depth_and_transform():
    """``depth`` batches are read ahead of the one yielded, and
    ``transform`` runs on each before it is placed."""
    pulled = []

    def source():
        for i in range(5):
            pulled.append(i)
            yield (np.full((2,), i, np.float32), np.array([i]))

    stream = device_prefetch(source(), "cpu", depth=2,
                             transform=lambda b: (b[0] * 2, b[1]))
    first = next(stream)
    assert pulled == [0, 1, 2]          # the yielded one and 2 ahead
    assert torch.equal(first[0], torch.tensor([0.0, 0.0]))
    rest = list(stream)
    assert [int(b[1]) for b in rest] == [1, 2, 3, 4]
    assert torch.equal(rest[-1][0], torch.tensor([8.0, 8.0]))


# ---- onto another mesh (test_checkpoint.py::test_restore_onto_different_mesh)

def _restore_onto_another_mesh(rank, world, tmp):
    from test_torch_mesh_train import run_cases
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh

    def case():
        cfg = dataclasses.replace(TransformerConfig.tiny(),
                                  dtype=torch.float32)
        rules = flagship_partition_rules()
        model = load_model(cfg, init_params(
            cfg, torch.Generator().manual_seed(0), "cpu", torch.float32),
            "cpu")
        mesh = create_mesh(MeshConfig(fsdp=4), device="cpu")
        trainer = Trainer(model, default_optimizer(model.parameters(), **OPT),
                          rules=rules, mesh=mesh)
        state = trainer.state()
        for i in range(2):
            trainer.train_step(state, trainer.shard_batch(_tokens(i)))
        saved = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                 for k, v in state.state_dict().items()}
        mgr = CheckpointManager(tmp)
        mgr.save(state, step=2, generation=1)
        new_mesh = create_mesh(MeshConfig(fsdp=2, model=2), device="cpu")
        template = train_state_template(cfg, "cpu", mesh=mesh, rules=rules,
                                        **OPT)
        restored, gen, step = mgr.restore(template, mesh=new_mesh,
                                          rules=rules)
        got = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
               for k, v in restored.state_dict().items()}
        wq = dict(restored.model.named_parameters())[
            "blocks.0.attn.wq.weight"]
        # the restored state trains on the new mesh
        new_trainer = Trainer(restored.model, restored.optimizer,
                              rules=rules, mesh=new_mesh)
        restored, m = new_trainer.train_step(
            restored, new_trainer.shard_batch(_tokens(2)))
        mgr.close()
        return dict(gen_step=(gen, step), keys=sorted(saved),
                    equal=sorted(k for k in saved
                                 if torch.equal(saved[k], got[k])),
                    wq=(tuple(wq.device_mesh.mesh_dim_names),
                        " ".join(map(str, wq.placements))),
                    loss=m["loss"].item(), count=new_trainer.optimizer.count)

    return run_cases(rank, {"case": case})


def test_restore_onto_different_mesh(tmp_path):
    """Elastic rescale: a checkpoint written on one mesh (fsdp 4) restores
    onto another (fsdp 2, model 2) with identical values, parameters,
    moments, count and step, and trains there."""
    from test_torch_mesh_train import case_result, run_world
    got = case_result(run_world(_restore_onto_another_mesh,
                                (str(tmp_path / "ckpt"),), tmp_path), "case")
    assert got["gen_step"] == (1, 2)
    assert got["equal"] == got["keys"]
    assert got["wq"] == (("fsdp", "model"), "S(1) S(0)")
    assert np.isfinite(got["loss"]) and got["count"] == 3


def test_migrate_param_layout_roundtrip_exact():
    """Unfused <-> fused migration is exact: a tiny tree gives identical
    logits through the fused config, the round trip restores it bit for
    bit, and the fused tree is the reference's migration carried across."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
    from tpu_on_k8s.train.checkpoint import (
        migrate_param_layout as jmigrate,
    )
    from tpu_on_k8s_torch.models.layouts import migrate_param_layout

    tok = np.random.default_rng(1).integers(0, 256, (2, 32)).astype(np.int32)
    jtree = JTransformer(JConfig.tiny()).init(
        jax.random.key(0), jnp.asarray(tok))["params"]
    cfg = dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float32)
    params = pparams.from_jax_params(jtree, torch.float32, "cpu")
    fused = migrate_param_layout(params, fused_qkv=True, fused_gateup=True)
    want = pparams.from_jax_params(
        jmigrate(jtree, fused_qkv=True, fused_gateup=True), torch.float32,
        "cpu")
    assert set(fused) == set(want)
    for k in want:
        assert torch.equal(fused[k], want[k]), k
    cfg_f = dataclasses.replace(cfg, fused_qkv=True, mlp_fused_gateup=True)
    with torch.no_grad():
        out0 = pparams.load_model(cfg, params, "cpu")(torch.from_numpy(tok))
        out_f = pparams.load_model(cfg_f, fused, "cpu")(torch.from_numpy(tok))
    assert torch.equal(out0, out_f)
    back = migrate_param_layout(fused, fused_qkv=False, fused_gateup=False)
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k]), k
