"""The vision models and BERT on a (data 2, fsdp 2) mesh, the port against
the JAX package, on the CPU.

One world of 4 spawned gloo ranks (``test_torch_mesh_train.start_world``)
runs every case; the JAX package runs the same cases on a (data 2, fsdp 2)
mesh over 4 of its 8 CPU devices, first, since the port's steps start from
its states. Inputs come from numpy seeds; weights are the JAX package's
initial ones, in fp32.

* ``resnet18ish`` (nesterov SGD) and ``MnistCNN`` (adam): at each of 3
  steps of the reference's ``ClassifierTrainer`` the port's
  ``ClassifierTrainer(rules=vision_partition_rules(), mesh=...)`` steps
  from the same state (parameters, running statistics and the optimizer's
  state laid out on the mesh) on its rank's rows: the loss and accuracy of
  the global batch, the gradients its optimizer steps on, the parameters
  and the statistics it leaves, as ``test_torch_vision.py`` holds them
  unsharded. The statistics cover the
  global batch (every BatchNorm sums over data and fsdp), so a rank's
  batch of 2 does not move them: dropping that sum fails this case.
* tiny BERT (``train/mlm.py``'s ``make_mlm_step``, the example's adamw,
  type ids and a padding mask): 5 free-running steps under
  ``bert_partition_rules`` (FSDP2 over data x fsdp), losses and final
  weights within ``FP32_TOL``.

This module imports no JAX at its top: its rank bodies run in spawned
processes that import it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_mesh_train import case_result, run_cases, start_world

torch.set_num_threads(1)

WORLD = 4
MESH = dict(data=2, fsdp=2)
VISION_STEPS = 3
BERT_STEPS = 5
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)

#: case → (model, images shape, classes, optimizer, adam's learning rate
#: or None for SGD)
VISION = {
    "resnet18ish_sgd": ("resnet", (8, 32, 32, 3), 4, "sgd", None),
    "mnist_adam": ("mnist", (8, 28, 28, 1), 10, "adam", 1e-3),
}


def record_grads(opt: torch.optim.Optimizer, model: torch.nn.Module
                 ) -> dict:
    """A dict that each ``opt.step()`` fills, before it steps, with
    ``model``'s whole gradients by parameter name (a ``DTensor``'s
    gathered: every rank of its mesh must step)."""
    seen = {}

    def hook(*_):
        for name, p in model.named_parameters():
            g = p.grad
            seen[name] = (g.full_tensor() if hasattr(g, "full_tensor")
                          else g).detach().clone()

    opt.register_step_pre_hook(hook)
    return seen


def _images(shape, classes, seed=5):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x, (np.arange(shape[0]) % classes).astype(np.int32)


def _bert_inputs(seed=3, b=8, l=32):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, l)).astype(np.int32)
    types = (np.arange(l)[None] >= rng.integers(4, l, (b, 1))).astype(
        np.int32)
    mask = np.ones((b, l), np.int32)
    mask[::3, 20:] = 0
    mlm = (rng.uniform(size=(b, l)) < 0.3).astype(np.float32)
    return tokens, types, mask, mlm


# ---- the rank bodies ---------------------------------------------------------

def _port_vision(kind: str):
    from tpu_on_k8s_torch.models import vision
    if kind == "resnet":
        return vision.ResNet(dataclasses.replace(
            vision.ResNetConfig.resnet18ish(4), dtype=torch.float32))
    return vision.MnistCNN(dtype=torch.float32)


def _vision_case(name: str, states) -> list:
    """Each step from the reference's state k: (loss, accuracy, the whole
    parameters and statistics it leaves)."""
    from torch.distributed.tensor import distribute_tensor

    from tpu_on_k8s_torch.models.params import load_module
    from tpu_on_k8s_torch.models.vision import vision_partition_rules
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.train import optimizer as popt
    from tpu_on_k8s_torch.train.vision import ClassifierTrainer

    kind, shape, classes, opt_kind, lr = VISION[name]
    x, y = _images(shape, classes)
    mesh = create_mesh(MeshConfig(**MESH), device="cpu")
    out = []
    for step, (variables, moments, count) in enumerate(states):
        # copies: the spawned ranks share the tensors they were handed
        model = load_module(_port_vision(kind),
                            {k: v.clone() for k, v in variables.items()},
                            "cpu")
        opt = (popt.SGD(model.parameters(), 0.1, momentum=0.9,
                        nesterov=True) if opt_kind == "sgd"
               else popt.adam(model.parameters(), lr))
        trainer = ClassifierTrainer(model, opt,
                                    rules=vision_partition_rules(),
                                    mesh=mesh)
        stepped_on = record_grads(opt, model)
        for p_name, p in model.named_parameters():
            for key, tree in moments.items():
                opt.state[p][key] = distribute_tensor(
                    tree[p_name].clone(), p.device_mesh, p.placements,
                    src_data_rank=None)
        opt.count = count
        state = trainer.init_state()
        images, labels = trainer.shard_batch(torch.from_numpy(x),
                                             torch.from_numpy(y).long())
        state, m = trainer.train_step(state, images, labels)
        out.append(dict(
            loss=m["loss"].item(), accuracy=m["accuracy"].item(),
            grads=stepped_on,
            params={n: p.full_tensor().detach().clone()
                    for n, p in model.named_parameters()},
            stats={n: b.clone() for n, b in model.named_buffers()}))
    return out


def _bert_case(params) -> dict:
    from tpu_on_k8s_torch.models import bert
    from tpu_on_k8s_torch.models.params import load_module
    from tpu_on_k8s_torch.parallel.mesh import (
        MeshConfig,
        batch_sharding,
        create_mesh,
        local_rows,
    )
    from tpu_on_k8s_torch.parallel.sharded import shard_model
    from tpu_on_k8s_torch.train import optimizer as popt
    from tpu_on_k8s_torch.train.mlm import make_mlm_step

    cfg = dataclasses.replace(bert.BertConfig.tiny(), dtype=torch.float32)
    model = load_module(bert.Bert(cfg),
                        {k: v.clone() for k, v in params.items()}, "cpu")
    mesh = create_mesh(MeshConfig(**MESH), device="cpu")
    shard_model(model, mesh, bert.bert_partition_rules())
    opt = popt.adamw(model.parameters(), popt.warmup_cosine_decay_schedule(
        0.0, 1e-4, 10, 11), weight_decay=0.01)
    step = make_mlm_step(model, opt, mesh)
    tokens, types, mask, mlm = (torch.from_numpy(a) for a in _bert_inputs())
    rows = batch_sharding(mesh, tuple(tokens.shape))
    batch = [local_rows(t, rows) for t in (tokens, mlm, types, mask)]
    losses = [step(*batch)["loss"].item() for _ in range(BERT_STEPS)]
    return dict(losses=losses,
                params={n: p.full_tensor().detach().clone()
                        for n, p in model.named_parameters()})


def _world(rank: int, world: int, vision_states, bert_params):
    cases = {name: (lambda n=name: _vision_case(n, vision_states[n]))
             for name in VISION}
    cases["bert"] = lambda: _bert_case(bert_params)
    return run_cases(rank, cases)


# ---- the parent: the JAX package's runs, the world, the comparisons ---------

def _flat(tree) -> dict:
    """A nested dict's leaves by dotted path, as fp32 tensors."""
    from tpu_on_k8s_torch.models.params import from_jax_variables
    return from_jax_variables({"params": tree}, "cpu")


def _reference_vision(name: str):
    """(the port's input states, the JAX package's results) of ``name``."""
    import jax
    import jax.numpy as jnp
    import optax

    from tpu_on_k8s.models import vision as jvision
    from tpu_on_k8s.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s.train.vision import ClassifierTrainer
    from tpu_on_k8s_torch.models.params import from_jax_variables

    from test_torch_vision import recorded_grads, recording

    kind, shape, classes, opt_kind, lr = VISION[name]
    model = (jvision.ResNet(dataclasses.replace(
        jvision.ResNetConfig.resnet18ish(4), dtype=jnp.float32))
        if kind == "resnet" else jvision.MnistCNN(dtype=jnp.float32))
    opt = (optax.sgd(0.1, momentum=0.9, nesterov=True) if opt_kind == "sgd"
           else optax.adam(lr))
    mesh = create_mesh(MeshConfig(model=1, seq=1, **MESH),
                       jax.devices()[:WORLD])
    trainer = ClassifierTrainer(model, jvision.vision_partition_rules(),
                                mesh, recording(opt))
    x, y = _images(shape, classes)
    xs, ys = trainer.shard_batch(jnp.asarray(x), jnp.asarray(y))
    state = trainer.init_state(jax.random.key(1), xs)
    inputs, results = [], []
    for step in range(VISION_STEPS):
        params, stats, opt_state = jax.tree.map(
            np.array, (state.params, state.batch_stats, state.opt_state))
        holder = opt_state[1][0]
        moments = ({"trace": _flat(holder.trace)} if opt_kind == "sgd" else
                   {"mu": _flat(holder.mu), "nu": _flat(holder.nu)})
        count = step if opt_kind == "sgd" else int(holder.count)
        inputs.append((from_jax_variables(
            {"params": params, "batch_stats": stats}, "cpu"), moments,
            count))
        state, m = trainer.train_step(state, xs, ys)
        results.append(dict(
            loss=float(m["loss"]), accuracy=float(m["accuracy"]),
            grads=recorded_grads(state.opt_state),
            params=_flat(jax.tree.map(np.asarray, state.params)),
            stats=from_jax_variables({"batch_stats": jax.tree.map(
                np.asarray, state.batch_stats)}, "cpu")))
    return inputs, results


def _reference_bert():
    import jax
    import jax.numpy as jnp
    import optax

    from tpu_on_k8s.models import bert as jbert
    from tpu_on_k8s.parallel.mesh import MeshConfig, batch_sharding
    from tpu_on_k8s.parallel.mesh import create_mesh
    from tpu_on_k8s.parallel.partition import named_sharding
    from tpu_on_k8s_torch.models.params import from_jax_bert_params

    cfg = dataclasses.replace(jbert.BertConfig.tiny(), dtype=jnp.float32)
    model = jbert.Bert(cfg)
    tokens, types, mask, mlm = _bert_inputs()
    params = model.init(jax.random.key(1), jnp.asarray(tokens))["params"]
    start = from_jax_bert_params(jax.tree.map(np.asarray, params), "cpu")
    mesh = create_mesh(MeshConfig(model=1, seq=1, **MESH),
                       jax.devices()[:WORLD])
    params = jax.device_put(params, named_sharding(
        params, mesh, jbert.bert_partition_rules()))
    sh = batch_sharding(mesh, tokens.shape)
    tokens, types, mask, mlm = (jax.device_put(jnp.asarray(a), sh)
                                for a in (tokens, types, mask, mlm))
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-4, 10, 11),
                      weight_decay=0.01)

    @jax.jit
    def step(params, opt_state):
        def loss_fn(p):
            return jbert.mlm_loss(model.apply({"params": p}, tokens, types,
                                              mask), tokens, mlm)
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    opt_state = opt.init(params)
    losses = []
    for _ in range(BERT_STEPS):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
    return start, dict(losses=losses, params=from_jax_bert_params(
        jax.tree.map(np.asarray, params), "cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's runs, then the port's world from their states."""
    vision = {name: _reference_vision(name) for name in VISION}
    bert_start, bert_want = _reference_bert()
    result = start_world(_world, ({n: v[0] for n, v in vision.items()},
                                  bert_start),
                         tmp_path_factory.mktemp("vision_mesh"),
                         world=WORLD)()
    return {n: v[1] for n, v in vision.items()}, bert_want, result


@pytest.mark.parametrize("case", list(VISION))
def test_classifier_steps_on_the_mesh_match_jax(case, runs):
    """Each step's loss and accuracy, the gradients the trainer's
    optimizer stepped on (summed over the mesh by FSDP2), the weights and
    the statistics it left, held as ``test_torch_vision.py`` holds them
    unsharded."""
    from test_torch_vision import (
        GRAD_ATOL,
        GRAD_RTOL,
        STATS_RTOL,
        adam_weight_atol,
        assert_within,
    )

    want_steps = runs[0][case]
    got_steps = case_result(runs[2], case)
    lr = VISION[case][4]
    for step, (got, want) in enumerate(zip(got_steps, want_steps)):
        assert abs(got["loss"] - want["loss"]) <= FP32_TOL["loss"], step
        assert got["accuracy"] == want["accuracy"], step
        assert set(got["grads"]) == set(want["grads"])
        for name, g in want["grads"].items():
            assert_within(got["grads"][name].numpy(), g.numpy(),
                          GRAD_RTOL * g.abs().max().item() + GRAD_ATOL,
                          f"step {step}: {name}'s gradient")
        for name, w in want["params"].items():
            assert_within(got["params"][name].numpy(), w.numpy(),
                          FP32_TOL["params"] if lr is None else
                          adam_weight_atol(want["grads"][name].numpy(), lr),
                          f"step {step}: {name}")
        assert set(got["stats"]) == set(want["stats"])
        for name, w in want["stats"].items():
            np.testing.assert_allclose(got["stats"][name].numpy(),
                                       w.numpy(), rtol=STATS_RTOL,
                                       atol=FP32_TOL["params"],
                                       err_msg=f"step {step}: {name}")


def test_bert_trajectory_on_the_mesh_matches_jax(runs):
    got = case_result(runs[2], "bert")
    want = runs[1]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=FP32_TOL["loss"], rtol=0)
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   atol=FP32_TOL["params"], rtol=0,
                                   err_msg=name)
