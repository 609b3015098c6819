"""The vision models and BERT on meshes of 4, the port against the JAX
package, on the CPU.

One world of 4 spawned gloo ranks (``test_torch_mesh_train.start_world``)
runs every case; the JAX package runs the same cases on the same meshes
over 4 of its 8 CPU devices: the vision ones first, since the port's steps
start from their states, and BERT's while the world runs. Inputs come
from numpy seeds; weights are the JAX package's initial ones, in fp32.

* ``resnet18ish`` (nesterov SGD) and ``MnistCNN`` (adam): at each of 3
  steps of the reference's ``ClassifierTrainer`` the port's
  ``ClassifierTrainer(rules=vision_partition_rules(), mesh=...)`` steps
  from the same state (parameters, running statistics and the optimizer's
  state laid out on the mesh) on its rank's rows: the loss and accuracy of
  the global batch, the gradients its optimizer steps on, the parameters
  and the statistics it leaves, as ``test_torch_vision.py`` holds them
  unsharded. The statistics cover the
  global batch (every BatchNorm sums over data and fsdp), so a rank's
  batch of 2 does not move them: dropping that sum fails this case. On
  (data 2, fsdp 2), and ``resnet18ish`` on (fsdp 2, seq 2), where ``seq``
  is a replica axis: every rank of it steps the same rows, so a gradient
  (or a count, or a statistic) summed over it comes out twice the
  reference's and fails.
* tiny BERT (``train/mlm.py``'s ``make_mlm_step``, the example's adamw,
  type ids and a padding mask): 5 free-running steps under
  ``bert_partition_rules``, losses and final weights within ``FP32_TOL``:
  on (data 2, fsdp 2) (FSDP2), and on (fsdp 2, model 2) (tensor
  parallelism: 2 of the 4 heads a rank, ``embed``'s vocab split) and
  (fsdp 2, seq 2) (each rank a 16-token chunk of every row, attention
  gathered whole over ``seq``), each on the xla and the flash path.

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
SEQ_MESH = dict(fsdp=2, seq=2)
VISION_STEPS = 3
BERT_STEPS = 5
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)

#: case → (model, images shape, classes, optimizer, adam's learning rate
#: or None for SGD, mesh)
VISION = {
    "resnet18ish_sgd": ("resnet", (8, 32, 32, 3), 4, "sgd", None, MESH),
    "mnist_adam": ("mnist", (8, 28, 28, 1), 10, "adam", 1e-3, MESH),
    "resnet18ish_sgd_seq2": ("resnet", (8, 32, 32, 3), 4, "sgd", None,
                             SEQ_MESH),
}
#: BERT case → (mesh, config changes); the last runs 2 heads of 32 dims
#: on a model axis of 4, which cuts a head: q, k and v gathered whole
BERT = {"bert": (MESH, {})}
BERT.update({f"bert_{name}_{impl}": (shape, dict(attn_impl=impl))
             for name, shape in (("fsdp2_model2", dict(fsdp=2, model=2)),
                                 ("fsdp2_seq2", SEQ_MESH))
             for impl in ("xla", "flash")})
BERT["bert_model4_2heads"] = (dict(model=4), dict(n_heads=2))


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

    kind, shape, classes, opt_kind, lr, mesh_shape = VISION[name]
    x, y = _images(shape, classes)
    mesh = create_mesh(MeshConfig(**mesh_shape), device="cpu")
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


def _bert_case(name: str, params) -> dict:
    from tpu_on_k8s_torch.models import bert
    from tpu_on_k8s_torch.models.params import load_module
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.parallel.sharded import shard_model
    from tpu_on_k8s_torch.train import optimizer as popt
    from tpu_on_k8s_torch.train.mlm import make_mlm_step, mlm_rows

    shape, changes = BERT[name]
    cfg = dataclasses.replace(bert.BertConfig.tiny(), dtype=torch.float32,
                              **changes)
    model = load_module(bert.Bert(cfg),
                        {k: v.clone() for k, v in params.items()}, "cpu")
    mesh = create_mesh(MeshConfig(**shape), device="cpu")
    shard_model(model, mesh, bert.bert_partition_rules())
    opt = popt.adamw(model.parameters(), popt.warmup_cosine_decay_schedule(
        0.0, 1e-4, 10, 11), weight_decay=0.01)
    step = make_mlm_step(model, opt, mesh)
    tokens, types, mask, mlm = (torch.from_numpy(a) for a in _bert_inputs())
    batch = mlm_rows(mesh, tokens, mlm, types, mask)
    # the shape of the queries a rank runs: [rows, tokens, its heads' dims]
    seen = []
    model.blocks[0].wq.register_forward_hook(
        lambda mod, args, out: seen.append(tuple(out.shape)))
    losses = [step(*batch)["loss"].item() for _ in range(BERT_STEPS)]
    wq = dict(model.named_parameters())["blocks.0.wq.weight"]
    return dict(losses=losses,
                params={n: p.full_tensor().detach().clone()
                        for n, p in model.named_parameters()},
                wq_local=tuple(wq.to_local().shape), queries=seen[0][1:],
                own_heads=model.blocks[0].own_heads)


def _world(rank: int, world: int, vision_states, bert_params):
    cases = {name: (lambda n=name: _vision_case(n, vision_states[n]))
             for name in VISION}
    cases.update({name: (lambda n=name: _bert_case(n, bert_params))
                  for name in BERT})
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

    kind, shape, classes, opt_kind, lr, mesh_shape = VISION[name]
    model = (jvision.ResNet(dataclasses.replace(
        jvision.ResNetConfig.resnet18ish(4), dtype=jnp.float32))
        if kind == "resnet" else jvision.MnistCNN(dtype=jnp.float32))
    opt = (optax.sgd(0.1, momentum=0.9, nesterov=True) if opt_kind == "sgd"
           else optax.adam(lr))
    mesh = create_mesh(MeshConfig(**{"data": 1, "model": 1, "seq": 1,
                                     **mesh_shape}),
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


def _bert_start():
    """The JAX package's initial tiny BERT weights (fp32), as the JAX tree
    and as the port's."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models import bert as jbert
    from tpu_on_k8s_torch.models.params import from_jax_bert_params

    cfg = dataclasses.replace(jbert.BertConfig.tiny(), dtype=jnp.float32)
    params = jbert.Bert(cfg).init(jax.random.key(1), jnp.asarray(
        _bert_inputs()[0]))["params"]
    params = jax.tree.map(np.asarray, params)
    return params, from_jax_bert_params(params, "cpu")


def _reference_bert(name: str, params):
    import jax
    import jax.numpy as jnp
    import optax

    from tpu_on_k8s.models import bert as jbert
    from tpu_on_k8s.parallel.mesh import MeshConfig, batch_sharding
    from tpu_on_k8s.parallel.mesh import create_mesh
    from tpu_on_k8s.parallel.partition import named_sharding
    from tpu_on_k8s_torch.models.params import from_jax_bert_params

    shape, changes = BERT[name]
    cfg = dataclasses.replace(jbert.BertConfig.tiny(), dtype=jnp.float32,
                              **changes)
    model = jbert.Bert(cfg)
    tokens, types, mask, mlm = _bert_inputs()
    params = jax.tree.map(jnp.asarray, params)
    mesh = create_mesh(MeshConfig(**{"data": 1, "model": 1, "seq": 1,
                                     **shape}),
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
    return dict(losses=losses, params=from_jax_bert_params(
        jax.tree.map(np.asarray, params), "cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's vision runs, then the port's world from their
    states, while the JAX package runs BERT's cases."""
    vision = {name: _reference_vision(name) for name in VISION}
    bert_tree, bert_start = _bert_start()
    result = start_world(_world, ({n: v[0] for n, v in vision.items()},
                                  bert_start),
                         tmp_path_factory.mktemp("vision_mesh"),
                         world=WORLD)
    bert_want = {name: _reference_bert(name, bert_tree) for name in BERT}
    return {n: v[1] for n, v in vision.items()}, bert_want, result()


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


def _assert_bert_case(runs, case: str) -> dict:
    got = case_result(runs[2], case)
    want = runs[1][case]
    np.testing.assert_allclose(got["losses"], want["losses"],
                               atol=FP32_TOL["loss"], rtol=0)
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   atol=FP32_TOL["params"], rtol=0,
                                   err_msg=f"{case}: {name}")
    return got


def test_bert_trajectory_on_the_mesh_matches_jax(runs):
    _assert_bert_case(runs, "bert")


#: what a rank of each case runs: its queries' (tokens, columns) out of
#: ``wq``, its block of ``wq`` and whether it runs its own heads
BERT_RANK = {"fsdp2_model2": ((32, 32), (32, 32), True),
             "fsdp2_seq2": ((16, 64), (64, 32), True),
             "model4_2heads": ((32, 16), (16, 64), False)}


@pytest.mark.parametrize("case", [c for c in BERT if c != "bert"])
def test_bert_model_and_seq_axes_match_jax(case, runs):
    """Tiny BERT on (fsdp 2, model 2) and (fsdp 2, seq 2), xla and flash,
    and with 2 heads on (model 4): the losses and final weights of 5 steps
    against the JAX package's on the same mesh. On model 2 a rank runs 2
    of the 4 heads (32 of ``wq``'s 64 rows, split again over fsdp); on
    seq 2 every head of its 16 tokens; on model 4 its 16 rows cut a head
    of 32, so it runs every head on q, k and v gathered whole."""
    got = _assert_bert_case(runs, case)
    key = next(k for k in BERT_RANK if k in case)
    assert (got["queries"], got["wq_local"], got["own_heads"]) == \
        BERT_RANK[key]
