"""The vision models and ``ClassifierTrainer`` of the PyTorch port against
the JAX package, on the CPU.

``resnet18ish`` and ``MnistCNN`` in fp32 (and ``resnet18ish`` once in
bf16) are initialised by the JAX package and carried across with
``params.from_jax_variables``; inputs come from numpy seeds. Held against
the JAX package: ResNet-50's parameter count, the partition rules leaf for
leaf, the logits and the BatchNorm running statistics in train and eval
mode (every BatchNorm's scale, bias and statistics drawn from a seed: the
reference's zero ``bn3`` scale would leave each block's main branch out of
the logits), a stride-2 bottleneck at an even size (where flax pads a 3x3
window (0, 1)) and at an odd one, the stem's SAME max pool, the MNIST CNN's
(h, w, c) flatten, and 5-step ``ClassifierTrainer`` trajectories with adam
and nesterov SGD (``resnet18ish``) and adam (``MnistCNN``). Also: the
BatchNorm ``autograd.Function`` against its plain-autograd twin, the
optimizers against optax on fixed gradients, ``fit`` over ``(images,
labels)`` batches with one host sync, and ``train_mnist`` / ``train_resnet
--tiny`` on the CPU. The mesh cases are in ``test_torch_vision_mesh.py``.

Tolerances: logits and statistics within ``FP32_ATOL``. The trajectories
go step by step: at each of five steps of the JAX package's trainer the
port's trainer steps from the same state (parameters, statistics and the
optimizer's state carried across), because on a batch of 8 free-running
steps amplify the packages' summation order (the loss moves by up to
1.4e-5 at lr 0.1 by step 5). Each step's loss is held within
``test_torch_train_step.py``'s ``FP32_TOL``, its accuracy equal, the
gradients the trainer's optimizer steps on (``record_grads``) within
``GRAD_RTOL`` of each tensor's largest (over a floor, ``GRAD_ATOL``) of
the gradients the JAX step's own update was made of (``recording``: a
separately jitted gradient is another program, whose rounding can put a
ReLU input that is zero up to rounding on the other side of zero, and on
the mesh case one such element at stage 0's output moves that stage's
gradients far past rounding against the step's own), its
statistics within ``STATS_RTOL`` of their size, and the weights it leaves
within ``FP32_TOL`` under SGD. Under adam each weight is held within
``adam_weight_atol``: adam's step is m̂ / √v̂, and with the moments carried
across a gradient off by δ moves it by at most about 0.75·lr·δ / |g| in
these five steps (√v̂ ≥ 0.45·|g|), so a weight whose gradient stands well
above the rounding is held to ``FP32_TOL``, and only one whose gradient is
zero up to rounding may move by up to the learning rate either way. The
JAX package does the same to itself: at step 0 the stem's BatchNorm bias
has a channel whose gradient reads 3.0e-8 eagerly, 0 jitted, and 7.2e-9
in the port. The bf16 case is held within 2e-2 of the logits' scale, bf16's
rounding through eleven convolutions; the BatchNorm twin in bf16 within
one bf16 rounding of the largest gradient.

The SGD trajectory runs at a constant learning rate: from a warm-up that
starts at 0 (seed 0's batch), the reference's jitted step at step 2
departs from its own eager step by 4e-3 in the stem's gradient, where the
port agrees with the eager step and with an fp64 run of itself within
6e-7; the schedule's arithmetic is held against optax here on fixed
gradients.
"""
import dataclasses
import io
import math
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpu_on_k8s_torch.train.loop as loop_mod
from tpu_on_k8s.models import vision as jvision
from tpu_on_k8s.parallel import partition as jpartition
from tpu_on_k8s.parallel.mesh import MeshConfig as JMeshConfig
from tpu_on_k8s.parallel.mesh import create_mesh as jcreate_mesh
from tpu_on_k8s.train import vision as jtrain
from tpu_on_k8s_torch import train_mnist, train_resnet
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.models import vision
from tpu_on_k8s_torch.parallel.partition import spec_for_path
from tpu_on_k8s_torch.train import optimizer as popt
from tpu_on_k8s_torch.train.vision import ClassifierTrainer

from test_torch_vision_mesh import record_grads

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

# fp32: the packages differ in summation order only. Measured: logits
# within 9e-7, running statistics within 1.7e-6 (variances up to ~20).
FP32_ATOL = 1e-5
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)
# statistics after a step: relative to their size. The fast variance
# E[x²] − E[x]² cancels where a channel's mean is large (mean²/var up to 26
# at a projection's BatchNorm here): measured 2.6e-6
STATS_RTOL = 1e-5
# a step's gradients, relative to each tensor's largest: measured up to
# 1.2e-5 where a block's branch has just opened (its bn3 scale ~1e-3)
GRAD_RTOL = 5e-5
# and a floor: a BatchNorm bias's gradient is a sum over the batch that
# cancels to ~1e-2 of its terms (measured 5.6e-7 off at 9.6e-3)
GRAD_ATOL = 1e-6
STEPS = 5


def recording(opt: optax.GradientTransformation
              ) -> optax.GradientTransformation:
    """``opt`` after a transformation that keeps, as its state, the
    gradients the JAX package's step hands it (``recorded_grads``): the
    gradients that step's update is made of, from the same program."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, opt)


def recorded_grads(opt_state) -> dict:
    """The gradients ``recording`` kept at the last step, by the port's
    parameter names."""
    return pparams.from_jax_variables(
        {"params": jax.tree.map(np.asarray, opt_state[0])}, "cpu")


def adam_weight_atol(ref_grad: np.ndarray, lr: float) -> np.ndarray:
    """Per element, how far adam(``lr``) may leave a weight from the JAX
    package's when the gradient it took is within ``GRAD_RTOL`` of its
    tensor's largest plus ``GRAD_ATOL`` of ``ref_grad`` (see the module
    docstring): ``FP32_TOL`` plus twice ``lr`` times that bound over the
    gradient's size, at most twice ``lr``."""
    bound = GRAD_RTOL * np.abs(ref_grad).max() + GRAD_ATOL
    return FP32_TOL["params"] + np.minimum(
        2 * lr, 2 * lr * bound / np.maximum(np.abs(ref_grad), 1e-30))


def assert_within(got: np.ndarray, want: np.ndarray, atol, msg: str
                  ) -> None:
    """|got − want| ≤ ``atol`` elementwise (``atol`` a number or an array
    of ``want``'s shape), naming the worst element where it is not."""
    over = np.abs(got - want) - atol
    worst = np.unravel_index(np.argmax(over), over.shape)
    assert over[worst] <= 0, (
        f"{msg}: at {worst} got {got[worst]!r}, want {want[worst]!r}, "
        f"over its tolerance by {over[worst]!r}")


def _jcfg(dtype=jnp.float32, classes=4):
    return dataclasses.replace(jvision.ResNetConfig.resnet18ish(classes),
                               dtype=dtype)


def _pcfg(dtype=torch.float32, classes=4):
    return dataclasses.replace(vision.ResNetConfig.resnet18ish(classes),
                               dtype=dtype)


def _port(model: torch.nn.Module, variables) -> torch.nn.Module:
    return pparams.load_module(model, pparams.from_jax_variables(
        jax.tree.map(np.asarray, variables), "cpu"), "cpu")


def _images(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _randomized(variables, seed=1):
    """Every BatchNorm's scale, bias, mean and var drawn from a seed."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.array, variables)

    def visit(params, stats):
        for name, sub in params.items():
            if name.startswith("bn") or name.endswith("_bn"):
                c = sub["scale"].shape
                sub["scale"] = (1 + 0.3 * rng.standard_normal(c)).astype(
                    np.float32)
                sub["bias"] = (0.2 * rng.standard_normal(c)).astype(
                    np.float32)
                stats[name]["mean"] = (0.2 * rng.standard_normal(c)).astype(
                    np.float32)
                stats[name]["var"] = rng.uniform(0.5, 2.0, c).astype(
                    np.float32)
            elif isinstance(sub, dict) and name in stats:
                visit(sub, stats[name])

    visit(out["params"], out["batch_stats"])
    return out


def _stats_of(variables) -> dict:
    return pparams.from_jax_variables(
        {"batch_stats": jax.tree.map(np.asarray, variables)}, "cpu")


def _assert_stats(model: torch.nn.Module, want: dict, rtol=STATS_RTOL,
                  atol=FP32_TOL["params"]) -> None:
    got = dict(model.named_buffers())
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol, err_msg=name)


# ---- shapes and rules ---------------------------------------------------

def test_resnet50_param_count_matches_published_and_the_reference():
    """ResNet-50 (1000 classes) is ~25.5M params: the JAX package's count."""
    with torch.device("meta"):
        model = vision.ResNet(vision.ResNetConfig.resnet50())
    count = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda: jvision.ResNet(
        jvision.ResNetConfig.resnet50()).init(
            jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    assert 25.0e6 < count < 26.0e6, count
    assert count == sum(int(np.prod(l.shape))
                        for l in jax.tree.leaves(shapes["params"]))


def _ref_spec(name: str) -> tuple:
    """The reference's spec of a port parameter, on the port's layout (a
    conv weight is the HWIO kernel transposed, a Dense weight the [in, out]
    kernel's)."""
    module, _, leaf = name.rpartition(".")
    path = module.replace(".", "/") + "/" + (
        "kernel" if leaf == "weight" else leaf)
    spec = tuple(jpartition.spec_for_path(path,
                                          jvision.vision_partition_rules()))
    if leaf == "weight":
        n = 4 if "conv" in module else 2
        spec = spec + (None,) * (n - len(spec))
        spec = ((spec[3], spec[2], spec[0], spec[1]) if n == 4
                else tuple(reversed(spec)))
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("model_fn", [
    lambda: vision.ResNet(_pcfg()), lambda: vision.MnistCNN()],
    ids=["resnet18ish", "mnist"])
def test_rules_match_the_reference_leaf_for_leaf(model_fn):
    with torch.device("meta"):
        model = model_fn()
    for name, _ in model.named_parameters():
        got = spec_for_path(name, vision.vision_partition_rules())
        while got and got[-1] is None:
            got = got[:-1]
        assert got == _ref_spec(name), name


# ---- forward -------------------------------------------------------------

@pytest.fixture(scope="module")
def resnet_case():
    x = _images((4, 32, 32, 3))
    model = jvision.ResNet(_jcfg(classes=10))
    variables = _randomized(model.init(jax.random.key(1), jnp.asarray(x)))
    return model, variables, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet18ish_logits_and_batch_stats_match_jax(resnet_case, train):
    jmodel, variables, x = resnet_case
    model = _port(vision.ResNet(_pcfg(classes=10)), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x), train=train).numpy()
    if train:
        want, updated = jmodel.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
        _assert_stats(model, _stats_of(updated["batch_stats"]))
    else:
        want = jmodel.apply(variables, jnp.asarray(x), train=False)
        _assert_stats(model, _stats_of(variables["batch_stats"]), rtol=0,
                      atol=0)
    np.testing.assert_allclose(got, np.asarray(want), atol=FP32_ATOL, rtol=0)


def test_resnet18ish_bf16_logits_match_jax(resnet_case):
    """bf16 compute, fp32 parameters: within 2e-2 of the logits' scale."""
    _, variables, x = resnet_case
    jmodel = jvision.ResNet(_jcfg(jnp.bfloat16, classes=10))
    model = _port(vision.ResNet(_pcfg(torch.bfloat16, classes=10)),
                  variables)
    for train in (False, True):
        want = np.asarray(jmodel.apply(variables, jnp.asarray(x),
                                       train=train,
                                       mutable=["batch_stats"])[0]
                          if train else jmodel.apply(variables,
                                                     jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x), train=train).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


_FLAX_PADS = vision.same_pads


def _symmetric_pads(size, kernel, stride):
    """PyTorch's symmetric padding where flax pads SAME."""
    total = sum(_FLAX_PADS(size, kernel, stride))
    return (total + 1) // 2, (total + 1) // 2


@pytest.mark.parametrize("size", [8, 7])
def test_stride2_bottleneck_pads_as_flax(size, monkeypatch):
    """At an even size flax's SAME pads a stride-2 3x3 window (0, 1):
    PyTorch's symmetric padding 1 would shift every window. The block
    matches the JAX package's; the same block with symmetric padding does
    not (at the even size), so this test catches it."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(2, size, size, 16)).astype(np.float32)
    jblock = jvision.Bottleneck(8, 2, jnp.float32, jnp.float32)
    variables = jblock.init(jax.random.key(0), jnp.asarray(x), True)
    variables = jax.tree.map(np.array, variables)
    variables["params"]["bn3"]["scale"] = rng.standard_normal(32).astype(
        np.float32)
    want, _ = jblock.apply(variables, jnp.asarray(x), True,
                           mutable=["batch_stats"])
    block = _port(vision.Bottleneck(16, 8, 2, torch.float32, torch.float32),
                  variables)

    def run():
        with torch.no_grad():
            return block(torch.from_numpy(x).permute(0, 3, 1, 2),
                         True).permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(run(), np.asarray(want), atol=FP32_ATOL,
                               rtol=0)
    monkeypatch.setattr(vision, "same_pads", _symmetric_pads)
    if size % 2 == 0:
        assert np.abs(run() - np.asarray(want)).max() > 100 * FP32_ATOL
    else:       # flax pads an odd size (1, 1): symmetric already
        np.testing.assert_allclose(run(), np.asarray(want), atol=FP32_ATOL,
                                   rtol=0)


def test_stem_max_pool_pads_minus_inf_after():
    import flax.linen as nn
    x = -np.abs(_images((2, 10, 10, 3), seed=3))   # all negative: pads show
    want = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                       padding="SAME")
    got = vision.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_mnist_cnn_logits_match_jax():
    x = _images((4, 28, 28, 1), seed=2)
    jmodel = jvision.MnistCNN(dtype=jnp.float32)
    variables = jmodel.init(jax.random.key(3), jnp.asarray(x))
    # biases drawn from a seed: flax initialises them to zero
    variables = jax.tree.map(
        lambda a: a + 0.1 * np.random.default_rng(a.size).standard_normal(
            a.shape).astype(np.float32) if a.ndim == 1 else a, variables)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = _port(vision.MnistCNN(dtype=torch.float32), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)


# ---- BatchNorm -----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_norm_function_matches_its_plain_twin(dtype):
    """The training call's ``autograd.Function`` (x, the mean and the
    inverse std saved; a backward of two per-channel sums) against the
    same function in plain autograd: outputs equal, gradients within fp32
    rounding of the largest."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(6, 8, 5, 5, generator=g) * 3 + 2).to(dtype)
    scale = torch.randn(8, generator=g)
    bias = torch.randn(8, generator=g)
    dy = torch.randn(6, 8, 5, 5, generator=g).to(dtype)
    got, want = [], []
    for fn, out in ((lambda *a: vision._BatchNormTrain.apply(*a, ()), got),
                    (vision.batch_norm_plain, want)):
        xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
        y, mean, var = fn(xs, ss, bs, vision.EPS, dtype)
        out.extend([y, mean, var,
                    *torch.autograd.grad(y, (xs, ss, bs), dy)])
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[1], want[1])
    torch.testing.assert_close(got[2], want[2])
    rel = 1e-5 if dtype == torch.float32 else 2 ** -7
    for a, b in zip(got[3:], want[3:]):
        assert a.dtype == b.dtype
        assert (a.float() - b.float()).abs().max() <= rel * (
            b.float().abs().max() + 1), (a - b).abs().max()


def test_batch_norm_running_averages_are_flax_biased():
    """0.9·ra + 0.1·batch with the biased variance, not ``BatchNorm2d``'s
    unbiased update."""
    bn = vision.BatchNorm(3, torch.float32)
    pparams.load_module(bn, {"scale": torch.ones(3), "bias": torch.zeros(3),
                             "mean": torch.zeros(3), "var": torch.ones(3)},
                        "cpu")
    x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(1))
    bn(x, train=True)
    batch_var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * batch_var)
    torch.testing.assert_close(bn.mean, 0.1 * x.mean(dim=(0, 2, 3)))


# ---- optimizers ----------------------------------------------------------

def _sched():
    return (optax.warmup_cosine_decay_schedule(0.0, 0.1, 2, 5),
            popt.warmup_cosine_decay_schedule(0.0, 0.1, 2, 5))


@pytest.mark.parametrize("kind", ["sgd_nesterov_schedule", "sgd_momentum",
                                  "sgd_plain", "adam", "adamw_schedule"])
def test_optimizers_match_optax_on_fixed_gradients(kind):
    rng = np.random.default_rng(4)
    p0 = rng.standard_normal((3, 5)).astype(np.float32)
    grads = [rng.standard_normal((3, 5)).astype(np.float32)
             for _ in range(5)]
    jsched, psched = _sched()
    jopt, make = {
        "sgd_nesterov_schedule": (
            optax.sgd(jsched, momentum=0.9, nesterov=True),
            lambda p: popt.SGD(p, psched, momentum=0.9, nesterov=True)),
        "sgd_momentum": (optax.sgd(0.1, momentum=0.9),
                         lambda p: popt.SGD(p, 0.1, momentum=0.9)),
        "sgd_plain": (optax.sgd(0.1), lambda p: popt.SGD(p, 0.1)),
        "adam": (optax.adam(1e-3), lambda p: popt.adam(p, 1e-3)),
        "adamw_schedule": (optax.adamw(jsched, weight_decay=0.01),
                           lambda p: popt.adamw(p, psched,
                                                weight_decay=0.01)),
    }[kind]
    jp, state = jnp.asarray(p0), jopt.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt = make([tp])
    for g in grads:
        updates, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        tp.grad = torch.from_numpy(g)
        assert topt.step() is None
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=0, atol=1e-7)


# ---- trajectories --------------------------------------------------------

#: case → (JAX model, port model, images shape, classes, optax optimizer,
#: port optimizer factory, adam's learning rate or None for SGD)
TRAJECTORIES = {
    "resnet18ish_adam": (
        lambda: jvision.ResNet(_jcfg()), lambda: vision.ResNet(_pcfg()),
        (8, 32, 32, 3), 4, lambda: optax.adam(1e-3),
        lambda p: popt.adam(p, 1e-3), 1e-3),
    "resnet18ish_sgd_nesterov": (
        lambda: jvision.ResNet(_jcfg()), lambda: vision.ResNet(_pcfg()),
        (8, 32, 32, 3), 4,
        lambda: optax.sgd(0.1, momentum=0.9, nesterov=True),
        lambda p: popt.SGD(p, 0.1, momentum=0.9, nesterov=True), None),
    "mnist_adam": (
        lambda: jvision.MnistCNN(dtype=jnp.float32),
        lambda: vision.MnistCNN(dtype=torch.float32), (8, 28, 28, 1), 10,
        lambda: optax.adam(1e-3), lambda p: popt.adam(p, 1e-3), 1e-3),
}


def _optax_state(tree, kind):
    """The leaf-holder of ``kind`` ("trace", or "mu" for adam's) in an optax
    state of nested tuples."""
    if hasattr(tree, kind):
        return tree
    if isinstance(tree, (tuple, list)):
        for part in tree:
            found = _optax_state(part, kind)
            if found is not None:
                return found
    return None


def _load_optimizer(opt, model, opt_state, step: int) -> None:
    """A JAX optimizer state (numpy copies) into the port's optimizer."""
    named = dict(model.named_parameters())

    def leaves(tree):
        return pparams.from_jax_variables({"params": tree}, "cpu")

    if isinstance(opt, popt.SGD):
        for name, t in leaves(_optax_state(opt_state, "trace").trace).items():
            opt.state[named[name]]["trace"] = t
        opt.count = step
        return
    adam = _optax_state(opt_state, "mu")
    for key in ("mu", "nu"):
        for name, t in leaves(getattr(adam, key)).items():
            opt.state[named[name]][key] = t
    opt.count = int(adam.count)


@pytest.mark.parametrize("case", list(TRAJECTORIES))
def test_classifier_trajectory_matches_jax(case):
    """Five steps of the JAX package's ``ClassifierTrainer``; at each, the
    port's ``ClassifierTrainer`` takes one step from the same state (the
    parameters, the running statistics and the optimizer's state carried
    across) on the same batch: its loss, accuracy and gradients, and the
    parameters and statistics it leaves, against the JAX step's (see the
    module docstring)."""
    jmodel_fn, model_fn, shape, classes, jopt, make_opt, adam_lr = \
        TRAJECTORIES[case]
    x = _images(shape, seed=5)
    y = (np.arange(shape[0]) % classes).astype(np.int32)
    mesh = jcreate_mesh(JMeshConfig(data=1, fsdp=1, model=1, seq=1),
                        jax.devices()[:1])
    jtrainer = jtrain.ClassifierTrainer(jmodel_fn(),
                                        jvision.vision_partition_rules(),
                                        mesh, recording(jopt()))
    xs, ys = jtrainer.shard_batch(jnp.asarray(x), jnp.asarray(y))
    state = jtrainer.init_state(jax.random.key(1), xs)
    images, labels = torch.from_numpy(x), torch.from_numpy(y).long()

    for step in range(STEPS):
        # numpy copies: the JAX step donates its state
        before = jax.tree.map(np.array, (state.params, state.batch_stats,
                                         state.opt_state))
        model = _port(model_fn(), {"params": before[0],
                                   "batch_stats": before[1]})
        opt = make_opt(model.parameters())
        _load_optimizer(opt, model, before[2], step)
        trainer = ClassifierTrainer(model, opt)
        stepped_on = record_grads(opt, model)
        pstate = trainer.init_state()
        pstate.step = step
        pstate, got = trainer.train_step(pstate, images, labels)
        state, want = jtrainer.train_step(state, xs, ys)
        assert got["step"] == int(want["step"]) == step
        assert abs(got["loss"].item() - float(want["loss"])) <= \
            FP32_TOL["loss"]
        assert got["accuracy"].item() == float(want["accuracy"])
        grads = recorded_grads(state.opt_state)
        assert set(stepped_on) == set(grads)
        for name, g in stepped_on.items():
            np.testing.assert_allclose(
                g.numpy(), grads[name].numpy(), rtol=0,
                atol=GRAD_RTOL * grads[name].abs().max().item()
                + GRAD_ATOL,
                err_msg=f"step {step}: {name}")
        weights = pparams.from_jax_variables(
            {"params": jax.tree.map(np.asarray, state.params)}, "cpu")
        for name, p in model.named_parameters():
            assert_within(
                p.detach().numpy(), weights[name].numpy(),
                FP32_TOL["params"] if adam_lr is None else
                adam_weight_atol(grads[name].numpy(), adam_lr),
                f"step {step}: {name}")
        if state.batch_stats:
            _assert_stats(model, _stats_of(state.batch_stats))
    evals = trainer.eval_step(pstate, images, labels)
    jevals = jtrainer.eval_step(state, xs, ys)
    # the last step's weights, within their tolerance, through the model
    weight_tol = FP32_TOL["params"] if adam_lr is None else 2 * adam_lr
    assert abs(evals["loss"].item() - float(jevals["loss"])) <= \
        FP32_TOL["loss"] + 10 * weight_tol


@pytest.fixture()
def sync_counter(monkeypatch):
    calls = {"host": 0}
    real = loop_mod._host_sync

    def counting(step):
        calls["host"] += 1
        return real(step)

    monkeypatch.setattr(loop_mod, "_host_sync", counting)
    return calls


def _repeat(x):
    while True:
        yield x


def test_classifier_fit_unpacks_image_label_batches(sync_counter):
    """The reference's ``test_classifier_fit_unpacks_image_label_batches``:
    3 steps over ``(images, labels)`` batches, one host sync."""
    with torch.device("meta"):
        model = vision.MnistCNN(dtype=torch.float32)
    model = pparams.load_module(model, vision.init_variables(
        model, torch.Generator().manual_seed(1)), "cpu")
    trainer = ClassifierTrainer(model, popt.adam(model.parameters(), 1e-3))
    images = torch.from_numpy(_images((16, 28, 28, 1)))
    labels = torch.arange(16) % 10
    state = trainer.init_state()
    result = trainer.fit(state, _repeat((images, labels)), 3, log_every=3)
    assert result.steps == 3 and result.host_syncs == 1 == \
        sync_counter["host"]
    assert np.isfinite(result.last_metrics["loss"])
    assert 0.0 <= result.last_metrics["accuracy"] <= 1.0
    assert state.step == 3 == trainer.optimizer.count


def test_init_state_draws_the_reference_initialisers():
    """``init_state(generator)`` fills the model, as the reference's
    ``init_state(rng, images)`` makes its state: ``init_variables``'s
    values, every buffer included."""
    with torch.device("meta"):
        shapes = vision.ResNet(_pcfg())
    want = vision.init_variables(shapes, torch.Generator().manual_seed(3))
    model = vision.ResNet(_pcfg())
    trainer = ClassifierTrainer(model, popt.adam(model.parameters(), 1e-3))
    state = trainer.init_state(torch.Generator().manual_seed(3))
    assert state.step == 0 and state.model is model
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_init_variables_follow_the_reference_initialisers():
    """Drawn from an explicit generator as flax's ``model.init`` draws
    them: lecun-normal weights (truncated at 2 std), zero biases, unit
    scales except ``bn3``'s zeros, zero means and unit variances."""
    with torch.device("meta"):
        model = vision.ResNet(vision.ResNetConfig.resnet18ish())
    values = vision.init_variables(model, torch.Generator().manual_seed(0))
    again = vision.init_variables(model, torch.Generator().manual_seed(0))
    assert all(torch.equal(values[k], again[k]) for k in values)
    assert set(values) == set(model.state_dict())
    w = values["stage0_block0.conv2.weight"]
    fan_in = 16 * 3 * 3
    assert abs(w.std().item() * math.sqrt(fan_in) - 1) < 0.1
    assert w.abs().max().item() <= 2 * math.sqrt(1 / fan_in) / 0.8796 + 1e-6
    assert not values["stage0_block0.bn3.scale"].any()
    assert torch.equal(values["stage0_block0.bn1.scale"], torch.ones(16))
    assert torch.equal(values["bn_init.var"], torch.ones(16))
    assert not values["head.bias"].any()


# ---- the CLIs ------------------------------------------------------------

@pytest.mark.parametrize("cli, argv", [
    (train_mnist, ["--device", "cpu", "--steps", "2"]),
    (train_resnet, ["--tiny", "--device", "cpu", "--steps", "2",
                    "--image-size", "32"]),
], ids=["train_mnist", "train_resnet"])
def test_cli_trains_on_the_cpu(cli, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        loss = cli.main(argv)
    lines = [l for l in out.getvalue().splitlines()
             if l.startswith("[elastic-metrics]")]
    assert len(lines) == 2 and all(" accuracy=" in l for l in lines)
    assert math.isfinite(loss)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


@pytest.mark.parametrize("cli", ["train_mnist", "train_resnet",
                                 "train_bert"])
def test_cli_runs_on_the_card_unless_asked(cli, no_cuda):
    """Without ``--device cpu`` each CLI asks for the card, and raises
    where there is none: it never drops to the CPU on its own."""
    import importlib
    main = importlib.import_module(f"tpu_on_k8s_torch.{cli}").main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--steps", "1"])
