"""BERT in the PyTorch port against the JAX package, on the CPU.

Tiny BERT in fp32 (and once in bf16) is initialised by the JAX package and
carried across with ``params.from_jax_bert_params``; inputs come from
numpy seeds. Held against the JAX package: BERT-base's parameter count,
the MLM logits and ``mlm_loss`` with and without type ids and a padding
mask on both ``attn_impl``s (the port's flash path through its kernels'
plain twins, the JAX package's flash kernel in Pallas interpret mode, as
its own tests run it), 5-step adamw trajectories of ``train/mlm.py``'s
``make_mlm_step`` against the example's optax step (on the xla and the
flash path, with a padding mask), and the partition rules leaf for leaf.
Also: the rules' placements validate on a (fsdp 2, model 4) mesh, as the
reference's test has them, and ``shard_model`` lays the encoder out there
(one head a rank, ``embed``'s vocab split); the initialisers;
``train_bert --tiny`` on the CPU. The mesh trajectories (data x fsdp,
model, seq) are in ``test_torch_vision_mesh.py``.

Tolerances: fp32 logits within ``FP32_ATOL`` (measured 2.7e-7) at every
position (a pad's row is its own segment, in both packages alike);
trajectories within
``test_torch_train_step.py``'s ``FP32_TOL``; bf16 logits within 2e-2 of
their scale.
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

from test_torch_parallel import end_fake_world, start_fake_world
from tpu_on_k8s.models import bert as jbert
from tpu_on_k8s.parallel import partition as jpartition
from tpu_on_k8s_torch import train_bert
from tpu_on_k8s_torch.models import bert, params as pparams
from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
from tpu_on_k8s_torch.parallel.partition import named_sharding, spec_for_path
from tpu_on_k8s_torch.parallel.sharded import shard_model
from tpu_on_k8s_torch.train import optimizer as popt
from tpu_on_k8s_torch.train.mlm import make_mlm_step

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

FP32_ATOL = 1e-5
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)
B, L = 2, 32
STEPS = 5


def _jcfg(dtype=jnp.float32, **changes):
    return dataclasses.replace(jbert.BertConfig.tiny(), dtype=dtype,
                               **changes)


def _pcfg(dtype=torch.float32, **changes):
    return dataclasses.replace(bert.BertConfig.tiny(), dtype=dtype,
                               **changes)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, L)).astype(np.int32)
    types = (np.arange(L)[None] >= rng.integers(4, L, (B, 1))).astype(
        np.int32)
    mask = np.ones((B, L), np.int32)
    mask[0, 20:] = 0            # row 0 padded after 20 real tokens
    mlm = (rng.uniform(size=(B, L)) < 0.3).astype(np.float32)
    return tokens, types, mask, mlm


@pytest.fixture(scope="module")
def jparams():
    tokens = _inputs()[0]
    return jax.tree.map(np.asarray, jbert.Bert(_jcfg()).init(
        jax.random.key(1), jnp.asarray(tokens))["params"])


def _port(cfg, tree) -> bert.Bert:
    return pparams.load_module(bert.Bert(cfg), pparams.from_jax_bert_params(
        tree, "cpu"), "cpu")


def test_bert_base_param_count_matches_the_reference():
    """BERT-base is ~110M params (the tied decoder counted once)."""
    with torch.device("meta"):
        count = sum(p.numel() for p in bert.Bert(
            bert.BertConfig.base()).parameters())
    shapes = jax.eval_shape(lambda: jbert.Bert(jbert.BertConfig.base()).init(
        jax.random.key(0), jnp.zeros((1, 16), jnp.int32)))
    assert 105e6 < count < 115e6, count
    assert count == sum(int(np.prod(l.shape))
                        for l in jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("inputs", ["tokens", "types", "mask",
                                    "types_mask"])
def test_logits_and_mlm_loss_match_jax(jparams, impl, inputs):
    tokens, types, mask, mlm = _inputs()
    types = types if "types" in inputs else None
    mask = mask if "mask" in inputs else None
    args = [jnp.asarray(tokens), None if types is None else
            jnp.asarray(types), None if mask is None else jnp.asarray(mask)]
    jmodel = jbert.Bert(_jcfg(attn_impl=impl))
    want = np.asarray(jmodel.apply({"params": jparams}, *args))
    want_loss = float(jbert.mlm_loss(jnp.asarray(want), jnp.asarray(tokens),
                                     jnp.asarray(mlm)))
    model = _port(_pcfg(attn_impl=impl), jparams)
    with torch.no_grad():
        got = model(*(None if a is None else torch.from_numpy(np.array(a))
                      for a in args))
        loss = bert.mlm_loss(got, torch.from_numpy(tokens),
                             torch.from_numpy(mlm)).item()
    np.testing.assert_allclose(got.numpy(), want, atol=FP32_ATOL, rtol=0)
    assert abs(loss - want_loss) <= FP32_TOL["loss"]
    # at init the loss is ~ln(vocab), the reference's own rule
    assert abs(loss - np.log(256)) < 1.0


def test_bf16_logits_match_jax(jparams):
    tokens, types, mask, _ = _inputs()
    want = np.asarray(jbert.Bert(_jcfg(jnp.bfloat16)).apply(
        {"params": jparams}, jnp.asarray(tokens), jnp.asarray(types),
        jnp.asarray(mask)))
    model = _port(_pcfg(torch.bfloat16), jparams)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(types),
                    torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-2 * np.abs(want).max())


def test_padding_mask_is_the_references_segments():
    mask = torch.tensor([[1, 1, 0, 0], [1, 1, 1, 1]])
    assert bert.padding_segments(mask).tolist() == [[0, 0, -3, -4],
                                                    [0, 0, 0, 0]]


def test_unknown_attn_impl_raises():
    with pytest.raises(ValueError, match="ring"):
        bert.Bert(_pcfg(attn_impl="ring"))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_mlm_trajectory_matches_jax(jparams, impl):
    """``make_mlm_step`` with the example's optimizer (``adamw``, weight
    decay 0.01, a warm-up cosine schedule to 1e-4 over 10 steps) against the
    example's optax step, 5 steps on one batch with type ids and a padding
    mask. (At a peak of 1e-3 a weight whose gradient is zero up to rounding
    moves by up to 2.3e-6 on the rounding alone: adam divides a gradient by
    its own magnitude; its arithmetic is held against optax on fixed
    gradients in ``test_torch_vision.py``.)"""
    tokens, types, mask, mlm = _inputs(seed=3)
    jmodel = jbert.Bert(_jcfg(attn_impl=impl))
    jopt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, 1e-4, 10, 11), weight_decay=0.01)

    @jax.jit
    def jstep(params, opt_state):
        def loss_fn(p):
            logits = jmodel.apply({"params": p}, jnp.asarray(tokens),
                                  jnp.asarray(types), jnp.asarray(mask))
            return jbert.mlm_loss(logits, jnp.asarray(tokens),
                                  jnp.asarray(mlm))
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = jopt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    params = jax.tree.map(jnp.asarray, jparams)
    opt_state = jopt.init(params)
    model = _port(_pcfg(attn_impl=impl), jparams)
    opt = popt.adamw(model.parameters(), popt.warmup_cosine_decay_schedule(
        0.0, 1e-4, 10, 11), weight_decay=0.01)
    step = make_mlm_step(model, opt)
    batch = [torch.from_numpy(a) for a in (tokens, mlm, types, mask)]
    for i in range(STEPS):
        params, opt_state, want = jstep(params, opt_state)
        got = step(*batch)
        assert got["step"] == i
        assert abs(got["loss"].item() - float(want)) <= FP32_TOL["loss"]
    weights = pparams.from_jax_bert_params(jax.tree.map(np.asarray, params),
                                           "cpu")
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   weights[name].numpy(), rtol=0,
                                   atol=FP32_TOL["params"], err_msg=name)


# ---- rules and meshes ------------------------------------------------------

def _ref_spec(name: str) -> tuple:
    """The reference's spec of a port parameter on the port's layout: a
    block's leaf loses the layer axis, a weight ``[out, in]`` reverses the
    kernel's ``[in, out]``."""
    parts = name.split(".")
    block = parts[0] == "blocks"
    if block:
        parts = ["blocks"] + parts[2:]
    leaf = parts[-1]
    path = "/".join(parts[:-1] + ["kernel" if leaf == "weight" else leaf])
    spec = tuple(jpartition.spec_for_path(path,
                                          jbert.bert_partition_rules()))
    if block:
        spec = spec[1:]
    if leaf == "weight":
        spec = tuple(reversed(spec + (None,) * (2 - len(spec))))
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_rules_match_the_reference_leaf_for_leaf():
    with torch.device("meta"):
        model = bert.Bert(bert.BertConfig.tiny())
    for name, _ in model.named_parameters():
        got = spec_for_path(name, bert.bert_partition_rules())
        while got and got[-1] is None:
            got = got[:-1]
        assert got == _ref_spec(name), name


@pytest.fixture()
def fake_world():
    """A world of 8 ranks (this process is rank 0) whose collectives do
    nothing: layout cases only."""
    start_fake_world()
    yield
    end_fake_world()


def test_rules_validate_on_fsdp2_model4_and_model_axis_refused(fake_world):
    """Every BERT parameter lands on a valid placement on (fsdp 2, model 4),
    as the reference's test has it, and the encoder lays out there: the
    tiny config's 4 heads give each rank 1 (``wq``'s 64 rows 16 a rank,
    split again over fsdp), ``wo`` and ``w_proj`` are row parallel,
    ``embed``'s 256 vocab rows give each rank 64, the position and type
    tables stay whole over ``model``; data x fsdp runs FSDP2 alone."""
    mesh = create_mesh(MeshConfig(data=1, fsdp=2, model=4), device="cpu")
    model = pparams.load_module(bert.Bert(_pcfg()), bert.init_params(
        _pcfg(), torch.Generator().manual_seed(0)), "cpu")
    named_sharding(dict(model.named_parameters()), mesh,
                   bert.bert_partition_rules())
    shard_model(model, mesh, bert.bert_partition_rules())
    got = dict(model.named_parameters())
    block = model.blocks[0]
    # 16 rows of wq: one head of 16 dims
    assert block.own_heads and block.tp.size == 4
    assert tuple(got["blocks.0.wq.weight"].to_local().shape) == (16, 32)
    assert got["embed"].full_tensor().shape == (256, 64)
    assert tuple(got["embed"].to_local().shape) == (64, 32)
    assert tuple(got["pos_embed"].to_local().shape) == (128, 32)
    assert (block.wq.role, block.w_fc.role, block.wo.role,
            block.w_proj.role, model.mlm_transform.role) == (0, 0, 1, 1, 0)
    other = pparams.load_module(bert.Bert(_pcfg()), bert.init_params(
        _pcfg(), torch.Generator().manual_seed(0)), "cpu")
    shard_model(other, create_mesh(MeshConfig(data=2, fsdp=4),
                                   device="cpu"),
                bert.bert_partition_rules())
    wq = dict(other.named_parameters())["blocks.0.wq.weight"]
    assert tuple(str(p) for p in wq.placements) == ("R", "S(1)")
    assert other.blocks[0].tp is None


def test_init_params_follow_the_reference_initialisers():
    cfg = bert.BertConfig.tiny()
    values = bert.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.device("meta"):
        assert set(values) == {n for n, _ in bert.Bert(
            cfg).named_parameters()}
    assert abs(values["blocks.0.w_fc.weight"].std().item() - 0.02) < 2e-3
    assert abs(values["embed"].std().item() - 0.02) < 2e-3
    w = values["mlm_transform.weight"]
    assert abs(w.std().item() * math.sqrt(cfg.d_model) - 1) < 0.1
    assert torch.equal(values["mlm_norm.scale"], torch.ones(cfg.d_model))
    assert not values["mlm_bias"].any() and not values[
        "blocks.1.wo.bias"].any()


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_train_bert_cli_on_the_cpu(attn):
    out = io.StringIO()
    with redirect_stdout(out):
        loss = train_bert.main(["--tiny", "--device", "cpu", "--steps", "2",
                                "--seq-len", "32", "--attn", attn])
    lines = [l for l in out.getvalue().splitlines()
             if l.startswith("[elastic-metrics]")]
    assert len(lines) == 2 and math.isfinite(loss)
    assert abs(loss - np.log(256)) < 1.0
