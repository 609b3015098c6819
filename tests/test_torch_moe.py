"""MoE in the port against the JAX package, on the CPU.

The oracles of ``tests/test_moe.py`` (the parameters' names and shapes, the
load-balance loss, expert-parallel training, capacity drops, a dense model's
zero aux loss) run in both packages on the same weights (initialised by JAX,
carried across with ``from_jax_params``) and the same numpy-seeded inputs.
Beyond them: ``MoEMLP`` alone in fp32 (top-k 1 and 2, SwiGLU and GELU,
capacity factor 0.1 and 1.25; with the MLP remat policy too) — the output,
the aux loss and the gradients of x, the router and the experts against
``jax.grad`` within ``MOE_TOL``, and the dispatch mask exactly (read off the
reference's own dispatch einsum); ``int8_matmul_batched`` bit for bit
against the reference's; training trajectories (aux weight 0.01, bf16-free
fp32) within ``test_torch_train_step.py``'s ``FP32_TOL``, and with
``mlp_int8`` (the reference's ``test_int8_moe_trains`` run) within
``test_torch_int8.py``'s ``TRAJ_TOL``; ``generate`` and the engine (dense, paged, chunked, a
prefix, speculative) token for token; the FLOP count of a step.

One spawned world of 4 gloo ranks (``test_torch_mesh_train.start_world``)
trains on (fsdp 2, expert 2), (model 2, expert 2) and (fsdp 2, seq 2)
against the JAX ``Trainer`` on 4 CPU devices, counts each rank's FLOPs,
routes one MoE layer over the (fsdp 2, seq 2) mesh's chunks (the dispatch
exactly the reference's over the whole sequence), then serves on
``serving_mesh(model=2, expert=2)`` (rank 0 drives, ranks 1-3 run
``serve_mesh_worker``) against the JAX engine on the same serving mesh.

Near ties in routing: a different summation order can flip an argmax and
move one token's output by O(1). Each comparison of routed outputs first
asserts that the inputs' smallest gap between consecutive probabilities of
each token's top k+1 exceeds ``MIN_GAP``, so a flip would show as that
assertion.

This module imports no JAX at its top: its rank bodies run in spawned
processes that import it.
"""
from __future__ import annotations

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from test_torch_mesh_train import case_result, run_cases, start_world

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

#: ``tests/test_torch_train_step.py``'s fp32 trajectory tolerances
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)
#: the MoE MLP alone in fp32: the packages differ in summation order only
#: (softmax, the combine's sum of k gated rows, the batched products)
MOE_TOL = dict(out=2e-6, aux=2e-6, grad=2e-6)
#: ``tests/test_torch_int8.py``'s int8 trajectory tolerances: an ulp of
#: difference in an activation may move an int8 value across a .5 boundary
TRAJ_TOL = dict(loss=2e-5, grad_norm=1.5e-5, params=1e-5)
#: the smallest gap between a token's consecutive top-(k+1) probabilities
#: that the exact dispatch comparisons need
MIN_GAP = 1e-4
STEPS = 3
WORLD = 4
AUX_W = 0.01
MOE = dict(n_experts=4, experts_top_k=2)


def _config(changes=None, dtype=torch.float32):
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    return dataclasses.replace(TransformerConfig.tiny(), dtype=dtype,
                               **{**MOE, **(changes or {})})


def _jax_config(changes=None):
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
    return dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               **{**MOE, **(changes or {})})


def _batches(b=4, l=25, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (b, l)).astype(np.int32)
            for _ in range(2)]


def _min_gap(probs: np.ndarray, k: int) -> float:
    """The smallest gap between consecutive probabilities among each
    token's top k+1 (a flip there changes the routing)."""
    top = -np.sort(-probs, axis=-1)[..., :k + 1]
    return float(np.min(top[..., :-1] - top[..., 1:]))


# ---- the spawned world --------------------------------------------------

#: case → (mesh sizes, config changes) of the world's training cases; the
#: int8 one runs ``w_down`` row parallel over model (quantized over the
#: whole F, the fp32 partial products summed before one cast)
MESH_CASES = {"fsdp2_expert2": (dict(fsdp=2, expert=2), {}),
              "model2_expert2": (dict(model=2, expert=2), {}),
              "model2_expert2_int8": (dict(model=2, expert=2),
                                      dict(mlp_int8=True)),
              "fsdp2_seq2": (dict(fsdp=2, seq=2), {})}
#: the engine's config changes in the world's serving cases
SERVE_CASES = {"serve": {}, "serve_int8": dict(mlp_int8=True)}
FLOP_LEN = 16


def _train_case(shape: dict, changes: dict, params, batches) -> dict:
    import torch.distributed as dist

    from tpu_on_k8s_torch.models.params import load_model
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train.compile import train_step_flops

    cfg = _config(changes)
    mesh = create_mesh(MeshConfig(**{"fsdp": 1, **shape}), device="cpu")
    model = load_model(cfg, {k: v.clone() for k, v in params.items()}, "cpu")
    opt = default_optimizer(model.parameters(), warmup_steps=2,
                            decay_steps=STEPS)
    trainer = Trainer(model, opt, rules=flagship_partition_rules(),
                      mesh=mesh, aux_loss_weight=AUX_W)
    flops, _ = train_step_flops(
        trainer, trainer.state(),
        trainer.shard_batch(batches[0][:, :FLOP_LEN + 1]))
    got = {"losses": [], "aux": [], "norms": []}
    for i in range(STEPS):
        m = trainer.train_step(trainer.shard_batch(batches[i % 2]))
        got["losses"].append(m["loss"].item())
        got["aux"].append(m["aux_loss"].item())
        got["norms"].append(m["grad_norm"].item())
    ev = trainer.eval_step(trainer.shard_batch(batches[0]))
    got["eval"] = {k: v.item() for k, v in ev.items()}
    got["params"] = {n: p.full_tensor().detach().clone()
                     for n, p in trainer.model.named_parameters()}
    got["placements"] = {n: tuple(str(pl) for pl in p.placements)
                         for n, p in trainer.model.named_parameters()}
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, flops)
    got["flops"] = counts
    return got


def _serve_case(mesh, changes: dict, params, prompts) -> tuple:
    """(each request's tokens, the shapes of the rank's MoE leaves) of the
    engine on ``mesh``."""
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules

    eng = ContinuousBatchingEngine(_config(dict(max_seq_len=64, **changes)),
                                   params,
                                   n_slots=2, mesh=mesh,
                                   rules=flagship_partition_rules(),
                                   device="cpu")
    ids = [eng.submit(p, n) for p, n in prompts]
    out = eng.run()
    shapes = {n: tuple(t.shape) for n, t in
              eng._prefill_model.named_parameters() if ".moe." in n}
    eng.close()
    return [np.asarray(out[i]).tolist() for i in ids], shapes


def _int8_layer_case(params, x) -> np.ndarray:
    """Block 0's ``mlp_int8`` MoE layer laid out on ``serving_mesh(model=2,
    expert=2)`` (``w_down`` row parallel over model), on ``x``."""
    from tpu_on_k8s_torch.models.params import load_model
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
    from tpu_on_k8s_torch.parallel.mesh import serving_mesh
    from tpu_on_k8s_torch.parallel.sharded import shard_serving_model

    model = load_model(_config(dict(mlp_int8=True)),
                       {k: v.clone() for k, v in params.items()}, "cpu")
    shard_serving_model(model, serving_mesh(model=2, expert=2, device="cpu"),
                        flagship_partition_rules())
    with torch.no_grad():
        return model.blocks[0].moe(x)[0].numpy()


def _seq_layer_case(params, x) -> list:
    """Block 0's MoE layer with a (fsdp 2, seq 2) mesh's ``seq`` axis, each
    rank its 8-token chunk of x's 16: every rank's (place on ``seq``, its
    chunk's dispatch mask, output and aux loss)."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.models import moe
    from tpu_on_k8s_torch.parallel.mesh import (
        AXIS_SEQ,
        MeshAxis,
        MeshConfig,
        create_mesh,
    )
    cfg = _config()
    layer = moe.MoEMLP(cfg)
    layer.load_state_dict({k.rpartition(".")[2]: v.clone()
                           for k, v in params.items()
                           if k.startswith("blocks.0.moe.")})
    seq = MeshAxis(create_mesh(MeshConfig(fsdp=2, seq=2), device="cpu"),
                   AXIS_SEQ)
    layer.seq = seq
    chunk = seq.own(x, 1)
    with torch.no_grad():
        y, aux = layer(chunk)
        routing = moe.route(chunk, layer.router, cfg.experts_top_k,
                            moe.capacity(cfg, x.shape[1]), seq)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, (seq.rank, routing.dispatch.numpy(),
                                   y.numpy(), aux.item()))
    return parts


def _moe_world(rank: int, world: int, params, batches, prompts):
    from tpu_on_k8s_torch.parallel.mesh import serving_mesh
    from tpu_on_k8s_torch.parallel.serving import (
        serve_mesh_worker,
        shutdown_mesh_workers,
    )
    cases = {name: functools.partial(_train_case, shape, changes, params,
                                     batches)
             for name, (shape, changes) in MESH_CASES.items()}
    cases["int8_layer"] = functools.partial(_int8_layer_case, params,
                                            _layer_input())
    cases["seq_layer"] = functools.partial(_seq_layer_case, params,
                                           _layer_input())
    results = run_cases(rank, cases)
    mesh = serving_mesh(model=2, expert=2, device="cpu")
    if rank:
        serve_mesh_worker([mesh])
        return results
    try:
        results.update(run_cases(rank, {
            name: functools.partial(_serve_case, mesh, changes, params,
                                    prompts)
            for name, changes in SERVE_CASES.items()}))
    finally:
        shutdown_mesh_workers()
    return results


# ---- fixtures ------------------------------------------------------------

@pytest.fixture(scope="module")
def tree():
    """The JAX weights of the tiny MoE model (fp32), and the port's."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    from tpu_on_k8s_torch.models import params as pparams
    batches = _batches()
    jtree = jax.tree.map(np.asarray, JTransformer(_jax_config()).init(
        jax.random.key(1), jnp.asarray(batches[0][:, :-1]))["params"])
    return jtree, pparams.from_jax_params(jtree, torch.float32, "cpu"), batches


def _layer_input() -> torch.Tensor:
    """The input of the world's MoE layer case, ``[2, 16, 64]``."""
    return torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 16, 64)).astype(np.float32))


def _serve_prompts():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, size=n).astype(np.int32), m)
            for n, m in ((5, 7), (11, 4), (17, 6))]


@pytest.fixture(scope="module")
def world(tree, tmp_path_factory):
    """The port's world, started before the JAX references compute."""
    _, params, batches = tree
    return start_world(_moe_world, (params, [torch.from_numpy(b)
                                             for b in batches],
                                     _serve_prompts()),
                       tmp_path_factory.mktemp("moe"))


@pytest.fixture(scope="module")
def mesh_reference(tree, world):
    """The JAX trajectories on the world's meshes and the JAX engine on
    ``serving_mesh(model=2, expert=2)`` over 4 CPU devices."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.serving import ContinuousBatchingEngine as JEngine
    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    from tpu_on_k8s.models.transformer import (
        flagship_partition_rules as jrules,
    )
    from tpu_on_k8s.parallel.mesh import MeshConfig, create_mesh, serving_mesh
    from tpu_on_k8s.parallel.partition import shard_pytree
    from tpu_on_k8s.train import trainer as jtrainer

    jtree, _, batches = tree
    want = {}
    for name, (shape, changes) in MESH_CASES.items():
        mesh = create_mesh(MeshConfig(**{"fsdp": 1, **shape}),
                           jax.devices()[:WORLD])
        opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=STEPS)
        trainer = jtrainer.Trainer(JTransformer(_jax_config(changes)),
                                   jrules(),
                                   mesh, opt, aux_loss_weight=AUX_W)
        jparams = jax.tree.map(jnp.asarray, jtree)
        state = shard_pytree(jtrainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=jparams,
            opt_state=opt.init(jparams)), mesh, jrules())
        got = {"losses": [], "aux": [], "norms": []}
        for i in range(STEPS):
            state, m = trainer.train_step(
                state, trainer.shard_batch(jnp.asarray(batches[i % 2])))
            got["losses"].append(float(m["loss"]))
            got["aux"].append(float(m["aux_loss"]))
            got["norms"].append(float(m["grad_norm"]))
        ev = trainer.eval_step(state, trainer.shard_batch(
            jnp.asarray(batches[0])))
        got["eval"] = {k: float(v) for k, v in ev.items()}
        got["params"] = jax.tree.map(np.asarray, state.params)
        want[name] = got
    for name, changes in SERVE_CASES.items():
        jcfg = _jax_config(dict(max_seq_len=64, **changes))
        eng = JEngine(jcfg, jax.tree.map(jnp.asarray, jtree), n_slots=2,
                      mesh=serving_mesh(model=2, expert=2,
                                        devices=jax.devices()[:WORLD]))
        ids = [eng.submit(p, n) for p, n in _serve_prompts()]
        out = eng.run()
        want[name] = [np.asarray(out[i]).tolist() for i in ids]
    return want


@pytest.fixture(scope="module")
def port_results(mesh_reference, world):
    return world()


# ---- the oracles of tests/test_moe.py ------------------------------------

def test_moe_forward_shape_and_params(tree):
    """The stacked experts keep the reference's layouts: ``w_up [E, D,
    F]`` per layer (the reference's ``[layers, E, D, F]``), the router
    ``[D, E]`` in fp32 even where the matrices are bf16."""
    from tpu_on_k8s_torch.models import params as pparams
    from tpu_on_k8s_torch.models.params import param_shapes
    jtree, params, _ = tree
    shapes = param_shapes(_config())
    assert shapes["blocks.0.moe.w_up"] == (4, 64, 128)
    assert shapes["blocks.1.moe.w_down"] == (4, 128, 64)
    assert shapes["blocks.0.moe.router"] == (64, 4)
    assert not any(".mlp." in n for n in shapes)
    assert jtree["blocks"]["moe"]["w_up"].shape == (2, 4, 64, 128)
    bf16 = pparams.from_jax_params(jtree, torch.bfloat16, "cpu")
    assert bf16["blocks.0.moe.router"].dtype == torch.float32
    assert bf16["blocks.0.moe.w_gate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["blocks.1.moe.w_gate"].numpy(),
                                  jtree["blocks"]["moe"]["w_gate"][1])
    init = pparams.init_params(_config(), torch.Generator().manual_seed(0),
                               "cpu", torch.bfloat16)
    assert init["blocks.0.moe.router"].dtype == torch.float32
    assert init["blocks.0.moe.w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
def test_moe_logits_and_losses_match_jax(tree, capacity_factor):
    """The whole model's logits and its load-balance loss (the sum over the
    ``losses`` collection) on 2 x 32 tokens; at capacity factor 0.1 most
    tokens overflow and ride the residual path, and the logits stay
    finite."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    from tpu_on_k8s_torch.models import params as pparams
    jtree, _, _ = tree
    changes = dict(expert_capacity_factor=capacity_factor)
    tokens = np.random.default_rng(3).integers(0, 256, (2, 32)).astype(
        np.int32)
    want, losses = JTransformer(_jax_config(changes)).apply(
        {"params": jtree}, jnp.asarray(tokens), mutable=["losses"])
    want_aux = sum(float(jnp.sum(leaf))
                   for leaf in jax.tree.leaves(losses["losses"]))
    model = pparams.load_model(_config(changes), pparams.from_jax_params(
        jtree, torch.float32, "cpu"), "cpu")
    with torch.no_grad():
        got, aux = model(torch.from_numpy(tokens), with_aux=True)
        plain = model(torch.from_numpy(tokens))
    assert torch.equal(got, plain)
    assert np.isfinite(got.numpy()).all()
    assert np.isfinite(want_aux) and want_aux > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(aux.item(), want_aux, atol=MOE_TOL["aux"],
                               rtol=0)


def test_dense_model_reports_zero_aux_loss():
    """``n_experts=0`` keeps the dense MLP, and every step's metrics carry
    ``aux_loss`` 0 (``tests/test_moe.py::test_dense_model_unaffected``);
    the eval step's keys are the reference's
    (``tests/test_flagship.py``)."""
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    cfg = dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float32)
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu", torch.float32), "cpu")
    trainer = Trainer(model, default_optimizer(model.parameters(),
                                               warmup_steps=1,
                                               decay_steps=10),
                      aux_loss_weight=0.01)
    tokens = torch.from_numpy(_batches()[0])
    ev = trainer.eval_step(tokens)
    assert set(ev) == {"loss", "perplexity", "aux_loss"}
    assert ev["aux_loss"].item() == 0.0
    assert ev["perplexity"].item() == pytest.approx(
        float(np.exp(ev["loss"].item())), rel=1e-6)
    m = trainer.train_step(tokens)
    assert set(m) == {"loss", "aux_loss", "grad_norm", "step"}
    assert m["aux_loss"].item() == 0.0
    assert abs(ev["loss"].item() - m["loss"].item()) < 1e-6


def test_moe_refusals_are_the_references():
    """What the reference refuses with MoE, the port refuses: W8A16
    serving weights (``ValueError`` at the model), the HF Llama export and
    ``quantize_serving_tree`` (``ValueError``, as
    ``tpu_on_k8s/models/convert.py`` raises); a tree of another layout
    still raises ``NotImplementedError``."""
    from tpu_on_k8s_torch.models import convert, params as pparams
    from tpu_on_k8s_torch.models.transformer import Transformer
    cfg = _config()
    with pytest.raises(ValueError, match="MoE"):
        Transformer(dataclasses.replace(cfg, serve_int8_weights=True,
                                        decode=True))
    w = pparams.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="MoE"):
        convert.to_hf_llama(cfg, w)
    with pytest.raises(ValueError, match="dense"):
        convert.quantize_serving_tree(cfg, w)
    with pytest.raises(NotImplementedError, match="layout not ported"):
        pparams.from_jax_params({"embed": np.zeros((4, 2)), "final_norm": {
            "scale": np.ones(2)}, "blocks": {"moe": {"router": np.zeros(
                (1, 2, 2))}, "attn": {}, "attn_norm": {}, "mlp_norm": {}}},
            device="cpu")


# ---- the MoE MLP alone ---------------------------------------------------

def _record_einsums(monkeypatch):
    """The reference's dispatch and combine masks, read off its own
    einsums: ``tpu_on_k8s.models.moe``'s ``jnp`` with an ``einsum`` that
    records the operands of ``blec,bld->ebcd`` (dispatch) and
    ``ebcd,blec->bld`` (the combine, cast)."""
    import jax.numpy as jnp

    import tpu_on_k8s.models.moe as jmoe
    seen = {}

    def einsum(spec, *ops, **kw):
        if spec == "blec,bld->ebcd":
            seen["dispatch"] = np.asarray(ops[0])
        elif spec == "ebcd,blec->bld":
            seen["combine"] = np.asarray(ops[1])
        return jnp.einsum(spec, *ops, **kw)

    shim = types.SimpleNamespace(**{n: getattr(jnp, n) for n in dir(jnp)
                                    if not n.startswith("__")})
    shim.einsum = einsum
    monkeypatch.setattr(jmoe, "jnp", shim)
    return seen


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat_mlp"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.1])
@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_matches_jax(monkeypatch, top_k, activation,
                             capacity_factor, remat):
    """``MoEMLP`` on x ``[2, 16, 64]`` against the reference's: the
    output, the load-balance loss, the dispatch mask exactly and the
    combine weights, and the gradients of x, the router and every expert
    weight of ``Σ y·r + 0.3·aux`` against ``jax.grad`` (through
    ``nn.remat`` with the MLP policy, and the port's checkpoint with its
    policy, under ``remat``)."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    from tpu_on_k8s.models.moe import MoEMLP as JMoE
    from tpu_on_k8s_torch.models import moe
    from tpu_on_k8s_torch.models.transformer import _mlp_remat_policy

    changes = dict(experts_top_k=top_k, activation=activation,
                   expert_capacity_factor=capacity_factor)
    jcfg, cfg = _jax_config(changes), _config(changes)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    r = rng.standard_normal((2, 16, 64)).astype(np.float32)
    cls = (nn.remat(JMoE, prevent_cse=False,
                    policy=jax.checkpoint_policies
                    .dots_with_no_batch_dims_saveable)
           if remat else JMoE)
    jparams = cls(jcfg).init(jax.random.key(2), jnp.asarray(x))["params"]
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jparams["router"]))
    assert _min_gap(probs, top_k) > MIN_GAP

    def jloss(p, xx):
        y, losses = cls(jcfg).apply({"params": p}, xx, mutable=["losses"])
        aux = sum(jnp.sum(v) for v in jax.tree.leaves(losses))
        return jnp.sum(y * r) + 0.3 * aux, (y, aux)

    # the masks from an eager, untraced forward of the plain class
    seen = _record_einsums(monkeypatch)
    JMoE(jcfg).apply({"params": jparams}, jnp.asarray(x), mutable=["losses"])
    monkeypatch.undo()
    (_, (want_y, want_aux)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jparams, jnp.asarray(x))

    block = moe.MoEMLP(cfg)
    block.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in jparams.items()})
    tx = torch.from_numpy(x).requires_grad_()
    if remat:
        y, aux = checkpoint(block, tx, use_reentrant=False,
                            context_fn=functools.partial(
                                create_selective_checkpoint_contexts,
                                _mlp_remat_policy(cfg.d_model)))
    else:
        y, aux = block(tx)
    (y * torch.from_numpy(r)).sum().add(0.3 * aux).backward()
    with torch.no_grad():
        routing = moe.route(torch.from_numpy(x), block.router, top_k,
                            moe.capacity(cfg, 16))
    np.testing.assert_array_equal(routing.dispatch.numpy(), seen["dispatch"])
    np.testing.assert_allclose(routing.combine.numpy(), seen["combine"],
                               atol=MOE_TOL["out"], rtol=0)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=MOE_TOL["out"], rtol=0)
    np.testing.assert_allclose(aux.item(), float(want_aux),
                               atol=MOE_TOL["aux"], rtol=0)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                               atol=MOE_TOL["grad"], rtol=0)
    for name, p in block.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[name]),
                                   atol=MOE_TOL["grad"], rtol=0,
                                   err_msg=name)


def test_capacity_is_the_calls_own():
    """capacity = max(1, int(factor · k · l / E)) with the call's l: a
    one-token decode step keeps 1 slot an expert, and a token past the
    capacity reaches no slot (it rides the residual)."""
    from tpu_on_k8s_torch.models import moe
    cfg = _config()
    assert moe.capacity(cfg, 1) == 1
    assert moe.capacity(cfg, 32) == 20
    assert moe.capacity(_config(dict(expert_capacity_factor=0.1)), 64) == 3
    # every token routed to expert 0 first: only the first 2 keep a slot
    x = torch.ones(1, 5, 2)
    router = torch.tensor([[3.0, 1.0, 0.0], [3.0, 0.0, 1.0]])
    routing = moe.route(x, router, 1, 2)
    assert routing.dispatch.sum(dim=(2, 3)).tolist() == [[1, 1, 0, 0, 0]]
    assert routing.dispatch[0, :2, 0].tolist() == [[1, 0], [0, 1]]


# ---- int8_matmul_batched --------------------------------------------------

@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_batched_matches_jax(impl, dtype):
    """The batched int8 product against the reference's, bit for bit in
    the forward (the exact int32 sum and the same epilogue; an expert's
    empty capacity rows take the 1e-30 floor and give zeros), and its
    backward (the reference's einsums) within fp32 tolerance."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.ops.int8_matmul import int8_matmul_batched as jbatched
    from tpu_on_k8s_torch.ops.int8_matmul import int8_matmul_batched
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 2, 5, 48)).astype(np.float32)
    x[1, :, 3:] = 0.0                       # empty capacity rows
    w = (0.02 * rng.standard_normal((3, 48, 40))).astype(np.float32)
    g = rng.standard_normal((3, 2, 5, 40)).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    want, vjp = jax.vjp(jbatched, jx, jw)
    jdx, jdw = vjp(jnp.asarray(g, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    got = int8_matmul_batched(tx, tw, impl)
    got.backward(torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert not got[1, :, 3:].any()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(tx.grad.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(tw.grad.float().numpy(),
                               np.asarray(jdw.astype(jnp.float32)),
                               atol=tol, rtol=tol)


# ---- training --------------------------------------------------------------

def _trajectory(changes, steps, batches, aux_w, **opt_kw):
    """(JAX metrics per step and final weights, the port's) from the same
    JAX-initialised weights."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    from tpu_on_k8s.train import trainer as jtrainer
    from tpu_on_k8s_torch.models import params as pparams
    from tpu_on_k8s_torch.train import Trainer, default_optimizer

    jcfg = _jax_config(changes)
    jparams = JTransformer(jcfg).init(
        jax.random.key(0), jnp.asarray(batches[0][:, :-1]))["params"]
    tree = jax.tree.map(np.array, jparams)
    opt = jtrainer.default_optimizer(**opt_kw)
    step = jtrainer.make_train_step(JTransformer(jcfg), opt,
                                    aux_loss_weight=aux_w)
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32),
                                params=jparams, opt_state=opt.init(jparams))
    model = pparams.load_model(_config(changes), pparams.from_jax_params(
        tree, torch.float32, "cpu"), "cpu")
    trainer = Trainer(model, default_optimizer(model.parameters(), **opt_kw),
                      aux_loss_weight=aux_w)
    want, got = [], []
    for i in range(steps):
        state, m = step(state, jnp.asarray(batches[i % len(batches)]))
        want.append({k: float(m[k]) for k in ("loss", "aux_loss",
                                             "grad_norm")})
        p = trainer.train_step(torch.from_numpy(batches[i % len(batches)]))
        got.append({k: p[k].item() for k in ("loss", "aux_loss",
                                             "grad_norm")})
    final = pparams.from_jax_params(jax.tree.map(np.asarray, state.params),
                                    torch.float32, "cpu")
    return want, got, final, model


def _assert_trajectory(want, got, final, model, tol):
    for w, g in zip(want, got):
        assert abs(g["loss"] - w["loss"]) <= tol["loss"], (w, g)
        assert abs(g["aux_loss"] - w["aux_loss"]) <= tol["loss"], (w, g)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= (
            tol["grad_norm"] * w["grad_norm"]), (w, g)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name].numpy(),
                                   atol=tol["params"], rtol=0, err_msg=name)


@pytest.mark.parametrize("changes", [
    {}, dict(remat=True, remat_policy="mlp"),
    dict(remat=True, remat_policy="dots", activation="gelu"),
    dict(experts_top_k=1, expert_capacity_factor=0.1),
], ids=["swiglu", "remat_mlp", "remat_dots_gelu", "top1_drops"])
def test_moe_trajectory_matches_jax(changes):
    """3 steps with the load-balance loss folded in (weight 0.01): losses,
    aux losses, grad norms and the final weights within ``FP32_TOL``."""
    batches = _batches()
    want, got, final, model = _trajectory(changes, 3, batches, AUX_W,
                                          warmup_steps=2, decay_steps=3)
    assert all(g["aux_loss"] > 0 for g in got)
    _assert_trajectory(want, got, final, model, FP32_TOL)


@pytest.mark.parametrize("aux_w", [0.0, 0.01])
def test_moe_eval_and_accumulation(aux_w):
    """The eval step's loss is the train step's objective with the
    perplexity of the cross-entropy alone, and 2 microbatches weigh as one
    batch; with weight 0 the aux loss is reported as 0, as the
    reference collects it only then."""
    from tpu_on_k8s_torch.models import params as pparams
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    cfg = _config()
    p0 = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                     torch.float32)
    tokens = torch.from_numpy(_batches()[0])
    metrics = []
    for accum in (1, 2):
        model = pparams.load_model(cfg, {k: v.clone() for k, v in p0.items()},
                                   "cpu")
        trainer = Trainer(model, default_optimizer(model.parameters()),
                          grad_accum=accum, aux_loss_weight=aux_w)
        ev = trainer.eval_step(tokens)
        metrics.append((ev, trainer.train_step(tokens)))
    (ev, m), (_, m2) = metrics
    assert abs(ev["loss"].item() - m["loss"].item()) < 1e-6
    assert ev["aux_loss"].item() == m["aux_loss"].item()
    if not aux_w:
        assert m["aux_loss"].item() == 0.0 == m2["aux_loss"].item()
    else:
        assert m["aux_loss"].item() > 0
        np.testing.assert_allclose(
            ev["perplexity"].item(),
            np.exp(ev["loss"].item() - aux_w * ev["aux_loss"].item()),
            rtol=1e-6)
    np.testing.assert_allclose(m2["loss"].item(), m["loss"].item(),
                               atol=1e-3)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_int8_moe_trains(impl):
    """The reference's ``test_int8_moe_trains`` (``mlp_int8``, aux weight
    0.01, 8 steps on one batch of 2 x 33): in fp32 both packages step by
    step within ``TRAJ_TOL`` at the default learning rate, and the port's
    run in bf16 at the reference's lr 1e-2 trains as the reference asserts
    (the loss falls, the aux loss is finite). At lr 1e-2 the trajectory
    itself amplifies an ulp: without ``mlp_int8`` the two packages' weights
    part by ~1e-4 in 8 steps, so it is held to the reference's asserts."""
    tok = np.random.default_rng(1).integers(0, 256, (2, 33)).astype(
        np.int32)
    changes = dict(mlp_int8=True, int8_impl=impl)
    want, got, final, model = _trajectory(changes, 8, [tok], 0.01,
                                          warmup_steps=1, decay_steps=50)
    _assert_trajectory(want, got, final, model, TRAJ_TOL)

    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    cfg = _config(changes, dtype=torch.bfloat16)
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu", torch.float32), "cpu")
    trainer = Trainer(model, default_optimizer(
        model.parameters(), learning_rate=1e-2, warmup_steps=1,
        decay_steps=50), aux_loss_weight=0.01)
    losses = [trainer.train_step(torch.from_numpy(tok)) for _ in range(8)]
    assert losses[-1]["loss"].item() < losses[0]["loss"].item()
    assert np.isfinite(losses[-1]["aux_loss"].item())


def test_train_step_flops_count_the_expert_products():
    """``train_step_flops`` counts the router, the dispatch and combine
    products and every expert's products (forward and backward) by their
    shapes, so the loop's ``mfu`` divides the work the dense dispatch
    really runs."""
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.train import Trainer
    from tpu_on_k8s_torch.train.compile import train_step_flops
    cfg = _config(dict(attn_impl="flash"))
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu", torch.float32), "cpu")
    trainer = Trainer(model, aux_loss_weight=AUX_W)
    tokens = torch.from_numpy(_batches()[0][:, :FLOP_LEN + 1])
    flops, _ = train_step_flops(trainer, trainer.state(), tokens)
    assert flops == _step_flops(cfg, tokens.shape[0], FLOP_LEN)


def _step_flops(cfg, b: int, l: int, n_expert: int = 1, n_model: int = 1,
                flash: bool = True) -> int:
    """One training step's products on ``b`` rows of ``l`` tokens, by hand,
    on a rank of an (expert, model) layout: attention's projections and
    the head (``test_torch_mesh_train._products``; ``model`` splits the
    heads), the flash kernels over the causal pairs or the plain
    attention's two ``L x L`` products, and per MoE layer the router (x and
    router gradients), the dispatch (x's gradient only: the mask has
    none), the three expert products and the combine (both gradients) on
    the rank's E/expert experts and F/model columns. Each product counts
    2·M·N·K forward and twice that backward."""
    d, hd, e, f = cfg.d_model, cfg.head_dim, cfg.n_experts, cfg.d_ff
    c = max(1, int(cfg.expert_capacity_factor * cfg.experts_top_k * l / e))
    t, h = b * l, cfg.n_heads // n_model
    proj = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d) // n_model
    if flash:
        attn = (4 + 6 + 8) * b * h * hd * (l * (l + 1) // 2)
    else:
        attn = 3 * 2 * 2 * b * h * l * l * hd
    el, fl = e // n_expert, f // n_model
    moe = (3 * 2 * t * d * e                       # router
           + 2 * 2 * t * el * c * d                # dispatch: fwd + dx
           + 3 * 3 * 2 * b * el * c * d * fl       # gate, up, down
           + 3 * 2 * t * el * c * d)               # combine
    return cfg.n_layers * (3 * 2 * t * proj + attn + moe) + (
        3 * 2 * t * d * cfg.vocab_size // n_model)


# ---- serving ---------------------------------------------------------------

@pytest.fixture(scope="module")
def serving_setup():
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    from tpu_on_k8s_torch.models import params as pparams
    jcfg = _jax_config(dict(max_seq_len=64))
    tok = jax.random.randint(jax.random.key(0), (1, 8), 0, 256, jnp.int32)
    jparams = JTransformer(jcfg).init(jax.random.key(1), tok)["params"]
    params = pparams.from_jax_params(jax.tree.map(np.asarray, jparams),
                                     device="cpu")
    return jcfg, jparams, _config(dict(max_seq_len=64)), params, tok


def test_moe_model_serves_through_generate_and_engine(serving_setup):
    """``tests/test_continuous_batching.py::
    test_moe_model_serves_through_engine``: the JAX ``generate``'s tokens
    from the port's ``generate`` and from its engine."""
    from tpu_on_k8s.models import decode as jdecode
    from tpu_on_k8s_torch.models import decode
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    jcfg, jparams, cfg, params, tok = serving_setup
    want = np.asarray(jdecode.generate(jcfg, jparams, tok, 5))[0]
    got = decode.generate(cfg, params, torch.from_numpy(np.asarray(tok)), 5,
                          device="cpu")
    np.testing.assert_array_equal(np.asarray(got)[0], want)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=2, device="cpu")
    rid = eng.submit(np.asarray(tok[0]), 5)
    np.testing.assert_array_equal(eng.run()[rid], want)


ENGINE_MODES = {
    "dense": {},
    "paged": dict(kv_pages=16, page_tokens=8),
    "chunked": dict(prefill_chunk=4),
    "prefix": dict(kv_pages=16, page_tokens=8),
    "speculative": dict(spec_k=3),
}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
def test_moe_engine_matches_jax_engine(serving_setup, mode):
    """The engine in each mode against the JAX engine in the same mode,
    token for token: each call routes with its own capacity (a prefill
    bucket, a chunk, a verify window of k+1, a one-token step)."""
    from tpu_on_k8s.models import decode as jdecode
    from tpu_on_k8s.models.serving import ContinuousBatchingEngine as JEngine
    from tpu_on_k8s_torch.models import decode
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    jcfg, jparams, cfg, params, _ = serving_setup
    kw = dict(ENGINE_MODES[mode], n_slots=2)
    jkw, pkw = dict(kw), dict(kw)
    if mode == "speculative":
        jkw["draft_cfg"], jkw["draft_params"] = jdecode.truncated_draft(
            jcfg, jparams, 1)
        pkw["draft_cfg"], pkw["draft_params"] = decode.truncated_draft(
            cfg, params, 1)
    rng = np.random.default_rng(13)
    shared = rng.integers(0, 256, size=9).astype(np.int32)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (5, 11, 17, 3)]
    budgets = (7, 4, 9, 6)

    def run(engine):
        pid = engine.register_prefix(shared) if mode == "prefix" else None
        ids = [engine.submit(p, n) if pid is None else
               engine.submit(p, n, prefix_id=pid)
               for p, n in zip(prompts, budgets)]
        out = engine.run()
        return [np.asarray(out[i]).tolist() for i in ids]

    want = run(JEngine(jcfg, jparams, **jkw))
    got = run(ContinuousBatchingEngine(cfg, params, device="cpu", **pkw))
    assert got == want


# ---- the world -------------------------------------------------------------

def _unsharded_trajectory(changes, params, batches) -> dict:
    """The final weights of the port's run of the world's training cases
    without a mesh."""
    from tpu_on_k8s_torch.models.params import load_model
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    model = load_model(_config(changes),
                       {k: v.clone() for k, v in params.items()}, "cpu")
    trainer = Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=2, decay_steps=STEPS),
        aux_loss_weight=AUX_W)
    for i in range(STEPS):
        trainer.train_step(torch.from_numpy(batches[i % 2]))
    return {n: p.detach() for n, p in model.named_parameters()}


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_expert_parallel_trajectory_matches_jax(case, tree, mesh_reference,
                                                port_results):
    """``tests/test_moe.py::test_moe_trains_expert_parallel`` on (fsdp 2,
    expert 2), (model 2, expert 2) and (fsdp 2, seq 2) (each rank a chunk
    of 12 of every row's 24 tokens, routed over the whole row): 3 steps at
    aux weight 0.01 and an eval step against the JAX ``Trainer`` on the
    same mesh within ``FP32_TOL``; the aux loss is positive and the loss
    falls.

    Under ``mlp_int8`` on (model 2, expert 2), where ``w_down`` is row
    parallel: the losses, aux losses, grad norms and eval metrics against
    the JAX ``Trainer`` within ``TRAJ_TOL``, and the final weights against
    the port's own unsharded run within ``FP32_TOL``. The unsharded port
    itself departs from the JAX run by 1.1e-5 in one element of
    ``blocks.0.moe.w_down`` after these 3 steps (an int8 rounding moved by
    an ulp of an activation, which Adam's near-zero-gradient update
    amplifies), past ``TRAJ_TOL``'s 1e-5, while the JAX runs on this mesh
    and on one device agree within 3e-8: the mesh is held to the
    unsharded arithmetic it must reproduce."""
    from tpu_on_k8s_torch.models import params as pparams
    got = case_result(port_results, case)
    want = mesh_reference[case]
    changes = MESH_CASES[case][1]
    int8 = changes.get("mlp_int8", False)
    tols = TRAJ_TOL if int8 else FP32_TOL
    for key, tol in (("losses", "loss"), ("aux", "loss")):
        np.testing.assert_allclose(got[key], want[key],
                                   atol=tols[tol], rtol=0)
    np.testing.assert_allclose(got["norms"], want["norms"],
                               rtol=tols["grad_norm"], atol=0)
    for key in ("loss", "perplexity", "aux_loss"):
        np.testing.assert_allclose(
            got["eval"][key], want["eval"][key], err_msg=key,
            **(dict(rtol=TRAJ_TOL["loss"], atol=0) if int8
               else dict(rtol=2e-6, atol=0)))
    assert got["aux"][-1] > 0 and got["losses"][-1] < got["losses"][0]
    expected = (_unsharded_trajectory(changes, tree[1], tree[2]) if int8
                else pparams.from_jax_params(want["params"], torch.float32,
                                             "cpu"))
    assert set(expected) == set(got["params"])
    for name, w in expected.items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   atol=FP32_TOL["params"], rtol=0,
                                   err_msg=f"{case}: {name}")


def test_seq_axis_routes_over_the_whole_sequence(tree, port_results,
                                                  monkeypatch):
    """Block 0's MoE layer on (fsdp 2, seq 2), each rank an 8-token chunk
    of x's 16, against the reference's layer on the whole x: the chunks'
    dispatch masks, in the order of their ranks on ``seq``, are the
    reference's exactly (read off its own einsum; capacity and slots the
    whole sequence's); the outputs within ``MOE_TOL``; the aux loss, which
    every rank computes from statistics summed over ``seq``, within 2e-6
    of the reference's."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.moe import MoEMLP as JMoE
    x = _layer_input().numpy()
    jparams = {k: jnp.asarray(v[0])
               for k, v in tree[0]["blocks"]["moe"].items()}
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jparams["router"]))
    assert _min_gap(probs, MOE["experts_top_k"]) > MIN_GAP
    seen = _record_einsums(monkeypatch)
    want_y, losses = JMoE(_jax_config()).apply(
        {"params": jparams}, jnp.asarray(x), mutable=["losses"])
    monkeypatch.undo()
    want_aux = float(sum(jnp.sum(v) for v in jax.tree.leaves(losses)))
    parts = case_result(port_results, "seq_layer")
    chunks = {place: (dispatch, y) for place, dispatch, y, _ in parts}
    assert sorted(chunks) == [0, 1]
    dispatch = np.concatenate([chunks[i][0] for i in (0, 1)], axis=1)
    np.testing.assert_array_equal(dispatch, seen["dispatch"])
    np.testing.assert_allclose(
        np.concatenate([chunks[i][1] for i in (0, 1)], axis=1),
        np.asarray(want_y), atol=MOE_TOL["out"], rtol=0)
    for *_, aux in parts:
        np.testing.assert_allclose(aux, want_aux, atol=MOE_TOL["aux"],
                                   rtol=0)


def test_expert_weights_are_laid_out_as_the_rules_say(port_results):
    """Each expert weight holds its rank's experts over ``expert``, its
    block of F over ``model`` and of D over ``fsdp`` (the reference's MoE
    rules); the router is split over fsdp alone."""
    got = case_result(port_results, "fsdp2_expert2")["placements"]
    assert got["blocks.0.moe.w_up"] == ("S(1)", "S(0)")
    assert got["blocks.0.moe.w_down"] == ("S(2)", "S(0)")
    assert got["blocks.0.moe.router"] == ("S(0)",)
    got = case_result(port_results, "model2_expert2")["placements"]
    assert got["blocks.1.moe.w_gate"] == ("S(1)", "S(0)", "S(2)")
    assert got["blocks.1.moe.w_down"] == ("S(2)", "S(0)", "S(1)")


def test_each_rank_counts_its_own_experts(port_results):
    """On (fsdp 2, expert 2) a rank counts its 2 rows and its 2 experts;
    on (model 2, expert 2) all 4 rows, its 2 experts and half of F (and
    half the heads and the vocab)."""
    rows = {"fsdp2_expert2": (2, 2, 1), "model2_expert2": (4, 2, 2)}
    for case, (b, n_expert, n_model) in rows.items():
        counts = case_result(port_results, case)["flops"]
        assert len(set(counts)) == 1, (case, counts)
        assert counts[0] == _step_flops(_config(), b, FLOP_LEN, n_expert,
                                        n_model, flash=False), case


def test_expert_parallel_serving_matches_jax(mesh_reference, port_results):
    """The engine on ``serving_mesh(model=2, expert=2)`` (each rank holds
    2 experts and half of F, sums ``w_down`` over model and the combine
    over expert) against the JAX engine on the same serving mesh, token
    for token."""
    tokens, shapes = case_result(port_results, "serve")
    assert tokens == mesh_reference["serve"]
    assert shapes["blocks.0.moe.w_up"] == (2, 64, 64)
    assert shapes["blocks.0.moe.w_down"] == (2, 64, 64)
    assert shapes["blocks.0.moe.router"] == (64, 4)


def test_expert_parallel_int8_serving_matches_jax(mesh_reference,
                                                  port_results):
    """The ``mlp_int8`` engine on ``serving_mesh(model=2, expert=2)``,
    whose ``w_down`` is row parallel over model (quantized over the whole
    F, its fp32 partial products summed before one cast), against the JAX
    engine on the same serving mesh, token for token."""
    tokens, shapes = case_result(port_results, "serve_int8")
    assert tokens == mesh_reference["serve_int8"]
    assert shapes["blocks.0.moe.w_down"] == (2, 64, 64)


def test_expert_parallel_int8_layer_matches_jax(tree, port_results):
    """Block 0's ``mlp_int8`` MoE layer on ``serving_mesh(model=2,
    expert=2)`` against the reference's unsharded layer on the same x:
    the row-parallel ``w_down`` quantizes over the whole F (its absmax
    taken to the max over model) and sums its fp32 partial products before
    one cast, so its int8 values and scales are the reference's; what
    remains is the order of fp32 sums, within ``MOE_TOL``. A ``w_down``
    quantized over each rank's half of F alone is ~1/127 of an output
    off."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.moe import MoEMLP as JMoE
    jtree = tree[0]
    x = _layer_input().numpy()
    jparams = {k: jnp.asarray(v[0]) for k, v in jtree["blocks"]["moe"].items()}
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jparams["router"]))
    assert _min_gap(probs, MOE["experts_top_k"]) > MIN_GAP
    want, _ = JMoE(_jax_config(dict(mlp_int8=True))).apply(
        {"params": jparams}, jnp.asarray(x), mutable=["losses"])
    got = case_result(port_results, "int8_layer")
    np.testing.assert_allclose(got, np.asarray(want), atol=MOE_TOL["out"],
                               rtol=0)
