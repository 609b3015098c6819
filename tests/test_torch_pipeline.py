"""The port's GPipe pipeline against the JAX package's, on the CPU.

The reference's ``tests/test_pipeline.py`` on its 8-device CPU mesh; here
one spawned world of 4 gloo ranks runs the port's ``gpipe`` over
``stage_mesh(stages, 4 // stages)`` while the JAX package computes the same
cases over ``stage_mesh(stages, 8 // stages)`` in this process, on
numpy-seeded inputs. (stages, microbatches) (2, 4), (4, 4), (4, 2) and
(4, 8) (the reference's (8, 8) held at 4 stages): the output against the
JAX ``gpipe``'s and the sequential layers' (1e-5); the gradients against
``jax.grad`` of the JAX ``gpipe`` and of the sequential layers (1e-4),
the input's too; a layer count
the stages do not divide; and the flagship ``Block`` stack (fp32), its
parameters carried over from the JAX ``Block`` by the port's converter
and run through ``torch.func.functional_call``, against the JAX
``gpipe``'s output (2e-4).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_mesh_train import case_result, run_cases, start_world

torch.set_num_threads(1)

TOL = 1e-5
GRAD_TOL = 1e-4
BLOCK_TOL = 2e-4
#: (stages, microbatches); the port's world has 4 ranks
PIPE_CASES = [(2, 4), (4, 4), (4, 2), (4, 8)]
WORLD = 4
#: the flagship block's config, fp32 (the reference's, in bf16 compute)
BLOCK_CFG = dict(vocab_size=64, d_model=32, n_layers=4, n_heads=4,
                 n_kv_heads=2, d_ff=64, max_seq_len=32, remat=False)


def toy(n_layers: int = 4, d: int = 16, seed: int = 0):
    """The reference's toy stack: ``tanh(h @ w + b)`` layers, from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((n_layers, d, d)) * 0.3).astype(
        np.float32),
            "b": (rng.standard_normal((n_layers, d)) * 0.1).astype(
        np.float32)}


def x_toy(seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((8, 16)).astype(
        np.float32)


def _toy_layer(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


# ---- the spawned world ------------------------------------------------------

def _block_stack(block_tree: dict):
    """The JAX ``Block``'s stacked parameters as the port's, stacked per
    leaf: {name: [L, ...]} through ``models/params.py``'s converter."""
    from tpu_on_k8s_torch.models import params as pparams
    n = BLOCK_CFG["n_layers"]
    d = BLOCK_CFG["d_model"]
    tree = {"blocks": block_tree, "embed": np.zeros((1, d), np.float32),
            "final_norm": {"scale": np.ones((d,), np.float32)}}
    flat = pparams.from_jax_params(tree, torch.float32, "cpu")
    names = sorted({k.split(".", 2)[2] for k in flat if k.startswith(
        "blocks.")})
    return {name: torch.stack([flat[f"blocks.{i}.{name}"]
                               for i in range(n)]) for name in names}


def block_case(block_tree: dict, x: np.ndarray, n_micro: int):
    """The port's ``Block`` stack through ``gpipe`` on 4 stages."""
    import dataclasses

    from torch.func import functional_call

    from tpu_on_k8s_torch.models.transformer import (
        Block,
        Positions,
        TransformerConfig,
        _rope_tables,
    )
    from tpu_on_k8s_torch.parallel.pipeline import gpipe, stage_mesh

    cfg = dataclasses.replace(TransformerConfig(**BLOCK_CFG),
                              dtype=torch.float32)
    block = Block(cfg)
    rows = x.shape[0] // n_micro
    ids = torch.arange(x.shape[1], dtype=torch.int32).expand(rows, -1)
    cos, sin = _rope_tables(ids, cfg.head_dim // 2, cfg.rope_theta)
    pos = Positions(ids, cos[:, :, None, :], sin[:, :, None, :], False)

    def layer_fn(p, h):
        return functional_call(block, p, (h, pos))

    with torch.no_grad():
        return gpipe(layer_fn, _block_stack(block_tree), torch.from_numpy(x),
                     mesh=stage_mesh(WORLD, 1, device="cpu"),
                     n_micro=n_micro).numpy()


def _pipe_world(rank: int, world: int, params8, params4, params6, x,
                block_tree, block_x):
    from tpu_on_k8s_torch.parallel.pipeline import gpipe, stage_mesh

    def run(params, stages, n_micro, grads=False):
        p = {k: torch.from_numpy(v).clone().requires_grad_(grads)
             for k, v in params.items()}
        xt = torch.from_numpy(x).clone().requires_grad_(grads)
        out = gpipe(_toy_layer, p, xt, n_micro=n_micro,
                    mesh=stage_mesh(stages, WORLD // stages, device="cpu"))
        if not grads:
            return out.detach().numpy()
        (out ** 2).sum().backward()
        return {"x": xt.grad.numpy(),
                **{k: t.grad.numpy() for k, t in p.items()}}

    def not_divisible():
        try:
            run(params6, 4, 2)
        except ValueError as e:
            return str(e)
        return None

    cases = {f"match_{s}_{m}": (lambda s=s, m=m: run(params8, s, m))
             for s, m in PIPE_CASES}
    cases["grads"] = lambda: run(params4, 4, 4, grads=True)
    cases["not_divisible"] = not_divisible
    cases["block"] = lambda: block_case(block_tree, block_x, 4)
    return run_cases(rank, cases)


# ---- the parent: the JAX reference and the comparisons ---------------------

def _jax_toy(params):
    import jax
    import jax.numpy as jnp

    def layer_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def sequential(params, x):
        def body(h, one):
            return layer_fn(one, h), None
        return jax.lax.scan(body, x, params)[0]

    return jax.tree.map(jnp.asarray, params), layer_fn, sequential


@pytest.fixture(scope="module")
def inputs():
    """The toy stacks, the input, and the JAX flagship ``Block``'s
    stacked, de-correlated parameters and its input."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Block as JBlock
    from tpu_on_k8s.models.transformer import TransformerConfig as JConfig

    cfg = JConfig(**BLOCK_CFG, dtype=jnp.float32)
    bx = np.random.default_rng(2).standard_normal((4, 16, 32)).astype(
        np.float32)
    positions = jnp.broadcast_to(jnp.arange(16), (1, 16))
    one = JBlock(cfg).init(jax.random.key(1), jnp.asarray(bx[:1]),
                           positions)["params"]
    n = cfg.n_layers
    stacked = jax.tree.map(lambda leaf: np.asarray(
        jnp.stack([leaf] * n) * (1.0 + 0.01 * jnp.arange(n).reshape(
            (-1,) + (1,) * leaf.ndim))), one)
    return (toy(n_layers=8), toy(n_layers=4), toy(n_layers=6), x_toy(),
            stacked, bx)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The port's world, started before the JAX cases compute."""
    return start_world(_pipe_world, inputs, tmp_path_factory.mktemp("pipe"))


@pytest.fixture(scope="module")
def reference(inputs, world):
    """The JAX package's results of every case (while the world runs)."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Block as JBlock
    from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
    from tpu_on_k8s.parallel.pipeline import gpipe as jgpipe
    from tpu_on_k8s.parallel.pipeline import stage_mesh as jstage_mesh

    params8, params4, _, x, stacked, bx = inputs
    jx = jnp.asarray(x)
    p8, layer_fn, sequential = _jax_toy(params8)
    want = {"sequential": np.asarray(sequential(p8, jx))}
    for s, m in PIPE_CASES:
        want[f"match_{s}_{m}"] = np.asarray(jgpipe(
            layer_fn, p8, jx, mesh=jstage_mesh(s, per_stage=8 // s),
            n_micro=m))
    p4, layer_fn, sequential = _jax_toy(params4)
    mesh = jstage_mesh(4, per_stage=2)
    for key, fn in (("grads", lambda p, x: jgpipe(
            layer_fn, p, x, mesh=mesh, n_micro=4)), ("grads_seq", sequential)):
        grads = jax.grad(lambda p, x: jnp.sum(fn(p, x) ** 2),
                         argnums=(0, 1))(p4, jx)
        want[key] = {"x": np.asarray(grads[1]),
                     **{k: np.asarray(g) for k, g in grads[0].items()}}
    block = JBlock(JConfig(**BLOCK_CFG, dtype=jnp.float32))
    positions = jnp.broadcast_to(jnp.arange(16), (1, 16))

    def block_fn(p, h):
        return block.apply({"params": p}, h, positions)[0]

    want["block"] = np.asarray(jgpipe(
        block_fn, jax.tree.map(jnp.asarray, stacked), jnp.asarray(bx),
        mesh=jstage_mesh(4, per_stage=2), n_micro=4))
    return want


@pytest.fixture(scope="module")
def port_results(reference, world):
    return world()


@pytest.mark.parametrize("stages, n_micro", PIPE_CASES)
def test_matches_sequential(stages, n_micro, reference, port_results):
    got = case_result(port_results, f"match_{stages}_{n_micro}")
    np.testing.assert_allclose(got, reference[f"match_{stages}_{n_micro}"],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, reference["sequential"], atol=TOL,
                               rtol=TOL)


def test_gradients_match_sequential(reference, port_results):
    """Against ``jax.grad`` of the JAX ``gpipe`` and of the sequential
    layers: a replicating sum whose backward multiplied the gradient by
    the stage count would miss both."""
    got = case_result(port_results, "grads")
    for ref in ("grads", "grads_seq"):
        for key, want in reference[ref].items():
            np.testing.assert_allclose(got[key], want, atol=GRAD_TOL,
                                       rtol=GRAD_TOL, err_msg=f"{ref} {key}")


def test_layers_not_divisible_raises(port_results):
    message = case_result(port_results, "not_divisible")
    assert message is not None and "not divisible" in message, message


def test_flagship_block_pipeline(reference, port_results):
    """The flagship ``Block`` stack pipelined over 4 stages, on the JAX
    ``Block``'s parameters, as the JAX ``gpipe`` runs it."""
    np.testing.assert_allclose(case_result(port_results, "block"),
                               reference["block"], atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)
