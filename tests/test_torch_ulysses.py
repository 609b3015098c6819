"""The port's Ulysses attention against the JAX package's, on the CPU.

The reference's ``tests/test_ulysses.py`` on its 8-device CPU mesh; here
one spawned world of 4 gloo ranks runs the port's cases while the JAX
package computes the same ones in this process, on numpy-seeded inputs.
The reference's (data 2, seq 4) runs at seq 4 and its (fsdp 2, model 2,
seq 2) train step at (model 2, seq 2), both on 4 ranks: the output against
the JAX package's plain attention (2e-5), the gradients against
``jax.grad`` of the JAX Ulysses on the same mesh shape (1e-4), a head
count the axis does not divide (the reference's count in the message),
the plain result with no mesh, and the train step against the JAX
``Trainer`` on the same mesh shape (losses, grad norms and weights within
``FP32_TOL``), also on (fsdp 2, seq 2). Beside them: a head count that
``model`` does not divide, whose every head each rank then runs, is the
count the check sees; and ``train_llama --attn ring|ulysses --fsdp 2
--seq-axis 2`` on 4 ranks launched as torchrun launches them (a second
world, started with the first).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_mesh_train import (
    FP32_TOL,
    WORLD,
    World,
    _batches,
    _config,
    _train_case,
    _free_port,
    case_result,
    run_cases,
    start_world,
)
from test_torch_ring_attention import (
    ATOL,
    GRAD_TOL,
    RTOL,
    SEQ_LEN,
    _mesh,
    assert_trajectory,
    attention_case,
    jax_trajectory,
    jax_trees,
    qkv,
    tree_key,
)

torch.set_num_threads(1)

#: case → (mesh sizes, ranks (None: all), step options, config changes from
#: fp32 ``tiny``)
TRAIN_CASES = {
    "ulysses_model2_seq2": (dict(model=2, seq=2), None, {},
                            dict(attn_impl="ulysses")),
    "ulysses_fsdp2_seq2": (dict(fsdp=2, seq=2), None, {},
                           dict(attn_impl="ulysses")),
}
#: ``train_llama`` on (fsdp 2, seq 2), each attention over the sequence
CLI_ARGV = {attn: ["--config", "tiny", "--device", "cpu", "--attn", attn,
                   "--fsdp", "2", "--seq-axis", "2", "--steps", "2",
                   "--batch", "4", "--seq-len", "32"]
            for attn in ("ring", "ulysses")}


def _cli_rank(rank: int, world: int, port: str, argvs: list,
              out: str) -> None:
    """A torchrun-launched rank: its variables, then ``train_llama`` once
    for each argument list (the world the first call joins stays up)."""
    import os
    import pickle

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=port)
    from tpu_on_k8s_torch import train_llama
    losses = [train_llama.main(argv) for argv in argvs]
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(losses, f)


def _ulysses_world(rank: int, world: int, arrays, grad_arrays, trees,
                   batches):
    from tpu_on_k8s_torch.parallel.ulysses import ulysses_attention

    def raises(fn) -> str | None:
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    def six_heads():
        q = torch.zeros(2, 256, 6, 32)
        return raises(lambda: ulysses_attention(q, q, q,
                                                mesh=_mesh(dict(seq=4))))

    def gathered_heads():
        # one head: model 2 does not divide it, so each rank runs it whole,
        # and that count must divide over seq
        from tpu_on_k8s_torch.models.params import init_params
        changes = dict(attn_impl="ulysses", n_heads=1, n_kv_heads=1)
        params = init_params(_config(changes),
                             torch.Generator().manual_seed(0), "cpu",
                             torch.float32)
        return raises(lambda: _train_case(rank, dict(model=2, seq=2), None,
                                          {}, changes, params, batches))

    cases = {f"match_{causal}": (
        lambda c=causal: attention_case(ulysses_attention, arrays, c,
                                        dict(seq=4), False))
        for causal in (True, False)}
    cases["grads"] = lambda: attention_case(ulysses_attention, grad_arrays,
                                            True, dict(seq=4), True)
    cases["six_heads"] = six_heads
    cases.update({name: (lambda s=shape, r=ranks, o=options, c=changes:
                         _train_case(rank, s, r, o, c, trees[tree_key(c)],
                                     batches))
                  for name, (shape, ranks, options, changes)
                  in TRAIN_CASES.items()})
    # last: it stops a step midway
    cases["gathered_heads"] = gathered_heads
    return run_cases(rank, cases)


@pytest.fixture(scope="module")
def inputs():
    batches = _batches(l=SEQ_LEN + 1)
    return qkv(), qkv(b=2, l=128, h=4, d=16), batches, jax_trees(
        TRAIN_CASES, batches)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The port's world, started before the JAX cases compute."""
    from tpu_on_k8s_torch.models import params as pparams
    arrays, grad_arrays, batches, jtrees = inputs
    trees = {k: pparams.from_jax_params(t, torch.float32, "cpu")
             for k, t in jtrees.items()}
    tmp = tmp_path_factory.mktemp("ulysses")
    main = start_world(_ulysses_world,
                       (arrays, grad_arrays, trees,
                        [torch.from_numpy(b) for b in batches]), tmp)
    cli = World(_cli_rank, (WORLD, str(_free_port()),
                            list(CLI_ARGV.values()), str(tmp / "cli")),
                WORLD, timeout=240.0)
    return main, cli, tmp / "cli"


@pytest.fixture(scope="module")
def reference(inputs, world):
    """The JAX package's results of every case (while the world runs)."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import xla_attention
    from tpu_on_k8s.parallel.mesh import MeshConfig as JMeshConfig
    from tpu_on_k8s.parallel.mesh import create_mesh as jcreate_mesh
    from tpu_on_k8s.parallel.ulysses import ulysses_attention as julysses

    arrays, grad_arrays, batches, jtrees = inputs
    q, k, v = (jnp.asarray(a) for a in arrays)
    want = {f"match_{c}": np.asarray(xla_attention(q, k, v, causal=c))
            for c in (True, False)}
    mesh = jcreate_mesh(JMeshConfig(data=1, fsdp=1, model=1, seq=4),
                        jax.devices()[:WORLD])
    gq, gk, gv = (jnp.asarray(a) for a in grad_arrays)
    want["grads"] = [np.asarray(g) for g in jax.grad(
        lambda *a: jnp.sum(julysses(*a, causal=True, mesh=mesh) ** 2),
        argnums=(0, 1, 2))(gq, gk, gv)]
    for name, (shape, _, options, changes) in TRAIN_CASES.items():
        want[name] = jax_trajectory(shape, options, changes,
                                    jtrees[tree_key(changes)], batches)
    return want


@pytest.fixture(scope="module")
def port_results(reference, world):
    return world[0]()


@pytest.mark.parametrize("causal", [True, False])
def test_matches_full_attention(causal, reference, port_results):
    np.testing.assert_allclose(case_result(port_results, f"match_{causal}"),
                               reference[f"match_{causal}"], atol=ATOL,
                               rtol=RTOL)


def test_gradients_match(reference, port_results):
    got = case_result(port_results, "grads")
    for g, w, name in zip(got, reference["grads"], "qkv"):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_heads_not_divisible_raises(port_results):
    message = case_result(port_results, "six_heads")
    assert message is not None and "n_heads 6" in message, message


def test_no_mesh_falls_back():
    from tpu_on_k8s.models.transformer import xla_attention

    from tpu_on_k8s_torch.parallel.ulysses import ulysses_attention
    arrays = qkv(l=64)
    got = ulysses_attention(*(torch.from_numpy(a) for a in arrays),
                            causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla_attention(
        *arrays, causal=True)), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_with_ulysses_model(case, reference, port_results):
    assert_trajectory(case_result(port_results, case), reference[case], case)


def test_heads_model_does_not_divide_are_the_ranks_count(port_results):
    """One head over ``model`` 2: each rank runs it whole (the gathered
    layout), so Ulysses sees one head a rank, which ``seq`` 2 does not
    divide; the message names the rank's count and the model's."""
    message = case_result(port_results, "gathered_heads")
    assert message is not None and (
        "per-device head count 1 (n_heads 1 over model=2)" in message), (
        message)


def test_train_llama_splits_the_sequence(port_results, world):
    """``train_llama --attn ring`` and ``--attn ulysses`` with ``--fsdp 2
    --seq-axis 2`` on four ranks launched as torchrun launches them:
    every rank ends each run on the same finite loss of the global
    batch."""
    _, cli, out = world
    losses = cli.results(out)
    for i, attn in enumerate(CLI_ARGV):
        got = [rank[i] for rank in losses]
        assert np.isfinite(got[0]) and len(set(got)) == 1, (attn, got)
