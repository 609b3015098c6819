"""The port's sharded training step against the JAX package's, on the CPU.

``tiny`` in fp32 trains 3 steps on a mesh in both packages from the same
weights (initialised by JAX, carried across with ``from_jax_params``) and
the same numpy-seeded batches: the reference's ``Trainer(model,
flagship_partition_rules(), mesh, opt)`` over ``jax.devices()[:n]`` of the
8-device CPU platform, and the port's ``Trainer(model, opt, rules=...,
mesh=...)`` over a world of 4 gloo ranks, spawned once for the module
(``run_world``; a ``FileStore`` under ``tmp_path``, its own timeout). The
meshes: (fsdp 4), (fsdp 2, model 2) and (data 2, fsdp 2); a packed batch at
fsdp 2 (on ranks {0, 1}: each rank's rows count other targets, so the mean
must be over the global count) and the chunked loss at (fsdp 2, model 2)
(the vocab-sharded head). Losses, grad norms and the final weights agree
within ``test_torch_train_step.py``'s ``FP32_TOL``.

This module imports no JAX at its top: its rank bodies run in spawned
processes that import it. ``run_world`` is shared with the other mesh test
files.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
import traceback
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import pytest
import torch

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

STEPS = 3
EOS = 3
WORLD = 4
#: ``tests/test_torch_train_step.py``'s fp32 tolerances (the packages differ
#: in summation order only; a mesh adds the order of the cross-rank sums).
FP32_TOL = dict(loss=5e-6, grad_norm=1e-6, params=1.5e-6)

#: case → (mesh sizes, ranks of the mesh (None: all), step options)
CASES = {
    "fsdp4": (dict(fsdp=4), None, {}),
    "fsdp2_model2": (dict(fsdp=2, model=2), None, {}),
    "data2_fsdp2": (dict(data=2, fsdp=2), None, {}),
    "packed_fsdp2": (dict(fsdp=2), [0, 1], dict(segment_eos=EOS)),
    "chunked_fsdp2_model2": (dict(fsdp=2, model=2), None,
                             dict(loss_chunks=4, segment_eos=EOS)),
}


# ---- the spawned world ------------------------------------------------------

def _world_main(rank: int, world: int, store: str, body: Callable,
                args: tuple, out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world)
    try:
        result = body(rank, world, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_world(body: Callable, args: tuple, tmp: Path, world: int = WORLD,
              timeout: float = 240.0):
    """Run ``body(rank, world, *args)`` on ``world`` spawned gloo ranks
    (rendezvous through a ``FileStore`` under ``tmp``) and return rank 0's
    result. Joined under ``timeout`` seconds, then terminated: a hang fails
    the caller, not the suite's clock."""
    import torch.multiprocessing as mp
    out = tmp / "rank0.pkl"
    ctx = mp.start_processes(
        _world_main, args=(world, str(tmp / "store"), body, args, str(out)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the world of {world} ranks did not "
                                   f"finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    with open(out, "rb") as f:
        return pickle.load(f)


def run_cases(rank: int, cases: Dict[str, Callable]) -> Dict[str, object]:
    """Every case on every rank, in order; a case's failure is recorded (as
    its traceback) and the next one runs."""
    results = {}
    for name, fn in cases.items():
        try:
            results[name] = fn()
        except Exception:  # noqa: BLE001 — reported by the case's test
            results[name] = RuntimeError(f"rank {rank}, case {name}:\n"
                                         f"{traceback.format_exc()}")
    return results


def case_result(results: Dict[str, object], name: str):
    got = results[name]
    if isinstance(got, Exception):
        raise got
    return got


def _train_case(rank: int, shape: dict, ranks, options: dict,
                params: Dict[str, torch.Tensor], batches) -> dict:
    from tpu_on_k8s_torch.models.params import load_model
    from tpu_on_k8s_torch.models.transformer import (
        TransformerConfig,
        flagship_partition_rules,
    )
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.train import Trainer, default_optimizer

    cfg = dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float32)
    mesh = create_mesh(MeshConfig(**{"fsdp": 1, **shape}), ranks=ranks,
                       device="cpu")
    if mesh.get_coordinate() is None:
        return {}
    model = load_model(cfg, {k: v.clone() for k, v in params.items()}, "cpu")
    opt = default_optimizer(model.parameters(), warmup_steps=2,
                            decay_steps=STEPS)
    trainer = Trainer(model, opt, rules=flagship_partition_rules(),
                      mesh=mesh, **options)
    losses, norms = [], []
    for i in range(STEPS):
        m = trainer.train_step(trainer.shard_batch(batches[i % 2]))
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    full = {n: p.full_tensor().detach().clone()
            for n, p in trainer.model.named_parameters()}
    placements = {n: tuple(str(pl) for pl in p.placements)
                  for n, p in trainer.model.named_parameters()}
    return dict(losses=losses, norms=norms, params=full,
                placements=placements)


def _mesh_train_world(rank: int, world: int, params, batches):
    return run_cases(rank, {
        name: (lambda s=shape, r=ranks, o=options: _train_case(
            rank, s, r, o, params, batches))
        for name, (shape, ranks, options) in CASES.items()})


# ---- the parent: the JAX reference and the comparisons ---------------------

def _batches(b=4, l=25, seed=0, vocab=256):
    """Two token batches [b, l] with EOS separators, used alternately."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        tokens = rng.integers(4, vocab, (b, l)).astype(np.int32)
        for row in range(b):
            tokens[row, rng.choice(np.arange(1, l - 1), 3 + row,
                                   replace=False)] = EOS
        out.append(tokens)
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX weights, the batches, and the JAX trajectory of every case
    on its mesh over the CPU platform's devices."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
    from tpu_on_k8s.models.transformer import (
        flagship_partition_rules as jrules,
    )
    from tpu_on_k8s.parallel.mesh import MeshConfig as JMeshConfig
    from tpu_on_k8s.parallel.mesh import create_mesh as jcreate_mesh
    from tpu_on_k8s.parallel.partition import shard_pytree as jshard
    from tpu_on_k8s.train import trainer as jtrainer

    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32)
    batches = _batches()
    tree = jax.tree.map(np.asarray, JTransformer(jcfg).init(
        jax.random.key(1), jnp.asarray(batches[0][:, :-1]))["params"])
    want = {}
    for name, (shape, ranks, options) in CASES.items():
        n = len(ranks) if ranks else WORLD
        mesh = jcreate_mesh(JMeshConfig(**{"fsdp": 1, **shape}),
                            jax.devices()[:n])
        opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=STEPS)
        trainer = jtrainer.Trainer(JTransformer(jcfg), jrules(), mesh, opt,
                                   **options)
        # fresh arrays a case: the step donates its state
        jparams = jax.tree.map(jnp.asarray, tree)
        state = jshard(jtrainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=jparams,
            opt_state=opt.init(jparams)), mesh, jrules())
        losses, norms = [], []
        for i in range(STEPS):
            state, m = trainer.train_step(
                state, trainer.shard_batch(jnp.asarray(batches[i % 2])))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        want[name] = (losses, norms, jax.tree.map(np.asarray, state.params))
    return tree, batches, want


@pytest.fixture(scope="module")
def port_results(reference, tmp_path_factory):
    from tpu_on_k8s_torch.models import params as pparams
    tree, batches, _ = reference
    params = pparams.from_jax_params(tree, torch.float32, "cpu")
    return run_world(_mesh_train_world,
                     (params, [torch.from_numpy(b) for b in batches]),
                     tmp_path_factory.mktemp("mesh_train"))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_trajectory_matches_jax(case, reference, port_results):
    from tpu_on_k8s_torch.models import params as pparams
    got = case_result(port_results, case)
    losses, norms, wtree = reference[2][case]
    np.testing.assert_allclose(got["losses"], losses, atol=FP32_TOL["loss"],
                               rtol=0)
    np.testing.assert_allclose(got["norms"], norms,
                               rtol=FP32_TOL["grad_norm"], atol=0)
    expected = pparams.from_jax_params(wtree, torch.float32, "cpu")
    assert set(expected) == set(got["params"])
    for name, w in expected.items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   atol=FP32_TOL["params"], rtol=0,
                                   err_msg=f"{case}: {name}")


def test_layouts_are_the_rules(port_results):
    """As stored, each weight is split over fsdp on the dim its rule
    gives (not FSDP2's default dim 0) and over model as the rule says."""
    got = case_result(port_results, "fsdp2_model2")["placements"]
    assert got["blocks.0.attn.wq.weight"] == ("S(1)", "S(0)")
    assert got["blocks.0.attn.wo.weight"] == ("S(0)", "S(1)")
    assert got["blocks.0.mlp.w_down.weight"] == ("S(0)", "S(1)")
    assert got["embed"] == ("S(1)", "S(0)")
    assert got["lm_head"] == ("S(0)", "S(1)")
    # a norm's rule names no fsdp dim: FSDP2 splits dim 0
    assert got["final_norm.scale"] == ("S(0)",)
    hsdp = case_result(port_results, "data2_fsdp2")["placements"]
    assert hsdp["blocks.1.mlp.w_up.weight"] == ("R", "S(1)")


def test_packed_ranks_count_different_targets(reference):
    """The packed case's two fsdp ranks hold rows with different counted
    targets, so a mean of per-rank means would not be the reference's
    objective: the case above holds the global mean."""
    _, batches, _ = reference
    counts = []
    for rows in (batches[0][:2], batches[0][2:]):
        seg = np.cumsum(rows == EOS, axis=1) - (rows == EOS)
        counts.append(int((seg[:, :-1] == seg[:, 1:]).sum()))
    assert counts[0] != counts[1]
