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
#: ``tests/test_torch_int8.py``'s int8 trajectory tolerances: a row-parallel
#: product adds its fp32 partial sums over the ranks in another order than
#: the unsharded epilogue, and the int8 values round alike.
TRAJ_TOL = dict(loss=2e-5, grad_norm=1.5e-5, params=1e-5)
INT8 = dict(mlp_int8=True, attn_int8=True, head_int8=True,
            mlp_fused_gateup=True, int8_impl="xla")

#: case → (mesh sizes, ranks of the mesh (None: all), step options, config
#: changes from fp32 ``tiny`` (4 query heads on 2 kv heads))
CASES = {
    "fsdp4": (dict(fsdp=4), None, {}, {}),
    "fsdp2_model2": (dict(fsdp=2, model=2), None, {}, {}),
    "data2_fsdp2": (dict(data=2, fsdp=2), None, {}, {}),
    "packed_fsdp2": (dict(fsdp=2), [0, 1], dict(segment_eos=EOS), {}),
    "chunked_fsdp2_model2": (dict(fsdp=2, model=2), None,
                             dict(loss_chunks=4, segment_eos=EOS), {}),
    # the fused rows kept in the reference's order, gathered per block
    "fused_fsdp2_model2": (dict(fsdp=2, model=2), None, {},
                           dict(fused_qkv=True, mlp_fused_gateup=True)),
    # the int8 recipes on local blocks, row-parallel absmax all-reduced
    "int8_fsdp2_model2": (dict(fsdp=2, model=2), None, {}, INT8),
    # GQA rep 2 under a fused split: rank r's q heads read kv head r
    "gqa2_fused_model2": (dict(model=2), [0, 1], {}, dict(fused_qkv=True)),
    # the 2 kv heads do not divide over 4: gathered whole on every rank
    "uneven_model4": (dict(model=4), None, {}, {}),
}
TOLS = {"int8_fsdp2_model2": TRAJ_TOL}

#: F5's cases: (mesh sizes, config changes from ``tiny`` with the flash
#: kernels' operators, global batch rows); each rank counts one step on
#: its rows (``train_step_flops``)
FLOP_CASES = {
    "flops_fsdp4": (dict(fsdp=4), {}, 4),
    "flops_fsdp2_model2": (dict(fsdp=2, model=2), {}, 4),
    # 2 heads over model 4: every rank runs the whole attention
    "flops_whole_attn_model4": (dict(model=4), dict(n_heads=2,
                                                   n_kv_heads=2), 4),
}
FLOP_LEN = 16

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


class World:
    """``fn(rank, *args)`` started on ``world`` spawned processes, not
    waited for: ``join()`` waits under ``timeout`` seconds (from the
    start), then terminates them (a hang fails the caller, not the
    suite's clock); ``results(out)`` joins them and reads what each rank
    pickled to ``{out}.{rank}``."""

    def __init__(self, fn: Callable, args: tuple, world: int,
                 timeout: float) -> None:
        import torch.multiprocessing as mp
        self.deadline = time.monotonic() + timeout
        self.world = world
        self.ctx = mp.start_processes(fn, args=args, nprocs=world,
                                      join=False, start_method="spawn")

    def join(self) -> None:
        try:
            while not self.ctx.join(
                    timeout=max(self.deadline - time.monotonic(), 0.1)):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"the world of {self.world} ranks "
                                       f"did not finish in time")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.terminate()

    def results(self, out: Path) -> list:
        self.join()
        got = []
        for r in range(self.world):
            with open(f"{out}.{r}", "rb") as f:
                got.append(pickle.load(f))
        return got


def start_world(body: Callable, args: tuple, tmp: Path, world: int = WORLD,
                timeout: float = 240.0) -> Callable[[], object]:
    """Start ``body(rank, world, *args)`` on ``world`` spawned gloo ranks
    (rendezvous through a ``FileStore`` under ``tmp``); the returned
    callable joins them and returns rank 0's result."""
    out = tmp / "rank0.pkl"
    spawned = World(_world_main, (world, str(tmp / "store"), body, args,
                                  str(out)), world, timeout)

    def result():
        spawned.join()
        with open(out, "rb") as f:
            return pickle.load(f)

    return result


def run_world(body: Callable, args: tuple, tmp: Path, world: int = WORLD,
              timeout: float = 240.0):
    """Run ``body(rank, world, *args)`` on ``world`` spawned gloo ranks
    and return rank 0's result (``start_world``, joined)."""
    return start_world(body, args, tmp, world, timeout)()


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


def _config(changes: dict, dtype=torch.float32):
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    return dataclasses.replace(TransformerConfig.tiny(), dtype=dtype,
                               **changes)


def _train_case(rank: int, shape: dict, ranks, options: dict, changes: dict,
                params: Dict[str, torch.Tensor], batches) -> dict:
    from tpu_on_k8s_torch.models.params import load_model
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.train import Trainer, default_optimizer

    cfg = _config(changes)
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


def _flops_case(shape: dict, changes: dict, rows: int) -> list:
    """Every rank's count of one step on its rows, in rank order."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.train import Trainer
    from tpu_on_k8s_torch.train.compile import train_step_flops

    cfg = _config(dict(attn_impl="flash", **changes))
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu", torch.float32), "cpu")
    trainer = Trainer(model, rules=flagship_partition_rules(),
                      mesh=create_mesh(MeshConfig(**{"fsdp": 1, **shape}),
                                       device="cpu"))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (rows, FLOP_LEN + 1)).astype(np.int32))
    flops, _ = train_step_flops(trainer, trainer.state(),
                                trainer.shard_batch(tokens))
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, flops)
    return counts


def _mesh_train_world(rank: int, world: int, trees, batches):
    cases = {name: (lambda s=shape, r=ranks, o=options, c=changes:
                    _train_case(rank, s, r, o, c, trees[_tree_key(c)],
                                batches))
             for name, (shape, ranks, options, changes) in CASES.items()}
    cases.update({name: (lambda a=args: _flops_case(*a))
                  for name, args in FLOP_CASES.items()})
    return run_cases(rank, cases)


def _tree_key(changes: dict) -> tuple:
    """The weights a case starts from: one tree per parameter layout."""
    return tuple(sorted((k, changes[k]) for k in ("fused_qkv",
                                                  "mlp_fused_gateup")
                        if changes.get(k)))


def _cli_rank(rank: int, world: int, store: str, argv: list,
              out: str) -> None:
    """A torchrun-launched ``train_llama``: its variables, then the CLI."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=store)
    from tpu_on_k8s_torch import train_llama
    loss = train_llama.main(argv)
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump(loss, f)


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


def _jax_config(changes: dict):
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
    return dataclasses.replace(JConfig.tiny(), dtype=jnp.float32, **changes)


#: the CLI's world: ``train_llama --int8`` on (fsdp 2, model 2)
CLI_ARGV = ["--config", "tiny", "--device", "cpu", "--int8", "--fsdp", "2",
            "--model-axis", "2", "--steps", "3", "--batch", "4",
            "--seq-len", "16"]


@pytest.fixture(scope="module")
def trees():
    """The batches and the JAX weights of each parameter layout."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    batches = _batches()
    out = {}
    for *_, changes in CASES.values():
        key = _tree_key(changes)
        if key not in out:
            out[key] = jax.tree.map(np.asarray, JTransformer(
                _jax_config(dict(key))).init(
                    jax.random.key(1),
                    jnp.asarray(batches[0][:, :-1]))["params"])
    return out, batches


@pytest.fixture(scope="module")
def worlds(trees, tmp_path_factory):
    """The port's world of every case and the CLI's, started before the
    JAX trajectories compute."""
    from tpu_on_k8s_torch.models import params as pparams
    jtrees, batches = trees
    params = {k: pparams.from_jax_params(t, torch.float32, "cpu")
              for k, t in jtrees.items()}
    tmp = tmp_path_factory.mktemp("mesh_train")
    main = start_world(_mesh_train_world,
                       (params, [torch.from_numpy(b) for b in batches]), tmp)
    cli = World(_cli_rank, (WORLD, str(_free_port()), CLI_ARGV,
                            str(tmp / "cli")), WORLD, timeout=240.0)
    return main, cli, tmp / "cli"


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def reference(trees, worlds):
    """The JAX trajectory of every case on its mesh over the CPU
    platform's devices (while the port's worlds run)."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    from tpu_on_k8s.models.transformer import (
        flagship_partition_rules as jrules,
    )
    from tpu_on_k8s.parallel.mesh import MeshConfig as JMeshConfig
    from tpu_on_k8s.parallel.mesh import create_mesh as jcreate_mesh
    from tpu_on_k8s.parallel.partition import shard_pytree as jshard
    from tpu_on_k8s.train import trainer as jtrainer

    jtrees, batches = trees
    want = {}
    for name, (shape, ranks, options, changes) in CASES.items():
        n = len(ranks) if ranks else WORLD
        mesh = jcreate_mesh(JMeshConfig(**{"fsdp": 1, **shape}),
                            jax.devices()[:n])
        opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=STEPS)
        trainer = jtrainer.Trainer(JTransformer(_jax_config(changes)),
                                   jrules(), mesh, opt, **options)
        # fresh arrays a case: the step donates its state
        jparams = jax.tree.map(jnp.asarray, jtrees[_tree_key(changes)])
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
    return batches, want


@pytest.fixture(scope="module")
def port_results(reference, worlds):
    return worlds[0]()


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_trajectory_matches_jax(case, reference, port_results):
    from tpu_on_k8s_torch.models import params as pparams
    got = case_result(port_results, case)
    losses, norms, wtree = reference[1][case]
    tol = TOLS.get(case, FP32_TOL)
    np.testing.assert_allclose(got["losses"], losses, atol=tol["loss"],
                               rtol=0)
    np.testing.assert_allclose(got["norms"], norms,
                               rtol=tol["grad_norm"], atol=0)
    expected = pparams.from_jax_params(wtree, torch.float32, "cpu")
    assert set(expected) == set(got["params"])
    for name, w in expected.items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   atol=tol["params"], rtol=0,
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


def test_packed_ranks_count_different_targets(trees):
    """The packed case's two fsdp ranks hold rows with different counted
    targets, so a mean of per-rank means would not be the reference's
    objective: the case above holds the global mean."""
    _, batches = trees
    counts = []
    for rows in (batches[0][:2], batches[0][2:]):
        seg = np.cumsum(rows == EOS, axis=1) - (rows == EOS)
        counts.append(int((seg[:, :-1] == seg[:, 1:]).sum()))
    assert counts[0] != counts[1]


def _products(changes: dict, b: int, l: int, n_model: int = 1):
    """(the dense products, the attention products) of one training step
    on ``b`` rows of ``l`` tokens, by hand (``test_torch_train_loop.py``'s
    count): each dense layer's forward 2·T·in·out and its backward twice
    that, the head's likewise, over a ``model`` axis of ``n_model``; the
    flash forward, dq and dk/dv over the causal pairs."""
    cfg = _config(changes)
    d, hd = cfg.d_model, cfg.head_dim
    dense = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
             + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    pairs = l * (l + 1) // 2
    return (3 * 2 * b * l * (cfg.n_layers * dense + d * cfg.vocab_size)
            // n_model,
            cfg.n_layers * (4 + 6 + 8) * b * cfg.n_heads * hd * pairs)


def test_train_step_flops_count_each_ranks_own_products(port_results):
    """F5: on a mesh each rank counts the products its own program runs.
    On (fsdp 4) a rank's count is the meshless count of its one row; on
    (fsdp 2, model 2), head parallel, the ranks' counts add up to the
    global batch's (nothing runs twice); where the heads do not divide
    (2 heads over model 4) every rank runs the whole attention and counts
    it, with a quarter of every dense product."""
    for name, (_, changes, rows) in FLOP_CASES.items():
        got = case_result(port_results, name)
        assert len(got) == WORLD and len(set(got)) == 1, (name, got)
    assert case_result(port_results, "flops_fsdp4") == [
        sum(_products({}, 1, FLOP_LEN))] * WORLD
    assert sum(case_result(port_results, "flops_fsdp2_model2")) == sum(
        _products({}, 4, FLOP_LEN))
    changes = FLOP_CASES["flops_whole_attn_model4"][1]
    assert case_result(port_results, "flops_whole_attn_model4") == [
        sum(_products(changes, 4, FLOP_LEN, n_model=4))] * WORLD


def test_fused_rows_stay_in_the_reference_order(port_results):
    """The fused weights are stored as the rules say, a plain split of the
    reference's q | k | v and gate | up rows (what DCP, the reshard and the
    JAX export read); the int8 recipes keep their projections' layouts."""
    got = case_result(port_results, "fused_fsdp2_model2")["placements"]
    assert got["blocks.0.attn.wqkv.weight"] == ("S(1)", "S(0)")
    assert got["blocks.0.mlp.w_gateup.weight"] == ("S(1)", "S(0)")
    got = case_result(port_results, "int8_fsdp2_model2")["placements"]
    assert got["blocks.1.attn.wq.weight"] == ("S(1)", "S(0)")
    assert got["blocks.1.mlp.w_down.weight"] == ("S(0)", "S(1)")
    assert got["lm_head"] == ("S(0)", "S(1)")


def test_train_llama_int8_on_a_model_axis(port_results, worlds):
    """``train_llama --int8 --fsdp 2 --model-axis 2`` on four ranks
    launched as torchrun launches them: every rank ends on the same
    finite loss of the global batch."""
    _, cli, out = worlds
    losses = cli.results(out)
    assert np.isfinite(losses[0]) and len(set(losses)) == 1, losses
