"""The port's ring attention against the JAX package's, on the CPU.

The reference's ``tests/test_ring_attention.py`` runs on its 8-device CPU
mesh; here the port runs in one spawned world of 4 gloo ranks
(``test_torch_mesh_train.start_world``), every case inside it, while the
JAX package computes the same cases in this process on numpy-seeded
inputs. The reference's seq 4 and 8 run at seq 2 and 4 (4 ranks): the
output against the JAX package's plain attention (2e-5, the reference's
tolerance), ``ring_context``, the plain result with no mesh, an
indivisible length, the gradients against ``jax.grad`` of the JAX ring
(1e-4), and the train step with
``attn_impl="ring"`` on (model 2, seq 2) and (fsdp 2, seq 2) against the
JAX ``Trainer`` on the same mesh shape (losses, grad norms and weights
within ``FP32_TOL``), the latter under a full remat. Beside them: the
gathered route (``attn_impl="flash"`` on seq 2, on packed windows), a tiny
GPT-2 (learned positions) on the ring, the per-rank FLOP counts on seq 2
and the loop's ``mfu``, and the ring's bodies run in lockstep in one
process (``train_llama --attn ring --seq-axis 2`` runs in
``test_torch_ulysses.py``'s CLI world).

This module imports no JAX at its top: its rank bodies run in spawned
processes that import it, and so do the two worker processes that compile
the JAX trajectories beside this one (``jax_job``). The trajectory
helpers are shared with ``test_torch_ulysses.py``.
"""
from __future__ import annotations

import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_mesh_train import (
    EOS,
    FP32_TOL,
    STEPS,
    WORLD,
    _batches,
    _config,
    _jax_config,
    _train_case,
    case_result,
    run_cases,
    start_world,
)

torch.set_num_threads(1)

#: the reference's attention tolerances
ATOL = RTOL = 2e-5
GRAD_TOL = 1e-4
#: the training batches' length: L = 32, chunks of 16 on seq 2 (the JAX
#: ring's Pallas kernel needs chunks of a multiple of 8)
SEQ_LEN = 32
#: the tiny GPT-2 family's flags (learned positions, LayerNorm, GELU, tied
#: head), as ``test_torch_gpt2.py``'s
GPT2 = dict(pos_emb="learned", norm="ln", activation="gelu",
            tie_embeddings=True, n_kv_heads=4)
#: the reference's causal x seq cases (seq 4, 8) at seq 2, 4
MATCH_CASES = [(causal, seq) for causal in (True, False) for seq in (2, 4)]

#: case → (mesh sizes, ranks (None: all), step options, config changes from
#: fp32 ``tiny``), run by ``test_torch_mesh_train._train_case``
TRAIN_CASES = {
    "ring_model2_seq2": (dict(model=2, seq=2), None, {},
                         dict(attn_impl="ring")),
    # a full remat re-runs the ring's forward inside the backward
    "ring_remat_fsdp2_seq2": (dict(fsdp=2, seq=2), None, {},
                              dict(attn_impl="ring", remat=True)),
    # xla reshards; the port gathers q/k/v and the segments over seq
    "flash_packed_fsdp2_seq2": (dict(fsdp=2, seq=2), None,
                                dict(segment_eos=EOS),
                                dict(attn_impl="flash")),
    "gpt2_ring_fsdp2_seq2": (dict(fsdp=2, seq=2), None, {},
                             dict(attn_impl="ring", **GPT2)),
}


def qkv(b=2, l=256, h=4, d=32, seed=0):
    """The reference's ``_qkv`` shapes, from a numpy seed (fp32)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, l, h, d)).astype(np.float32)
                 for _ in range(3))


def tree_key(changes: dict) -> tuple:
    """The weights a case starts from: one tree per parameter layout."""
    return tuple(sorted((k, v) for k, v in changes.items() if k in GPT2))


# ---- the spawned world ------------------------------------------------------

def _mesh(shape: dict):
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    return create_mesh(MeshConfig(**{"fsdp": 1, **shape}), device="cpu")


def attention_case(fn, arrays, causal: bool, shape: dict, grads: bool):
    """``fn`` (the port's ``ring_attention`` or ``ulysses_attention``) on
    whole fp32 q/k/v over a mesh of ``shape``: the output, and with
    ``grads`` the gradients of Σ out² (the reference's objective)."""
    q, k, v = (torch.from_numpy(a).clone().requires_grad_(grads)
               for a in arrays)
    out = fn(q, k, v, causal=causal, mesh=_mesh(shape))
    if not grads:
        return out.detach().numpy()
    (out ** 2).sum().backward()
    return [t.grad.numpy() for t in (q, k, v)]


def flops_case(rank: int, batches) -> dict:
    """Each rank's ``train_step_flops`` of a ring step on (fsdp 2, seq 2),
    and the ``mfu`` gauge of a ``TrainLoop`` fed with it."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.metrics import TrainMetrics
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
    from tpu_on_k8s_torch.train import Trainer
    from tpu_on_k8s_torch.train.compile import train_step_flops
    from tpu_on_k8s_torch.train.loop import TrainLoop

    cfg = _config(dict(attn_impl="ring"))
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu", torch.float32), "cpu")
    trainer = Trainer(model, rules=flagship_partition_rules(),
                      mesh=_mesh(dict(fsdp=2, seq=2)))
    batch = trainer.shard_batch(batches[0])
    flops, step = train_step_flops(trainer, trainer.state(), batch)
    gauges = TrainMetrics()
    TrainLoop(step, trainer.state(), (batch for _ in range(2)), log_every=2,
              metrics=gauges, tokens_per_step=int(batches[0].numel()),
              flops_per_step=flops, peak_flops=1e12).run(2)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, flops)
    return dict(counts=counts, mfu=gauges.gauges.get("mfu", math.nan))


def _ring_world(rank: int, world: int, arrays, grad_arrays, trees, batches):
    from tpu_on_k8s_torch.parallel.ring import ring_attention, ring_context

    def context():
        q, k, v = (torch.from_numpy(a) for a in arrays)
        with ring_context(_mesh(dict(seq=4))):
            return ring_attention(q, k, v, causal=True).numpy()

    def indivisible():
        q = torch.zeros(2, 130, 4, 32)
        try:
            ring_attention(q, q, q, mesh=_mesh(dict(seq=4)))
        except ValueError as e:
            return str(e)
        return None

    cases = {f"match_{causal}_{seq}": (
        lambda c=causal, s=seq: attention_case(
            ring_attention, arrays, c, dict(data=WORLD // s, seq=s), False))
        for causal, seq in MATCH_CASES}
    cases["context"] = context
    cases["indivisible"] = indivisible
    cases["grads"] = lambda: attention_case(ring_attention, grad_arrays, True,
                                            dict(seq=4), True)
    cases.update({name: (lambda s=shape, r=ranks, o=options, c=changes:
                         _train_case(rank, s, r, o, c, trees[tree_key(c)],
                                     batches))
                  for name, (shape, ranks, options, changes)
                  in TRAIN_CASES.items()})
    cases["flops"] = lambda: flops_case(rank, batches)
    return run_cases(rank, cases)


# ---- the parent: the JAX reference and the comparisons ---------------------

def jax_trees(cases: dict, batches) -> dict:
    """The JAX weights of each parameter layout the cases start from."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer as JTransformer
    out = {}
    for *_, changes in cases.values():
        key = tree_key(changes)
        if key not in out:
            init = jax.jit(JTransformer(_jax_config(dict(key))).init)
            out[key] = jax.tree.map(np.asarray, init(
                jax.random.key(1), jnp.asarray(batches[0][:, :-1]))["params"])
    return out


def jax_trajectory(shape: dict, options: dict, changes: dict, tree,
                   batches):
    """The JAX ``Trainer``'s ``STEPS`` steps on a mesh of ``shape`` over the
    CPU platform's first 4 devices: (losses, grad norms, final params), as
    ``test_torch_mesh_train.py``'s reference."""
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

    mesh = jcreate_mesh(JMeshConfig(**{"fsdp": 1, **shape}),
                        jax.devices()[:WORLD])
    opt = jtrainer.default_optimizer(warmup_steps=2, decay_steps=STEPS)
    trainer = jtrainer.Trainer(JTransformer(_jax_config(changes)), jrules(),
                               mesh, opt, **options)
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
    return losses, norms, jax.tree.map(np.asarray, state.params)


def jax_job(*args):
    """``jax_trajectory`` in a worker process: the JAX package on the CPU
    platform of 8 devices that ``tests/conftest.py`` set up through the
    environment the worker inherits, with its compilation cache."""
    import jax

    jax.config.update("jax_compilation_cache_dir",
                      str(Path(__file__).resolve().parent / ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return jax_trajectory(*args)


def assert_trajectory(got: dict, want, case: str, tol=FP32_TOL) -> None:
    from tpu_on_k8s_torch.models import params as pparams
    losses, norms, wtree = want
    np.testing.assert_allclose(got["losses"], losses, atol=tol["loss"],
                               rtol=0)
    np.testing.assert_allclose(got["norms"], norms, rtol=tol["grad_norm"],
                               atol=0)
    expected = pparams.from_jax_params(wtree, torch.float32, "cpu")
    assert set(expected) == set(got["params"])
    for name, w in expected.items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   atol=tol["params"], rtol=0,
                                   err_msg=f"{case}: {name}")


@pytest.fixture(scope="module")
def inputs():
    batches = _batches(l=SEQ_LEN + 1)
    return qkv(), qkv(b=1, l=128, h=2, d=16), batches, jax_trees(
        TRAIN_CASES, batches)


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The port's world, started before the JAX cases compute."""
    from tpu_on_k8s_torch.models import params as pparams
    arrays, grad_arrays, batches, jtrees = inputs
    trees = {k: pparams.from_jax_params(t, torch.float32, "cpu")
             for k, t in jtrees.items()}
    return start_world(_ring_world, (arrays, grad_arrays, trees,
                                     [torch.from_numpy(b) for b in batches]),
                       tmp_path_factory.mktemp("ring"))


@pytest.fixture(scope="module")
def reference(inputs, world):
    """The JAX package's results of every case (while the world runs)."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import xla_attention
    from tpu_on_k8s.parallel.mesh import MeshConfig as JMeshConfig
    from tpu_on_k8s.parallel.mesh import create_mesh as jcreate_mesh
    from tpu_on_k8s.parallel.ring import ring_attention as jring

    arrays, grad_arrays, batches, jtrees = inputs
    # the trajectories compile in two worker processes beside this one
    with ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {name: pool.submit(jax_job, shape, options, changes,
                                     jtrees[tree_key(changes)], batches)
                   for name, (shape, _, options, changes)
                   in TRAIN_CASES.items()}
        q, k, v = (jnp.asarray(a) for a in arrays)
        want = {"plain": {c: np.asarray(xla_attention(q, k, v, causal=c))
                          for c in (True, False)}}
        mesh = jcreate_mesh(JMeshConfig(data=1, fsdp=1, model=1, seq=4),
                            jax.devices()[:WORLD])
        gq, gk, gv = (jnp.asarray(a) for a in grad_arrays)
        want["grads"] = [np.asarray(g) for g in jax.grad(
            lambda *a: jnp.sum(jring(*a, causal=True, mesh=mesh) ** 2),
            argnums=(0, 1, 2))(gq, gk, gv)]
        want.update({name: f.result() for name, f in futures.items()})
    return want


@pytest.fixture(scope="module")
def port_results(reference, world):
    return world()


@pytest.mark.parametrize("causal, seq", MATCH_CASES)
def test_matches_full_attention(causal, seq, reference, port_results):
    got = case_result(port_results, f"match_{causal}_{seq}")
    np.testing.assert_allclose(got, reference["plain"][causal], atol=ATOL,
                               rtol=RTOL)


def test_context_manager_supplies_mesh(reference, port_results):
    np.testing.assert_allclose(case_result(port_results, "context"),
                               reference["plain"][True], atol=ATOL,
                               rtol=RTOL)


def test_no_mesh_falls_back_to_plain():
    from tpu_on_k8s.models.transformer import xla_attention

    from tpu_on_k8s_torch.parallel.ring import ring_attention
    arrays = qkv(l=64)
    got = ring_attention(*(torch.from_numpy(a) for a in arrays), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla_attention(
        *arrays, causal=True)), atol=ATOL, rtol=RTOL)


def test_indivisible_seq_raises(port_results):
    message = case_result(port_results, "indivisible")
    assert message is not None and "divisible" in message, message


def test_gradients_match_full_attention(reference, port_results):
    got = case_result(port_results, "grads")
    for g, w, name in zip(got, reference["grads"], "qkv"):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name} mismatch")


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_step_with_sequence_split_model(case, reference, port_results):
    """A ``Trainer`` on a mesh with ``seq`` 2 trains as the JAX
    ``Trainer`` on the same mesh shape: ring attention (with ``model`` 2;
    with ``fsdp`` 2 under a full remat; on GPT-2's learned positions) and
    the gathered flash attention on packed windows."""
    assert_trajectory(case_result(port_results, case), reference[case], case)


def test_ring_bodies_in_lockstep_match_full_attention():
    """The ring's per-rank bodies, each fed the chunks it would receive
    (``ring_in_lockstep``: the seam a check on one card drives), give the
    whole attention's output, lse and gradients, causal and not."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import xla_attention

    from tpu_on_k8s_torch.ops.flash_attention import flash_attention_plain
    from tpu_on_k8s_torch.parallel.ring import (
        ring_backward,
        ring_forward,
        ring_in_lockstep,
    )
    n = 4
    arrays = qkv(b=1, l=128, h=2, d=16, seed=3)
    do = np.random.default_rng(4).standard_normal(arrays[0].shape).astype(
        np.float32)
    for causal in (True, False):
        q, k, v, g = (torch.from_numpy(a).transpose(1, 2).contiguous()
                      for a in (*arrays, do))
        chunks = [t.chunk(n, dim=2) for t in (q, k, v, g)]
        fwd = ring_in_lockstep([ring_forward(
            chunks[0][r], chunks[1][r], chunks[2][r], r, n, causal)
            for r in range(n)])
        o = torch.cat([f[0] for f in fwd], dim=2)
        lse = torch.cat([f[1] for f in fwd], dim=3)
        bwd = ring_in_lockstep([ring_backward(
            chunks[0][r], chunks[1][r], chunks[2][r], fwd[r][0], fwd[r][1],
            chunks[3][r], r, n, causal) for r in range(n)])
        grads = [torch.cat([b[i] for b in bwd], dim=2).transpose(1, 2)
                 for i in range(3)]
        jq, jk, jv = (jnp.asarray(a) for a in arrays)
        np.testing.assert_allclose(
            o.transpose(1, 2).numpy(),
            np.asarray(xla_attention(jq, jk, jv, causal=causal)), atol=ATOL,
            rtol=RTOL)
        np.testing.assert_allclose(
            lse.numpy(), flash_attention_plain(q, k, v, causal)[1].numpy(),
            atol=ATOL, rtol=RTOL)
        want = jax.vjp(lambda *a: xla_attention(*a, causal=causal),
                       jq, jk, jv)[1](jnp.asarray(do))
        for got, w, name in zip(grads, want, "qkv"):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       atol=GRAD_TOL, rtol=GRAD_TOL,
                                       err_msg=f"causal={causal} d{name}")


def test_step_flops_on_seq_add_up_to_the_whole_batch(inputs, port_results):
    """On (fsdp 2, seq 2) each rank counts its own chunk's products; the
    ring's kernels on the diagonal (causal) and past (whole) chunks count
    the causal pairs of the whole sequence, so the four ranks' counts add
    up to the meshless step's on the whole batch; the loop's ``mfu`` is
    finite."""
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.train import Trainer
    from tpu_on_k8s_torch.train.compile import train_step_flops

    got = case_result(port_results, "flops")
    cfg = _config(dict(attn_impl="flash"))
    model = load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                        "cpu", torch.float32), "cpu")
    trainer = Trainer(model)
    whole, _ = train_step_flops(trainer, trainer.state(),
                                torch.from_numpy(inputs[2][0]))
    assert sum(got["counts"]) == whole, (got["counts"], whole)
    assert math.isfinite(got["mfu"]) and got["mfu"] > 0
