"""The load driver's ``--shard`` mode in the port against the reference's,
on the CPU.

The port's ``serve_load._shard_main`` runs on one world of 4 gloo ranks,
spawned once for the module (``test_torch_serve_shard._rank_main``): every
rank makes the meshes of ``model`` 2 and 4, rank 0 drives the arms at
meshes 1, 2 and 4 and ranks 1-3 serve their shards
(``serve_mesh_worker``). The reference's ``_shard_main`` runs here, on the
8-device CPU platform, while the world computes. Both take the same flags
(the Makefile's ``shard-soak`` at fewer requests, with ``--soak``) and the
same weights: the tiny fp32 model with all four kv heads, initialised by
the JAX package and carried across with ``from_jax_params``. Each arm's
per-request tokens and event log are read off ``run_shard_trace`` before
``_shard_main`` folds them. Equal: every arm's tokens, its per-chip
parameter and KV bytes (so ``bytes_frac``, the cost-model TPOT and the
virtual clock), the largest arm's event log and its replay, the summary
(``per_chip_bytes_linear`` in it) and the printed line. The tiny config's
four kv heads and four query heads divide every mesh, so none of the
layouts ROADMAP's G10 and G12 list (a paged pool on ``data``, heads the
``model`` axis does not divide, whole attention) is on this path.

A world of one rank in this process (the card's case) reports meshes 2
and 4 as ``skipped_meshes`` with the reference's stderr line.

This module imports no JAX at its top: its rank bodies run in spawned
processes that import it. Tolerances: none.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from test_torch_mesh_train import World
from test_torch_serve_shard import _rank_main

torch.set_num_threads(1)

WORLD = 4
FLAGS = ["--shard", "--soak", "--n-requests", "12", "--prompt-min", "4",
         "--prompt-max", "12", "--new-min", "4", "--new-max", "10",
         "--seed", "1357"]


def _recording(mod, store: list):
    """``mod.run_shard_trace`` keeps each arm's tokens and event log in
    ``store`` before ``_shard_main`` pops them; returns the original."""
    orig = mod.run_shard_trace

    def run_shard_trace(*args, **kw):
        arm = orig(*args, **kw)
        store.append((kw["model_axis"], dict(arm["outputs"]),
                      list(arm["event_log"])))
        return arm

    mod.run_shard_trace = run_shard_trace
    return orig


def _port_cfg():
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    return dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float32,
                               max_seq_len=64, n_kv_heads=4)


def _drive(flags, params) -> dict:
    """The port's ``_shard_main`` on this process's world: its summary,
    printed lines and recorded arms (rank 0), or ``{}`` (a worker)."""
    from tpu_on_k8s_torch import serve_load

    store: list = []
    orig = _recording(serve_load, store)
    args = serve_load.build_parser().parse_args(flags + ["--device", "cpu"])
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            summary = serve_load._shard_main(args, _port_cfg(), params, None)
    finally:
        serve_load.run_shard_trace = orig
    return {"summary": summary, "out": out.getvalue(), "err": err.getvalue(),
            "arms": store}


def _load_world(rank: int, world: int, flags: list, params: dict):
    return _drive(flags, params)


@pytest.fixture(scope="module")
def trees():
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer
    from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
    from tpu_on_k8s_torch.models import params as pparams

    cfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                              max_seq_len=64, n_kv_heads=4)
    tok = jnp.zeros((1, 8), jnp.int32)
    jtree = Transformer(cfg).init(jax.random.key(1), tok)["params"]
    ptree = pparams.from_jax_params(jax.tree.map(np.asarray, jtree),
                                    torch.float32, "cpu")
    return cfg, jtree, ptree


@pytest.fixture(scope="module")
def results(trees, tmp_path_factory):
    """The port's world (started first), then the reference's run here."""
    import tools.serve_load as ref

    cfg, jtree, ptree = trees
    tmp = tmp_path_factory.mktemp("serve_load_shard")
    world = World(_rank_main, (WORLD, str(tmp / "store"), _load_world,
                               (FLAGS, ptree), str(tmp / "out")),
                  WORLD, timeout=300)
    store: list = []
    orig = _recording(ref, store)
    args = argparse.Namespace(**vars(ref_args()))
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            summary = ref._shard_main(args, cfg, jtree, None)
    finally:
        ref.run_shard_trace = orig
    want = {"summary": summary, "out": out.getvalue(), "err": err.getvalue(),
            "arms": store}
    return want, world.results(tmp / "out")


def ref_args():
    """The reference's flags: the port's parser's namespace less
    ``--device`` (every other default is the reference's)."""
    from tpu_on_k8s_torch import serve_load
    args = vars(serve_load.build_parser().parse_args(FLAGS))
    args.pop("device")
    args["accelerator"] = "tpu-v5-lite-podslice"
    return argparse.Namespace(**args)


def test_every_arm_matches_the_reference(results):
    want, got = results
    mine, workers = got[0], got[1:]
    assert workers == [{"summary": {}, "out": "", "err": "",
                        "arms": []}] * (WORLD - 1)
    assert [m for m, _, _ in mine["arms"]] == \
        [m for m, _, _ in want["arms"]] == [1, 2, 4, 4]
    for (m, out_p, log_p), (_, out_r, log_r) in zip(mine["arms"],
                                                    want["arms"]):
        assert out_p == out_r, f"tokens of mesh {m}"
        assert log_p == log_r, f"event log of mesh {m}"
    # every arm token-identical to the meshless one; the replay of the
    # largest arm logs as its first run did
    assert all(o == mine["arms"][0][1] for _, o, _ in mine["arms"])
    assert mine["arms"][2][2] == mine["arms"][3][2]


def test_the_summary_and_per_chip_bytes_match_the_reference(results):
    want, got = results
    mine = got[0]
    s, r = mine["summary"], want["summary"]
    for m in ("1", "2", "4"):
        for key in ("param_bytes_per_chip", "kv_bytes_per_chip",
                    "bytes_frac", "step_cost", "virtual_s", "n_chips",
                    "mesh_axes"):
            assert s["arms"][m][key] == r["arms"][m][key], (m, key)
    assert s == r
    assert s["meshes"] == [1, 2, 4] and s["skipped_meshes"] == []
    assert s["token_identical"] and s["per_chip_bytes_linear"]
    assert s["soak_ok"] and s["event_log_replayed"]
    assert s["arms"]["4"]["bytes_frac"] < s["arms"]["2"]["bytes_frac"] < 1
    assert json.loads(mine["out"].splitlines()[-1]) == \
        json.loads(want["out"].splitlines()[-1])
    assert mine["err"].strip() == want["err"].strip() == \
        "SHARD_SOAK_OK seed=1357"


def test_a_world_of_one_skips_the_larger_meshes(trees):
    """Off torchrun: a world of one rank in this process, meshes 2 and 4
    listed as skipped (never shrunk silently), the world destroyed."""
    import torch.distributed as dist

    _, _, ptree = trees
    got = _drive(FLAGS, ptree)
    assert not dist.is_initialized()
    s = got["summary"]
    assert s["meshes"] == [1] and s["skipped_meshes"] == [2, 4]
    assert s["soak_ok"] and list(s["arms"]) == ["1"]
    assert got["err"].splitlines() == [
        "[serve_load] skipping mesh sizes [2, 4]: only 1 devices visible",
        "SHARD_SOAK_OK seed=1357"]
