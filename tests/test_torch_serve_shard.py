"""Mesh-sharded serving in the port against the JAX package, on the CPU.

Every oracle of ``tests/test_serve_shard.py`` but one runs as a case in
both packages on the same seeded numpy prompts and the same weights
(initialised by JAX, carried across with ``from_jax_params``): the JAX
engine on ``jax.devices()[:n]`` of the 8-device CPU platform, in this
process; the port's ``ContinuousBatchingEngine(mesh=...)`` on a world of 4
gloo ranks spawned once for the module, where rank 0 drives (it builds
every engine and runs every case, ``run_cases``) and ranks 1-3 run
``serve_mesh_worker`` on the module's meshes (``MESHES``). The world runs
while the JAX cases compute. A case returns tokens, stats, shard reports
and gauges; the two packages' must be equal (tokens, not bits: a
row-parallel sum adds its partial products in another order). Beyond the
reference's oracles, both packages also run GQA rep 2 (a rank's q heads
read its own kv heads), ``fsdp`` 2 x ``model`` 2 under the flagship rules,
the paged pool on ``data`` with a two-step horizon, and an export off a
slot the second ``data`` rank holds, and the int8 KV cache on ``model`` 2
(tokens, each rank's leaves, the export's leaves). The port alone: the
uneven rules (on its own leaf names) and rules the serving layout cannot
run, sampling on ``data``, ``close()``, ``serve --model-axis 2`` on a
torchrun-style world of 2 (its own spawn) and a world of one rank in this
process (what the card runs).

Elsewhere: ``test_sharding_policy_identity_and_normalization`` tests the
controller's ``decode_variant`` and runs in
``tests/test_torch_inferenceservice.py``.

This module imports no JAX at its top: its rank bodies run in spawned
processes that import it.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import pickle
import re
from typing import Callable, Dict

import numpy as np
import pytest
import torch

from test_torch_mesh_train import World, _free_port, case_result, run_cases
from tpu_on_k8s_torch.parallel.partition import ShardingValidationError

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

WORLD = 4
#: the module's meshes, made by every rank of the world, in this order
MESHES = {
    "model2": dict(model=2, ranks=[0, 1]),
    "model4": dict(model=4),
    "data2_model2": dict(data=2, model=2),
    "fsdp2_model2": dict(fsdp=2, model=2),
}
#: rule sets whose layouts XLA reshards, before the serving rules: (the
#: port's rule, the reference's on its layer-stacked leaves)
RULES = {
    "attn_whole": ((r"attn\.", ()), (r"attn/", ())),
    "norm_split": ((r"attn_norm", ("model",)),
                   (r"attn_norm", (None, "model"))),
    "head_hidden": ((r"lm_head", ("model", None)),
                    (r"lm_head", ("model", None))),
}
#: the stats both engines keep alike
STATS = ("steps", "emitted", "admitted", "prefill_positions",
         "prefix_prefills", "kv_adopted", "kv_exported",
         "export_gather_bytes", "admit_copy_positions", "spec_rounds",
         "spec_proposed", "spec_accepted", "spec_rollbacks")


def _prompts(seed, sizes, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=s).astype(np.int32) for s in sizes]


def _tokens(out, ids):
    return [np.asarray(out[r]).tolist() for r in ids]


# ---- the two packages behind one surface -----------------------------------

class _Port:
    """The port's engines on the world's meshes (rank 0 of the world)."""

    def __init__(self, meshes, trees) -> None:
        from tpu_on_k8s_torch.models.transformer import TransformerConfig
        self.meshes = meshes
        self.trees = trees
        self.cfg = dataclasses.replace(TransformerConfig.tiny(),
                                       dtype=torch.float32, max_seq_len=64,
                                       n_kv_heads=4)

    def config(self, **kw):
        return dataclasses.replace(self.cfg, **kw)

    def params(self, kind="base"):
        return self.trees[kind]

    def engine(self, mesh=None, cfg=None, params=None, **kw):
        from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
        return ContinuousBatchingEngine(
            cfg or self.cfg, params or self.trees["base"],
            mesh=self.meshes[mesh] if mesh else None, device="cpu", **kw)

    def flagship_rules(self):
        from tpu_on_k8s_torch.models.transformer import (
            flagship_partition_rules,
        )
        return flagship_partition_rules()

    def rules(self, kind):
        """The rule set ``kind`` of ``RULES`` on the port's leaves."""
        from tpu_on_k8s_torch.models.transformer import (
            serving_partition_rules,
        )
        from tpu_on_k8s_torch.parallel.partition import PartitionRule
        return [PartitionRule(*RULES[kind][0])] + serving_partition_rules()

    @staticmethod
    def kv_shard_shape(eng):
        return list(eng._cache.k.shape)

    @staticmethod
    def kv_leaf_shapes(eng):
        return {k: list(t.shape) for k, t in eng._cache.leaves.items()}

    @staticmethod
    def payload_leaves(h):
        return {k: [list(t.shape), str(t.dtype).removeprefix("torch.")]
                for k, t in h.cache.items()}

    @staticmethod
    def shard_metrics():
        from tpu_on_k8s_torch.metrics import ShardMetrics
        return ShardMetrics()

    @staticmethod
    def exposition(m):
        from tpu_on_k8s_torch.metrics import exposition
        return exposition(m)

    @staticmethod
    def serve():
        import tpu_on_k8s_torch.serve as serve
        return serve


class _Jax:
    """The JAX package's engines on meshes of the CPU platform's devices."""

    def __init__(self, trees) -> None:
        import jax
        import jax.numpy as jnp

        from tpu_on_k8s.models.transformer import TransformerConfig
        from tpu_on_k8s.parallel.mesh import (
            MeshConfig,
            create_mesh,
            serving_mesh,
        )
        dev = jax.devices()
        self.meshes = {
            "model2": serving_mesh(model=2, devices=dev[:2]),
            "model4": serving_mesh(model=4, devices=dev[:4]),
            "data2_model2": serving_mesh(data=2, model=2, devices=dev[:4]),
            "fsdp2_model2": create_mesh(MeshConfig(data=1, fsdp=2, model=2,
                                                   seq=1), dev[:4]),
        }
        self.trees = trees
        self.cfg = dataclasses.replace(TransformerConfig.tiny(),
                                       dtype=jnp.float32, max_seq_len=64,
                                       n_kv_heads=4)

    def config(self, **kw):
        return dataclasses.replace(self.cfg, **kw)

    def params(self, kind="base"):
        return self.trees[kind]

    def engine(self, mesh=None, cfg=None, params=None, **kw):
        from tpu_on_k8s.models.serving import ContinuousBatchingEngine
        return ContinuousBatchingEngine(
            cfg or self.cfg, params or self.trees["base"],
            mesh=self.meshes[mesh] if mesh else None, **kw)

    def flagship_rules(self):
        from tpu_on_k8s.models.transformer import flagship_partition_rules
        return flagship_partition_rules()

    def rules(self, kind):
        """The rule set ``kind`` of ``RULES`` on the reference's leaves."""
        from jax.sharding import PartitionSpec as P

        from tpu_on_k8s.models.transformer import serving_partition_rules
        from tpu_on_k8s.parallel.partition import PartitionRule
        pattern, spec = RULES[kind][1]
        return [PartitionRule(pattern, P(*spec))] + serving_partition_rules()

    @staticmethod
    def kv_shard_shape(eng):
        k = eng._cache["blocks"]["attn"]["k"]
        return list(k.sharding.shard_shape(k.shape))

    @staticmethod
    def kv_leaf_shapes(eng):
        return {k: list(t.sharding.shard_shape(t.shape))
                for k, t in eng._cache["blocks"]["attn"].items()}

    @staticmethod
    def payload_leaves(h):
        return {k: [list(t.shape), str(t.dtype)]
                for k, t in h.cache["blocks"]["attn"].items()}

    @staticmethod
    def shard_metrics():
        from tpu_on_k8s.metrics.metrics import ShardMetrics
        return ShardMetrics()

    @staticmethod
    def exposition(m):
        from tpu_on_k8s.metrics.metrics import exposition
        return exposition(m)

    @staticmethod
    def serve():
        import tpu_on_k8s.serve as serve
        return serve


def _stats(eng):
    return {k: int(eng.stats[k]) for k in STATS}


# ---- the cases: one body, run by both packages ------------------------------

def case_staggered(api, n_model):
    """Ragged staggered requests (two in flight, one queued) on a
    model-parallel mesh; the KV pool holds each rank's kv heads."""
    eng = api.engine(n_slots=2, mesh=f"model{n_model}")
    prompts, news = _prompts(9, (6, 13, 4)), (8, 5, 7)
    ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.step()
    out = eng.run()
    return dict(mesh_axes=dict(eng.mesh_axes), kv=api.kv_shard_shape(eng),
                tokens=_tokens(out, ids), stats=_stats(eng))


def case_data_axis(api):
    """A {data: 2, model: 2} mesh: slots split on data on top of tensor
    parallelism, through staggered admission, slot reuse and a mid-decode
    export adopted meshless; and (beyond the reference) an export off a
    slot the second data rank holds."""
    eng = api.engine(n_slots=4, mesh="data2_model2")
    prompts, news = _prompts(45, (6, 13, 4, 9, 5)), (8, 5, 7, 6, 9)
    ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    eng.step()                         # 4 in flight, 1 queued: slot reuse
    out = eng.run()
    r = eng.submit(prompts[0], 10)
    eng.step()
    h = eng.export_kv(r)
    eng.abort(r)
    dst = api.engine(n_slots=2)
    migrated = _adopt(dst, h, 10)
    rs = [eng.submit(p, 12) for p in prompts[:3]]
    eng.step()                         # slots 0-2: slot 2 on data rank 1
    far = eng.export_kv(rs[2])
    for q in rs:
        eng.abort(q)
    dst = api.engine(n_slots=2)
    far_tokens = _adopt(dst, far, 12)
    return dict(mesh_axes=dict(eng.mesh_axes), kv=api.kv_shard_shape(eng),
                tokens=_tokens(out, ids), verified=[h.verify(), far.verify()],
                checksums_differ=h.checksum != far.checksum,
                migrated=migrated, far=far_tokens, stats=_stats(eng))


def case_prefix(api):
    """Registered-prefix admissions on a mesh."""
    prefix = _prompts(21, (11,))[0]
    suffixes = _prompts(22, (4, 9))
    eng = api.engine(n_slots=2, mesh="model2")
    pid = eng.register_prefix(prefix)
    ids = [eng.submit(s, n, prefix_id=pid) for s, n in zip(suffixes, (8, 5))]
    out = eng.run()
    return dict(tokens=_tokens(out, ids), stats=_stats(eng))


def case_chunked(api):
    """A long prompt admitted chunk by chunk on a mesh."""
    prompt = _prompts(31, (23,))[0]
    eng = api.engine(n_slots=2, mesh="model2", prefill_chunk=8)
    r = eng.submit(prompt, 9)
    return dict(tokens=_tokens(eng.run(), [r]), stats=_stats(eng))


def case_export_unlike(api):
    """A mid-decode export on a 2-way mesh adopted on a 4-way mesh and
    meshless; the handoff carries its source layout."""
    prompt = _prompts(40, (7,))[0]
    src = api.engine(n_slots=2, mesh="model2")
    r = src.submit(prompt, 12)
    src.step()
    src.step()
    h = src.export_kv(r)
    src.abort(r)
    got = []
    for target in (api.engine(n_slots=2, mesh="model4"),
                   api.engine(n_slots=2)):
        got.append(_adopt(target, h, 12))
    return dict(verified=h.verify(), layout_axes=dict(h.layout.mesh_axes),
                gathered=int(h.layout.gathered_bytes),
                counted=int(src.stats["export_gather_bytes"]),
                tokens=got)


def case_prefix_export_import(api):
    """``export_prefix`` from a sharded engine imported onto an unlike mesh
    and meshless."""
    prefix = _prompts(51, (9,))[0]
    suffix = _prompts(52, (5,))[0]
    src = api.engine(n_slots=2, mesh="model2")
    host, lp = src.export_prefix(src.register_prefix(prefix))
    got = []
    for target in (api.engine(n_slots=2, mesh="model4"),
                   api.engine(n_slots=2)):
        pid = target.import_prefix(host, lp)
        r = target.submit(suffix, 8, prefix_id=pid)
        got.append(np.asarray(target.run()[r]).tolist())
    return dict(lp=int(lp), gathered=int(src.stats["export_gather_bytes"]),
                tokens=got)


def case_speculative(api):
    """A (self-)draft proposing for the sharded target."""
    prompts = _prompts(60, (6, 11))
    eng = api.engine(n_slots=2, mesh="model2", draft_cfg=api.cfg,
                     draft_params=api.params(), spec_k=3)
    ids = [eng.submit(p, n) for p, n in zip(prompts, (10, 7))]
    return dict(tokens=_tokens(eng.run(), ids), stats=_stats(eng))


def case_int8(api):
    """A sharded W8A16 engine against the meshless W8A16 engine."""
    prompt = _prompts(70, (8,))[0]
    return dict(tokens=[
        np.asarray(_run_one(api.engine(n_slots=2, int8_weights=True,
                                       mesh=mesh), prompt, 9)).tolist()
        for mesh in (None, "model2")])


def _run_one(eng, prompt, n):
    r = eng.submit(prompt, n)
    return eng.run()[r]


def _adopt(eng, handoff, n):
    r = eng.submit_kv(handoff, n)
    return np.asarray(eng.run()[r]).tolist()


def case_int8_speculative(api):
    """A model-sharded W8A16 target with a bf16-recipe self-draft."""
    prompt = _prompts(80, (7,))[0]
    plain = _run_one(api.engine(n_slots=2, int8_weights=True), prompt, 10)
    eng = api.engine(n_slots=2, int8_weights=True, mesh="model2",
                     draft_cfg=api.config(serve_int8_weights=False),
                     draft_params=api.params(), spec_k=3)
    got = _run_one(eng, prompt, 10)
    return dict(plain=np.asarray(plain).tolist(),
                sharded=np.asarray(got).tolist(),
                spec_rounds=int(eng.stats["spec_rounds"]))


def case_shard_surface(api):
    """``ShardMetrics`` and ``shard_report`` on a 2-way mesh; export
    gathers counted."""
    m = api.shard_metrics()
    eng = api.engine(n_slots=2, mesh="model2", shard_metrics=m)
    rep = eng.shard_report()
    r = eng.submit(_prompts(90, (6,))[0], 6)
    eng.step()
    h = eng.export_kv(r)
    return dict(report={k: (dict(v) if isinstance(v, dict) else int(v))
                        for k, v in rep.items()},
                axis=m.gauges[("mesh_axis_size", "model")],
                param_gauge=m.gauges[("param_bytes_per_chip", "")],
                kv_gauge=m.gauges[("kv_bytes_per_chip", "")],
                counter=m.counters[("export_gather_bytes", "")],
                gathered=int(h.layout.gathered_bytes),
                scraped="tpu_on_k8s_shard_mesh_axis_size"
                        in api.exposition(m))


def case_trivial_surface(api):
    """The meshless engine reports the single-chip identity."""
    eng = api.engine(n_slots=2)
    rep = eng.shard_report()
    return dict(mesh_axes=dict(eng.mesh_axes), n_chips=int(eng.n_chips),
                report={k: (dict(v) if isinstance(v, dict) else int(v))
                        for k, v in rep.items()})


def case_reshard_rollout(api):
    """A fleet serving live traffic rolls from meshless replicas to 2-way
    mesh replicas with zero loss; counted on stats and ShardMetrics."""
    serve = api.serve()

    def plain_factory(name):
        return api.engine(n_slots=2)

    def sharded_factory(name):
        return api.engine(n_slots=2, mesh="model2")

    sm = api.shard_metrics()
    fleet = serve.ServingFleet(plain_factory, 2,
                               probe=serve.ProbeConfig(slow_start_steps=1),
                               shard_metrics=sm)
    rng = np.random.default_rng(7)
    rids = []
    for _ in range(3):
        fleet.step()
    for i in range(6):
        r = fleet.submit(rng.integers(0, 256, size=5 + i).astype(np.int32),
                         6)
        assert not isinstance(r, serve.Rejected)
        rids.append(r)
    fleet.start_rollout(sharded_factory, "v2-sharded",
                        serve.FleetRolloutPolicy(max_surge=1,
                                                 drain_timeout_s=None))
    for i in range(4):
        fleet.step()
        r = fleet.submit(rng.integers(0, 256, size=4 + i).astype(np.int32),
                         5)
        if not isinstance(r, serve.Rejected):
            rids.append(r)
    out = fleet.run()
    live = [rep.engine.mesh_axes for rep in fleet.replicas.values()
            if rep.engine is not None]
    return dict(phase=fleet.rollout_phase.value,
                completed=fleet.stats["rollouts_completed"],
                reshards=fleet.stats["reshard_rollouts"],
                counter=sm.counters[("reshard_rollouts", "")],
                states={r: out[r].state.value for r in rids if r in out},
                tokens={r: np.asarray(out[r].tokens).tolist() for r in rids
                        if r in out},
                old_drained=[rec["drained_clean"] for rec in fleet.retired
                             if rec["version"] == "v1"],
                live=[dict(a) for a in live])


def case_gqa_rep2(api):
    """GQA rep 2 at model 2 (n_heads 4, n_kv_heads 2): each rank's two q
    heads read its one kv head."""
    cfg = api.config(n_kv_heads=2)
    prompts, news = _prompts(11, (5, 12, 7)), (7, 6, 5)
    eng = api.engine(n_slots=2, mesh="model2", cfg=cfg,
                     params=api.params("gqa"))
    ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    return dict(kv=api.kv_shard_shape(eng), tokens=_tokens(eng.run(), ids))


def case_fsdp(api):
    """``serve --fsdp``'s layout: fsdp 2 x model 2 under the flagship
    rules; the weights gathered for each call."""
    prompts, news = _prompts(13, (6, 10)), (8, 6)
    eng = api.engine(n_slots=2, mesh="fsdp2_model2",
                     rules=api.flagship_rules())
    ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    return dict(tokens=_tokens(eng.run(), ids), stats=_stats(eng))


def case_paged_data(api):
    """The paged pool on a {data: 2, model: 2} mesh, with a registered
    prefix and a two-step horizon."""
    prefix = _prompts(14, (19,))[0]
    prompts, news = _prompts(15, (5, 9, 4)), (7, 6, 8)
    eng = api.engine(n_slots=2, mesh="data2_model2", kv_pages=16,
                     page_tokens=16, step_horizon=2)
    pid = eng.register_prefix(prefix)
    ids = [eng.submit(p, n, prefix_id=pid if j else None)
           for j, (p, n) in enumerate(zip(prompts, news))]
    return dict(tokens=_tokens(eng.run(), ids))


def case_cache_int8(api):
    """The int8 KV cache on model 2 against the meshless engine: each rank
    holds its heads of the values and the scales; a mid-decode export
    carries all four leaves whole and is adopted meshless."""
    cfg = api.config(cache_int8=True)
    prompts = _prompts(16, (6, 9))
    got = {}
    for mesh in (None, "model2"):
        eng = api.engine(n_slots=2, cfg=cfg, mesh=mesh)
        ids = [eng.submit(p, 8) for p in prompts]
        got[mesh or "meshless"] = _tokens(eng.run(), ids)
    r = eng.submit(prompts[0], 10)
    eng.step()
    h = eng.export_kv(r)
    eng.abort(r)
    return dict(tokens=got, leaves=api.kv_leaf_shapes(eng),
                payload=api.payload_leaves(h), verified=h.verify(),
                adopted=_adopt(api.engine(n_slots=2, cfg=cfg), h, 10))


def case_recipe_int8(api):
    """An int8-recipe engine (``mlp_int8`` + ``head_int8``: decode runs
    them too) on model 2 against the meshless one: the column-parallel
    products on local blocks, the row-parallel ``w_down`` quantized over
    the whole K, its fp32 partial products summed."""
    cfg = api.config(mlp_int8=True, head_int8=True)
    prompts = _prompts(24, (6, 9))
    got = {}
    for mesh in (None, "model2"):
        eng = api.engine(n_slots=2, cfg=cfg, mesh=mesh)
        ids = [eng.submit(p, 8) for p in prompts]
        got[mesh or "meshless"] = _tokens(eng.run(), ids)
    return got


def case_fused(api):
    """A fused engine (``fused_qkv`` + ``mlp_fused_gateup``, GQA rep 2) on
    model 2: each rank's q heads read its own kv head, and gate and up
    are its own halves."""
    cfg = api.config(n_kv_heads=2, fused_qkv=True, mlp_fused_gateup=True)
    prompts, news = _prompts(25, (5, 12, 7)), (7, 6, 5)
    eng = api.engine(n_slots=2, mesh="model2", cfg=cfg,
                     params=api.params("fused"))
    ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    return dict(kv=api.kv_shard_shape(eng), tokens=_tokens(eng.run(), ids))


def case_uneven_heads(api):
    """``tiny``'s heads (4 query on 2 kv) at model 4: the 2 kv heads do not
    divide, so the pool holds both on every rank (the reference's
    ``kv_sharding``) and a rank's query head reads them gathered."""
    cfg = api.config(n_kv_heads=2)
    prompts, news = _prompts(26, (6, 10)), (8, 6)
    eng = api.engine(n_slots=2, mesh="model4", cfg=cfg,
                     params=api.params("gqa"))
    ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    rep = eng.shard_report()
    return dict(kv=api.kv_shard_shape(eng), tokens=_tokens(eng.run(), ids),
                kv_per_chip=int(rep["kv_bytes_per_chip"]),
                kv_total=int(rep["kv_bytes_total"]))


def case_rules(api, kind):
    """A rule set whose layout XLA reshards (``RULES``), on model 2. (The
    pools differ by design where attention runs whole: the reference
    splits its kv heads all the same, the port's holds them all.)"""
    prompts, news = _prompts(27, (6, 9)), (7, 5)
    eng = api.engine(n_slots=2, mesh="model2", rules=api.rules(kind))
    ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
    return dict(tokens=_tokens(eng.run(), ids))


#: name → (case, its arguments); every case runs in both packages
CASES: Dict[str, tuple] = {
    "staggered_model2": (case_staggered, (2,)),
    "staggered_model4": (case_staggered, (4,)),
    "data_axis": (case_data_axis, ()),
    "prefix": (case_prefix, ()),
    "chunked": (case_chunked, ()),
    "export_unlike": (case_export_unlike, ()),
    "prefix_export_import": (case_prefix_export_import, ()),
    "speculative": (case_speculative, ()),
    "int8": (case_int8, ()),
    "int8_speculative": (case_int8_speculative, ()),
    "shard_surface": (case_shard_surface, ()),
    "trivial_surface": (case_trivial_surface, ()),
    "reshard_rollout": (case_reshard_rollout, ()),
    "gqa_rep2": (case_gqa_rep2, ()),
    "fsdp": (case_fsdp, ()),
    "paged_data": (case_paged_data, ()),
    "cache_int8": (case_cache_int8, ()),
    "recipe_int8": (case_recipe_int8, ()),
    "fused": (case_fused, ()),
    "uneven_heads": (case_uneven_heads, ()),
    **{f"rules_{kind}": (case_rules, (kind,)) for kind in RULES},
}


# ---- cases of the port alone ------------------------------------------------

def port_uneven_rules(api):
    """Bad rules fail at construction with the typed error naming the
    path, the dim and the axis (the reference's rule, on the port's names:
    no tiny leaf has a dim 4 does not divide, so the vocab is 258)."""
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.transformer import serving_partition_rules
    from tpu_on_k8s_torch.parallel.partition import (
        PartitionRule,
        ShardingValidationError,
    )
    out = {}
    toolong = [PartitionRule(r"norm\.scale", ("model", None, None))] \
        + serving_partition_rules()
    try:
        api.engine(n_slots=2, mesh="model2", rules=toolong)
    except ShardingValidationError as e:
        out["toolong"] = str(e)
    cfg = api.config(vocab_size=258)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    uneven = [PartitionRule(r"(^|/)embed$", ("model",))] \
        + serving_partition_rules()
    try:
        api.engine(n_slots=2, mesh="model4", cfg=cfg, params=params,
                   rules=uneven)
    except ShardingValidationError as e:
        out["uneven"] = str(e)
    return out


def port_rules_layout(api):
    """The rules decide the serving layout: an MLP they leave whole over
    ``model`` is whole on each rank (no all-reduce after ``w_down``) and
    the tokens equal the meshless engine's; so do attention they leave
    whole (every rank runs it, and its pool holds every kv head) and a
    whole ``wo`` after column-parallel q/k/v (their heads gathered)."""
    from tpu_on_k8s_torch.models.transformer import serving_partition_rules
    from tpu_on_k8s_torch.parallel.partition import PartitionRule
    prompt = _prompts(20, (7,))[0]
    eng = api.engine(n_slots=2, mesh="model2", rules=[
        PartitionRule(r"mlp\.", ())] + serving_partition_rules())
    blocks = eng._prefill_model.blocks
    out = dict(tokens=[np.asarray(_run_one(e, prompt, 6)).tolist()
                       for e in (api.engine(n_slots=2), eng)],
               w_up=list(blocks[0].mlp.w_up.weight.shape),
               w_down_tp=blocks[0].mlp.w_down.tp is not None,
               wo_tp=blocks[0].attn.wo.tp is not None)
    for name, rule in (("attn_whole", r"attn\."), ("wo_whole", r"attn\.wo")):
        eng = api.engine(n_slots=2, mesh="model2", rules=[
            PartitionRule(rule, ())] + serving_partition_rules())
        out[name] = dict(
            tokens=np.asarray(_run_one(eng, prompt, 6)).tolist(),
            kv=list(eng._cache.k.shape),
            wq=list(eng._prefill_model.blocks[0].attn.wq.weight.shape))
    return out


def port_sampled_data(api):
    """``temperature > 0`` on {data: 2, model: 2}: the driver draws every
    row from the logits gathered over data, with its generator, so the
    tokens equal the meshless engine's from the same seed."""
    prompts, news = _prompts(17, (5, 8, 6, 7)), (6, 5, 7, 6)
    got = []
    for mesh in (None, "data2_model2"):
        eng = api.engine(n_slots=4, mesh=mesh, temperature=0.8, top_k=20,
                         step_horizon=2,
                         generator=torch.Generator().manual_seed(3))
        ids = [eng.submit(p, n) for p, n in zip(prompts, news)]
        got.append(_tokens(eng.run(), ids))
    return got


def port_close(api):
    """A closed engine's workers drop their shard (the worker's count at
    shutdown covers it) and the engine refuses to serve."""
    eng = api.engine(n_slots=2, mesh="model2")
    tokens = np.asarray(_run_one(eng, _prompts(18, (5,))[0], 4)).tolist()
    eng.close()
    eng.submit(_prompts(18, (6,))[0], 3)
    try:
        eng.run()
        refused = ""
    except RuntimeError as e:
        refused = str(e)
    return dict(tokens=tokens, refused=refused)


PORT_CASES: Dict[str, Callable] = {
    "uneven_rules": port_uneven_rules,
    "rules_layout": port_rules_layout,
    "sampled_data": port_sampled_data,
    "close": port_close,
}


# ---- the spawned worlds -----------------------------------------------------

def _rank_main(rank: int, world: int, store: str, body: Callable,
               args: tuple, out: str) -> None:
    import datetime

    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        result = body(rank, world, *args)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def _cli_rank(rank: int, world: int, port: int, argv: list,
              out: str) -> None:
    """A torchrun-launched ``serve``: its variables, then the CLI."""
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    from tpu_on_k8s_torch.serve import cli
    got = cli.main(argv)
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump({r: np.asarray(t).tolist() for r, t in got.items()}, f)


def _shard_world(rank: int, world: int, trees: dict):
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.parallel.serving import (
        serve_mesh_worker,
        shutdown_mesh_workers,
    )
    meshes = {}
    for name, kw in MESHES.items():
        kw = dict(kw)
        ranks = kw.pop("ranks", None)
        meshes[name] = create_mesh(MeshConfig(**{"fsdp": 1, **kw}),
                                   ranks=ranks, device="cpu")
    if rank:
        return serve_mesh_worker(list(meshes.values()))
    api = _Port(meshes, trees)
    try:
        cases = {name: (lambda f=fn, a=args: f(api, *a))
                 for name, (fn, args) in CASES.items()}
        cases.update({name: (lambda f=fn: f(api))
                      for name, fn in PORT_CASES.items()})
        return run_cases(rank, cases)
    finally:
        gc.collect()            # engines in reference cycles: closed now
        shutdown_mesh_workers()


CLI_ARGV = ["--config", "tiny", "--device", "cpu", "--n-requests", "4",
            "--max-new-tokens", "6"]


# ---- fixtures ---------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """The JAX weights of the fixture's config (and of its GQA-rep-2
    variant, and that variant's fused layout), and the port's from
    them."""
    import jax
    import jax.numpy as jnp

    from tpu_on_k8s.models.transformer import Transformer
    from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
    from tpu_on_k8s_torch.models import params as pparams

    cfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                              max_seq_len=64, n_kv_heads=4)
    tok = jnp.zeros((1, 8), jnp.int32)
    jtrees = {
        "base": Transformer(cfg).init(jax.random.key(1), tok)["params"],
        "gqa": Transformer(dataclasses.replace(cfg, n_kv_heads=2)).init(
            jax.random.key(2), tok)["params"],
        "fused": Transformer(dataclasses.replace(
            cfg, n_kv_heads=2, fused_qkv=True, mlp_fused_gateup=True)).init(
                jax.random.key(3), tok)["params"]}
    ptrees = {k: pparams.from_jax_params(jax.tree.map(np.asarray, t),
                                         torch.float32, "cpu")
              for k, t in jtrees.items()}
    return jtrees, ptrees


@pytest.fixture(scope="module")
def worlds(trees, tmp_path_factory):
    """Both spawned worlds, started before the JAX cases compute."""
    tmp = tmp_path_factory.mktemp("serve_shard")
    shard = World(_rank_main, (WORLD, str(tmp / "store"), _shard_world,
                               (trees[1],), str(tmp / "shard")),
                  WORLD, timeout=300)
    cli = World(_cli_rank, (2, _free_port(),
                            [*CLI_ARGV, "--model-axis", "2"],
                            str(tmp / "cli")), 2, timeout=300)
    return (shard, tmp / "shard"), (cli, tmp / "cli")


@pytest.fixture(scope="module")
def results(worlds, trees):
    """Every case in the JAX package (here, while the worlds run), then
    the port's from the world."""
    api = _Jax(trees[0])
    want = {name: fn(api, *args) for name, (fn, args) in CASES.items()}
    (shard, shard_out), (cli, cli_out) = worlds
    got = shard.results(shard_out)
    return want, got[0], got[1:], cli.results(cli_out)


# ---- the tests --------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_case_matches_jax(name, results):
    want, got, _, _ = results
    assert case_result(got, name) == want[name]


def test_reference_assertions_hold(results):
    """The reference's own assertions, on the port's results."""
    _, got, _, _ = results
    for n in (2, 4):
        r = case_result(got, f"staggered_model{n}")
        assert r["mesh_axes"] == {"model": n}
        assert r["kv"] == [2, 2, 64, 4 // n, 16]
    r = case_result(got, "data_axis")
    assert r["mesh_axes"] == {"data": 2, "model": 2}
    assert r["kv"] == [2, 2, 64, 2, 16] and r["verified"] == [True, True]
    r = case_result(got, "export_unlike")
    assert r["verified"] and r["layout_axes"] == {"model": 2}
    assert r["gathered"] > 0 and r["counted"] == r["gathered"]
    assert r["tokens"][0] == r["tokens"][1]
    assert case_result(got, "prefix_export_import")["gathered"] > 0
    assert case_result(got, "speculative")["stats"]["spec_rounds"] > 0
    r = case_result(got, "int8")
    assert r["tokens"][0] == r["tokens"][1]
    r = case_result(got, "int8_speculative")
    assert r["spec_rounds"] > 0 and r["plain"] == r["sharded"]
    r = case_result(got, "shard_surface")
    rep = r["report"]
    assert rep["n_chips"] == 2 and r["axis"] == 2 and r["scraped"]
    assert rep["param_bytes_per_chip"] <= rep["param_bytes_total"] * 0.55
    assert rep["kv_bytes_per_chip"] * 2 == rep["kv_bytes_total"]
    assert r["param_gauge"] == rep["param_bytes_per_chip"]
    assert r["counter"] == r["gathered"]
    r = case_result(got, "trivial_surface")
    assert r["mesh_axes"] == {} and r["n_chips"] == 1
    assert r["report"]["param_bytes_per_chip"] == \
        r["report"]["param_bytes_total"]
    assert r["report"]["kv_bytes_per_chip"] == r["report"]["kv_bytes_total"]
    r = case_result(got, "reshard_rollout")
    assert r["phase"] == "complete" and r["completed"] == 1
    assert r["reshards"] == 1 and r["counter"] == 1
    assert len(r["states"]) == 10 and set(r["states"].values()) == {"done"}
    assert r["old_drained"] and all(r["old_drained"])
    assert r["live"] and all(a == {"model": 2} for a in r["live"])
    assert case_result(got, "gqa_rep2")["kv"] == [2, 2, 64, 1, 16]


def test_uneven_rule_raises_actionable_error(results):
    got = case_result(results[1], "uneven_rules")
    assert "names 3 dims" in got["toolong"]
    assert re.search(r"embed.*dim 0.*model=4", got["uneven"])


def test_rules_decide_the_serving_layout(results):
    got = case_result(results[1], "rules_layout")
    assert got["tokens"][0] == got["tokens"][1]
    assert got["w_up"] == [128, 64]                 # tiny d_ff x d_model
    assert not got["w_down_tp"] and got["wo_tp"]
    # attention left whole: whole weights, every kv head in the pool
    whole = got["attn_whole"]
    assert whole["tokens"] == got["tokens"][0]
    assert whole["wq"] == [64, 64] and whole["kv"][3] == 4
    # a whole wo after column-parallel heads: the rank's heads, gathered
    wo = got["wo_whole"]
    assert wo["tokens"] == got["tokens"][0]
    assert wo["wq"] == [32, 64] and wo["kv"][3] == 2


def test_layouts_xla_reshards_serve_the_reference_tokens(results):
    """The int8 recipes, the fused rows, indivisible kv heads, whole
    attention, a split norm and a head split on its hidden dim: the tokens
    equal the meshless engine's (the case above holds them to the JAX
    engine's on the same layout), and the pool's bytes are what a rank
    holds."""
    got = results[1]
    r = case_result(got, "recipe_int8")
    assert r["model2"] == r["meshless"]
    assert case_result(got, "fused")["kv"] == [2, 2, 64, 1, 16]
    r = case_result(got, "uneven_heads")
    assert r["kv"] == [2, 2, 64, 2, 16]
    assert r["kv_per_chip"] == r["kv_total"]       # the whole pool
    for kind in RULES:
        assert case_result(got, f"rules_{kind}")["tokens"] == case_result(
            got, "rules_attn_whole")["tokens"]


def test_cache_int8_on_a_mesh(results):
    got = case_result(results[1], "cache_int8")
    assert got["tokens"]["model2"] == got["tokens"]["meshless"]
    assert got["leaves"] == {"k": [2, 2, 64, 2, 16], "k_scale": [2, 2, 64, 2],
                             "v": [2, 2, 64, 2, 16], "v_scale": [2, 2, 64, 2]}
    assert got["verified"]
    assert got["payload"] == {
        "k": [[2, 1, 64, 4, 16], "int8"],
        "k_scale": [[2, 1, 64, 4], "float32"],
        "v": [[2, 1, 64, 4, 16], "int8"],
        "v_scale": [[2, 1, 64, 4], "float32"]}
    assert got["adopted"][:8] == got["tokens"]["model2"][0]


def test_sampling_on_data_draws_on_the_driver(results):
    meshless, mesh = case_result(results[1], "sampled_data")
    assert mesh == meshless


def test_close_releases_the_workers(results):
    _, got, workers, _ = results
    r = case_result(got, "close")
    assert len(r["tokens"]) == 4 and "closed" in r["refused"]
    # every engine any case built was served and is gone at shutdown
    assert all(w["open"] == 0 and w["served"] > 0 for w in workers)


def test_serve_cli_model_axis_on_a_torchrun_world(results):
    """``serve --model-axis 2`` on two ranks launched as torchrun launches
    them: the driver's tokens equal the meshless CLI's; the worker
    returns nothing."""
    from tpu_on_k8s_torch.serve import cli
    driver, worker = results[3]
    want = {r: np.asarray(t).tolist() for r, t in cli.main(CLI_ARGV).items()}
    assert driver == want and worker == {}


def test_router_capacity_normalizes_load():
    """A 4-chip replica holds 4x a 1-chip replica's outstanding tokens
    before least-load prefers the small one, in both packages."""
    from tpu_on_k8s.serve.router import Router as JRouter
    from tpu_on_k8s_torch.serve.router import Router

    prompt = np.arange(16, dtype=np.int32)
    for cls in (Router, JRouter):
        r = cls(prefix_bucket_len=4, spill_tokens=0)
        r.add_replica("big", "v1")
        r.add_replica("small", "v1")
        r.set_capacity("big", 4)
        assert r.route(prompt, ["big", "small"],
                       {"big": 100, "small": 40}) == "big"
        with pytest.raises(ValueError):
            r.set_capacity("big", 0)


def _tiny_tree(int8=False):
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.serving import quantize_weights_for_serving
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    tree = init_params(TransformerConfig.tiny(), torch.Generator()
                       .manual_seed(0), "cpu")
    return quantize_weights_for_serving(tree) if int8 else tree


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "w8a16"])
def test_serving_cuts_follow_the_rules(int8):
    """The serving rules make wq/wk/wv/w_gate/w_up column parallel (every
    leaf on dim 0, an int8 scale too), wo/w_down row parallel (the weight
    on dim 1, the scale whole) and split embed and the head on the vocab;
    a rule leaving the MLP whole keeps it whole."""
    from tpu_on_k8s_torch.models.transformer import serving_partition_rules
    from tpu_on_k8s_torch.parallel.partition import PartitionRule
    from tpu_on_k8s_torch.parallel.sharded import serving_cuts
    w = "weight_q" if int8 else "weight"
    rules = serving_partition_rules(int8=int8)
    cuts, rows = serving_cuts(_tiny_tree(int8), rules)
    for i in range(2):
        for mod in ("attn.wq", "attn.wk", "attn.wv", "mlp.w_gate",
                    "mlp.w_up"):
            assert cuts[f"blocks.{i}.{mod}.{w}"] == 0
            assert cuts.get(f"blocks.{i}.{mod}.weight_scale") == (
                0 if int8 else None)
        for mod in ("attn.wo", "mlp.w_down"):
            assert cuts[f"blocks.{i}.{mod}.{w}"] == 1
            assert f"blocks.{i}.{mod}.weight_scale" not in cuts
    assert rows == [f"blocks.{i}.{m}" for i in range(2)
                    for m in ("attn.wo", "mlp.w_down")]
    head = ({"lm_head_q": 1, "lm_head_scale": 0} if int8
            else {"lm_head": 1})
    assert {k: v for k, v in cuts.items() if "blocks" not in k} == {
        "embed": 0, **head}
    cuts, rows = serving_cuts(_tiny_tree(int8),
                              [PartitionRule(r"mlp\.", ())] + rules)
    assert not any(".mlp." in k for k in cuts) and rows == [
        "blocks.0.attn.wo", "blocks.1.attn.wo"]


def _whole(*names):
    """A check that no leaf under any of ``names`` is cut."""
    return lambda cuts, rows: not any(k.startswith(names) for k in cuts)


@pytest.mark.parametrize("rule,error,names", [
    ((r"attn\.", ()), None, lambda cuts, rows: _whole("blocks.0.attn.")(
        cuts, rows) and rows == ["blocks.0.mlp.w_down", "blocks.1.mlp.w_down"]),
    ((r"attn\.wo", ()), None, lambda cuts, rows: "blocks.0.attn.wo.weight"
     not in cuts and cuts["blocks.0.attn.wq.weight"] == 0
     and "blocks.0.attn.wo" not in rows),
    ((r"mlp\.w_down", ()), None, lambda cuts, rows: "blocks.0.mlp.w_down.weight"
     not in cuts and cuts["blocks.1.mlp.w_up.weight"] == 0
     and rows == ["blocks.0.attn.wo", "blocks.1.attn.wo"]),
    ((r"attn_norm", ("model",)), None, _whole("blocks.0.attn_norm")),
    ((r"final_norm", ("model",)), None, _whole("final_norm")),
    ((r"lm_head", ("model", None)), None,
     lambda cuts, rows: cuts["lm_head"] == 0),
    ((r"attn\.wq\.weight", (None, None, "model")),
     ShardingValidationError, "blocks.0.attn.wq.weight"),
    ((r"attn\.wo\.weight_scale", ("model",)), ShardingValidationError,
     "blocks.0.attn.wo.weight_scale"),
], ids=["attn-whole", "wo-whole", "w_down-whole", "norm", "final-norm",
        "head-hidden", "dim-2", "row-scale-split"])
def test_serving_cuts_refuse_what_a_serving_model_cannot_run(rule, error,
                                                             names):
    """A layout no projection can run raises before anything moves, naming
    the leaf (a ``model`` dim past the weight's rank, a scale split against
    its projection's role); the layouts XLA reshards give their cuts
    (``names``: a check of the cuts and the row-parallel projections): a
    projection the rules leave whole keeps every leaf, a split norm stays
    whole, a head split on its hidden dim is cut on dim 0."""
    from tpu_on_k8s_torch.models.transformer import serving_partition_rules
    from tpu_on_k8s_torch.parallel.partition import PartitionRule
    from tpu_on_k8s_torch.parallel.sharded import serving_cuts
    int8 = "scale" in rule[0]
    rules = [PartitionRule(*rule)] + serving_partition_rules(int8=int8)
    if error is None:
        assert names(*serving_cuts(_tiny_tree(int8), rules))
        return
    with pytest.raises(error, match=re.escape(names)):
        serving_cuts(_tiny_tree(int8), rules)


@pytest.mark.parametrize("op,shapes", [
    ("decode", [(8,), (8,), None]),
    ("decode", [(8,), (8,), (8, 128)]),          # past the header: spills
    ("verify", [(4, 5), (4, 5), (4, 3)])])
def test_hot_command_header_round_trip(op, shapes):
    """A decode or verify command packs into the fixed int32 header (and
    its spill) and unpacks to the same arrays, shapes and engine id."""
    from tpu_on_k8s_torch.parallel.serving import (
        HOT_ARGS,
        pack_header,
        unpack_header,
    )
    rng = np.random.default_rng(23)
    args = {name: None if sh is None else
            rng.integers(0, 1 << 20, size=sh).astype(np.int32)
            for name, sh in zip(HOT_ARGS[op], shapes)}
    head, rest = pack_header(7, op, args)
    asked = []

    def fetch(n):
        asked.append(n)
        return rest

    got_op, engine, got = unpack_header(head, fetch)
    assert (got_op, engine) == (op, 7) and asked == ([rest.size]
                                                     if rest.size else [])
    for name, a in args.items():
        assert (got[name] is None) if a is None else (
            got[name].dtype == np.int32 and np.array_equal(got[name], a))
    assert pack_header(7, "admit", {"slot": 1}) is None
    assert pack_header(7, op, {**args, HOT_ARGS[op][0]:
                               args[HOT_ARGS[op][0]].astype(np.int64)}) \
        is None


@pytest.mark.parametrize("kw", [{}, {"kv_pages": 16, "page_tokens": 16},
                                {"int8_weights": True}],
                         ids=["dense", "paged", "w8a16"])
def test_world_of_one_is_the_meshless_engine_bit_for_bit(kw):
    """What the card runs (``chip_smoke.py`` phase 9): on a world of one
    rank every collective is an identity, so the mesh engine's models hold
    the given tensors, its exports' checksums equal the meshless engine's
    at the same step and its tokens equal, with the command channel
    running; per-chip bytes are the totals."""
    import torch.distributed as dist

    from tpu_on_k8s_torch.metrics import ShardMetrics
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    from tpu_on_k8s_torch.parallel.mesh import serving_mesh
    from tpu_on_k8s_torch.parallel.serving import shutdown_mesh_workers
    from tpu_on_k8s_torch.train.distributed import local_world

    cfg = dataclasses.replace(TransformerConfig.tiny(), dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompts = _prompts(19, (5, 9, 14, 7))
    assert local_world("cpu")
    try:
        sm = ShardMetrics()
        flat = ContinuousBatchingEngine(cfg, params, n_slots=4,
                                        device="cpu", **kw)
        eng = ContinuousBatchingEngine(cfg, params, n_slots=4, device="cpu",
                                       mesh=serving_mesh(device="cpu"),
                                       shard_metrics=sm, **kw)
        tree = eng._params
        assert all(t.data_ptr() == tree[n].data_ptr()
                   for m in (eng._prefill_model, eng._step_model)
                   for n, t in m.named_parameters())
        ids = [[e.submit(p, 8) for p in prompts] for e in (flat, eng)]
        for _ in range(3):
            flat.step()
            eng.step()
        assert (flat.export_kv(ids[0][1]).checksum
                == eng.export_kv(ids[1][1]).checksum)
        out = flat.run(), eng.run()
        assert _tokens(out[0], ids[0]) == _tokens(out[1], ids[1])
        rep = eng.shard_report()
        assert rep["mesh_axes"] == {} and rep["n_chips"] == 1
        assert rep["param_bytes_per_chip"] == rep["param_bytes_total"]
        assert rep["kv_bytes_per_chip"] == rep["kv_bytes_total"] \
            == sm.gauges[("kv_bytes_per_chip", "")]
        eng.close()
        shutdown_mesh_workers()
    finally:
        dist.destroy_process_group()
