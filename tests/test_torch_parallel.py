"""The port's meshes, partition rules and layouts against the JAX package's.

The reference's ``tests/test_parallel.py`` (an 8-device CPU mesh) run
through the port case for case, each held to what the JAX package computes
for the same input: on a world of 8 ranks in this process over
``torch``'s ``FakeStore`` (no collective is made: these are layout cases),
``MeshConfig``, ``create_mesh`` and ``batch_sharding``, the rules and their
validation, and ``shard_pytree``'s placements. Then the port's own
layout: ``flagship_partition_rules`` and ``serving_partition_rules`` leaf for
leaf against the reference's rules (a port weight ``[out, in]`` is the
transpose of a reference ``kernel [L, in, out]``), a model laid out by
``Trainer(..., mesh=...)`` as the rules say (the fused layouts, the int8
recipes and a head count ``model`` does not divide among them), and the
meshes the port refuses: a ``seq`` axis > 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from tpu_on_k8s.models import transformer as jtransformer
from tpu_on_k8s.parallel import mesh as jmesh
from tpu_on_k8s.parallel import partition as jpartition
from tpu_on_k8s_torch.models.params import init_params, load_model, param_shapes
from tpu_on_k8s_torch.models.transformer import (
    TransformerConfig,
    flagship_partition_rules,
    serving_partition_rules,
)
from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    MeshConfig,
    NamedSharding,
    batch_sharding,
    create_mesh,
    data_sharding,
    local_rows,
    mesh_axes,
    mesh_shape,
    replicated,
    serving_mesh,
)
from tpu_on_k8s_torch.parallel.partition import (
    PartitionRule,
    ShardingValidationError,
    named_sharding,
    shard_pytree,
    spec_for_path,
    specs_for_pytree,
)
from tpu_on_k8s_torch.train import Trainer, default_optimizer

torch.set_num_threads(1)


def start_fake_world() -> None:
    """A world of 8 ranks (this process is rank 0) whose collectives do
    nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)


def end_fake_world() -> None:
    """Destroy the world and DTensor's sharding-propagation caches with it.
    torch keys those caches by a mesh's shape and axis names, not by its
    world, so the next fake world in this process would replay cached
    specs whose process groups are gone ("Could not resolve the process
    group registered under the name ...")."""
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    dist.destroy_process_group()
    _clear_sharding_prop_cache()


@pytest.fixture(scope="module", autouse=True)
def fake_world():
    start_fake_world()
    yield
    end_fake_world()


def _spec(ref_spec) -> tuple:
    """A reference ``PartitionSpec`` as the port's tuple spec."""
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in ref_spec)


class TestMeshConfig:
    @pytest.mark.parametrize("port, ref", [
        (MeshConfig(data=2, fsdp=-1, model=2, seq=1),
         jmesh.MeshConfig(data=2, fsdp=-1, model=2, seq=1)),
        (MeshConfig(data=8, fsdp=1, model=1, seq=1),
         jmesh.MeshConfig(data=8, fsdp=1, model=1, seq=1)),
    ], ids=["wildcard", "exact"])
    def test_resolve(self, port, ref):
        got = port.resolve(8)
        assert got.axis_sizes() == ref.resolve(8).axis_sizes()
        assert got.describe() == ref.resolve(8).describe()

    def test_resolve_wildcard(self):
        cfg = MeshConfig(data=2, fsdp=-1, model=2, seq=1).resolve(8)
        assert cfg.fsdp == 2

    def test_resolve_exact(self):
        cfg = MeshConfig(data=8, fsdp=1, model=1, seq=1).resolve(8)
        assert cfg.axis_sizes() == (8, 1, 1, 1, 1)

    def test_resolve_mismatch_raises(self):
        with pytest.raises(ValueError, match="needs 6"):
            MeshConfig(data=3, fsdp=2, model=1, seq=1).resolve(8)

    def test_resolve_indivisible_raises(self):
        with pytest.raises(ValueError, match="does not divide"):
            MeshConfig(data=3, fsdp=-1, model=1, seq=1).resolve(8)

    def test_two_wildcards_raise(self):
        with pytest.raises(ValueError, match="at most one"):
            MeshConfig(data=-1, fsdp=-1).resolve(8)


class TestCreateMesh:
    def test_default_all_fsdp(self):
        mesh = create_mesh(device="cpu")
        assert mesh_shape(mesh)[AXIS_FSDP] == 8
        assert mesh_shape(mesh)[AXIS_DATA] == 1

    def test_axis_order_model_innermost(self):
        mesh = create_mesh(MeshConfig(data=2, fsdp=2, model=2, seq=1),
                           device="cpu")
        ref = jmesh.create_mesh(jmesh.MeshConfig(data=2, fsdp=2, model=2,
                                                 seq=1))
        assert mesh.mesh_dim_names[-1] == AXIS_MODEL
        assert mesh.mesh_dim_names == tuple(ref.axis_names)
        assert mesh_shape(mesh) == {AXIS_DATA: 2, AXIS_FSDP: 2, "expert": 1,
                                    AXIS_SEQ: 1, AXIS_MODEL: 2}
        assert mesh_shape(mesh) == dict(ref.shape)
        # the ranks fill the grid as the reference's devices do
        ids = np.vectorize(lambda d: d.id)(ref.devices)
        np.testing.assert_array_equal(mesh.mesh.numpy(), ids)
        assert mesh_axes(mesh) == jmesh.mesh_axes(ref)

    def test_batch_sharding_splits_batch(self):
        mesh = create_mesh(MeshConfig(data=2, fsdp=4, model=1, seq=1),
                           device="cpu")
        s = batch_sharding(mesh)
        assert s.spec == ((AXIS_DATA, AXIS_FSDP),)
        ref = jmesh.batch_sharding(jmesh.create_mesh(jmesh.MeshConfig(
            data=2, fsdp=4, model=1, seq=1)))
        assert s.spec == _spec(ref.spec)

    def test_batch_sharding_seq_axis(self):
        mesh = create_mesh(MeshConfig(data=1, fsdp=2, model=1, seq=4),
                           device="cpu")
        s = batch_sharding(mesh)
        assert s.spec == ((AXIS_DATA, AXIS_FSDP), AXIS_SEQ)

    def test_data_sharding_replicated_and_serving_mesh(self):
        mesh = create_mesh(MeshConfig(data=2, fsdp=4), device="cpu")
        ref = jmesh.create_mesh(jmesh.MeshConfig(data=2, fsdp=4))
        assert data_sharding(mesh).spec == _spec(
            jmesh.data_sharding(ref).spec)
        assert replicated(mesh).spec == _spec(jmesh.replicated(ref).spec)
        assert all(p == Replicate() for p in replicated(mesh).placements)
        smesh = serving_mesh(data=2, model=4, device="cpu")
        assert mesh_shape(smesh) == dict(
            jmesh.serving_mesh(data=2, model=4).shape)

    @pytest.mark.parametrize("shape", [(8, 129), (4, 129), (6, 64)])
    def test_batch_sharding_sheds_like_the_reference(self, shape):
        """An axis that does not divide its dim is shed, as the
        reference's; the rank's rows are its coordinate's block."""
        mesh = create_mesh(MeshConfig(data=2, fsdp=4), device="cpu")
        ref = jmesh.batch_sharding(
            jmesh.create_mesh(jmesh.MeshConfig(data=2, fsdp=4)), shape)
        got = batch_sharding(mesh, shape)
        assert got.spec == _spec(ref.spec)
        tokens = torch.arange(np.prod(shape)).reshape(shape)
        rows = local_rows(tokens, got)
        want = ref.devices_indices_map(shape)[jax_device(0)]
        assert torch.equal(rows, tokens[want])


def jax_device(i: int):
    import jax
    return jax.devices()[i]


RULES = [
    PartitionRule(r"attn/w[qkv]/kernel", (None, AXIS_FSDP, AXIS_MODEL)),
    PartitionRule(r"embed", (AXIS_MODEL, AXIS_FSDP)),
]
JRULES = [
    jpartition.PartitionRule(r"attn/w[qkv]/kernel",
                             P(None, AXIS_FSDP, AXIS_MODEL)),
    jpartition.PartitionRule(r"embed", P(AXIS_MODEL, AXIS_FSDP)),
]


class TestPartitionRules:
    def test_first_match_wins(self):
        rules = [PartitionRule(r"kernel", (AXIS_FSDP,)),
                 PartitionRule(r"attn", (AXIS_MODEL,))]
        assert spec_for_path("attn/kernel", rules) == (AXIS_FSDP,)

    def test_default_replicated(self):
        assert spec_for_path("norm/scale", RULES) == ()
        assert _spec(jpartition.spec_for_path("norm/scale", JRULES)) == ()

    def test_specs_for_pytree(self):
        tree = {"attn": {"wq": {"kernel": torch.zeros(2, 8, 8)}},
                "embed": torch.zeros(16, 8)}
        specs = specs_for_pytree(tree, RULES)
        assert specs["attn"]["wq"]["kernel"] == (None, AXIS_FSDP,
                                                 AXIS_MODEL)
        assert specs["embed"] == (AXIS_MODEL, AXIS_FSDP)
        jspecs = jpartition.specs_for_pytree(
            {"attn": {"wq": {"kernel": np.zeros((2, 8, 8))}},
             "embed": np.zeros((16, 8))}, JRULES)
        assert specs["embed"] == _spec(jspecs["embed"])

    def test_validation_catches_indivisible(self):
        mesh = create_mesh(MeshConfig(data=1, fsdp=4, model=2, seq=1),
                           device="cpu")
        tree = {"attn": {"wq": {"kernel": torch.zeros(2, 6, 8)}}}  # 6 % 4
        with pytest.raises(ValueError, match="not divisible") as ei:
            named_sharding(tree, mesh, RULES)
        assert isinstance(ei.value, ShardingValidationError)
        msg = str(ei.value)
        for part in ("attn/wq/kernel", "dim 1", "fsdp=4",
                     "attn/w[qkv]/kernel"):
            assert part in msg

    def test_shard_pytree_places_leaves(self):
        mesh = create_mesh(MeshConfig(data=1, fsdp=4, model=2, seq=1),
                           device="cpu")
        tree = {"embed": torch.zeros(16, 8), "scale": torch.zeros(4)}
        out = shard_pytree(tree, mesh, RULES)
        names = mesh.mesh_dim_names
        placements = dict(zip(names, out["embed"].placements))
        assert placements[AXIS_MODEL] == Shard(0)
        assert placements[AXIS_FSDP] == Shard(1)
        assert all(p == Replicate() for p in out["scale"].placements)
        # rank 0 holds its block: rows 0-7 of model 0, columns 0-1 of fsdp 0
        assert out["embed"].to_local().shape == (8, 2)
        assert torch.equal(out["embed"].to_local(), torch.zeros(8, 2))

    def test_optimizer_state_inherits_param_specs(self):
        """Adam's mu/nu paths hold the parameter's path: same spec."""
        assert (spec_for_path("0/mu/blocks/attn/wq/kernel", RULES)
                == (None, AXIS_FSDP, AXIS_MODEL))
        assert spec_for_path("0/count", RULES) == ()
        rules = flagship_partition_rules()
        for prefix in ("params/", "mu/", "nu/"):
            assert (spec_for_path(prefix + "blocks.3.attn.wq.weight", rules)
                    == (AXIS_MODEL, AXIS_FSDP))
        assert spec_for_path("count", rules) == ()

    @pytest.mark.parametrize("spec, match", [
        ((AXIS_FSDP, None, None), "names 3 dims"),
        (("nope",), "does not have"),
        (((AXIS_FSDP, AXIS_DATA),), "out of mesh order"),
    ])
    def test_validation_names_the_rule(self, spec, match):
        mesh = create_mesh(MeshConfig(data=2, fsdp=4), device="cpu")
        with pytest.raises(ShardingValidationError, match=match):
            named_sharding({"w": torch.zeros(8, 8)}, mesh,
                           [PartitionRule("w", spec)])


# ---- the port's rules, leaf for leaf against the reference's ----------------

def _ref_path(name: str) -> tuple:
    """(reference path, kind) of a port parameter name: "w" for a
    projection's ``[out, in]`` weight (transposed), "layer" for another
    per-layer leaf (a leading layer axis there), "top" for the rest."""
    parts = name.split(".")
    if parts[0] == "blocks":
        module, leaf = parts[2:-1], parts[-1]
        ref_leaf = {"weight": "kernel", "weight_q": "kernel_q",
                    "weight_scale": "kernel_scale"}.get(leaf, leaf)
        kind = "w" if leaf in ("weight", "weight_q") else "layer"
        return "/".join(["blocks", *module, ref_leaf]), kind
    return "/".join(parts), "top"


def _port_spec_of(ref_spec, kind: str) -> tuple:
    spec = _spec(ref_spec)
    if kind == "top":
        return spec
    spec = spec[1:]                      # the layer axis
    if kind == "w":
        spec = tuple(reversed(spec + (None,) * (2 - len(spec))))
    return spec


def _strip(spec: tuple) -> tuple:
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("changes, serving_int8", [
    ({}, False),
    (dict(fused_qkv=True, mlp_fused_gateup=True), False),
    (dict(pos_emb="learned", norm="ln", activation="gelu", use_bias=True,
          tie_embeddings=True), False),
    (dict(serve_int8_weights=True, decode=True), True),
], ids=["llama", "fused", "gpt2", "w8a16"])
def test_rules_match_the_reference_leaf_for_leaf(changes, serving_int8):
    cfg = dataclasses.replace(TransformerConfig.tiny(), **changes)
    port_rules = serving_partition_rules(int8=serving_int8)
    ref_rules = jtransformer.serving_partition_rules(int8=serving_int8)
    for name, shape in param_shapes(cfg).items():
        path, kind = _ref_path(name)
        want = _port_spec_of(jpartition.spec_for_path(path, ref_rules), kind)
        got = spec_for_path(name, port_rules)
        assert _strip(got) == _strip(want), (name, path, got, want)
        if not serving_int8:
            assert _strip(spec_for_path(name, flagship_partition_rules())) \
                == _strip(_port_spec_of(jpartition.spec_for_path(
                    path, jtransformer.flagship_partition_rules()), kind))


# ---- a model laid out on a mesh ---------------------------------------------

def _model(cfg=None, **changes):
    cfg = dataclasses.replace(cfg or TransformerConfig.tiny(), **changes)
    return load_model(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                       "cpu", torch.float32), "cpu")


def test_trainer_lays_the_model_out_as_the_rules_say():
    mesh = create_mesh(MeshConfig(data=2, fsdp=2, model=2), device="cpu")
    model = _model()
    opt = default_optimizer(model.parameters())
    trainer = Trainer(model, opt, rules=flagship_partition_rules(),
                      mesh=mesh)
    params = dict(trainer.model.named_parameters())
    wq = params["blocks.0.attn.wq.weight"]
    assert wq.device_mesh.mesh_dim_names == ("data", "fsdp", "model")
    assert wq.placements == (Replicate(), Shard(1), Shard(0))
    assert wq.to_local().shape == (64 // 2, 64 // 2)
    assert params["blocks.1.mlp.w_down.weight"].placements == (
        Replicate(), Shard(0), Shard(1))
    assert params["embed"].placements == (Replicate(), Shard(1), Shard(0))
    # the optimizer points at the laid-out parameters, its moments alike
    assert trainer.optimizer.param_groups[0]["params"][0] is next(
        iter(trainer.model.parameters()))
    trainer.optimizer.init_state()
    assert trainer.optimizer.state[wq]["mu"].placements == wq.placements
    assert trainer.data_shard() == (0, 4)


@pytest.mark.parametrize("changes, match", [
    (dict(fused_qkv=True), "fused"),
    (dict(mlp_fused_gateup=True), "fused"),
    (dict(mlp_int8=True, mlp_fused_gateup=False), "int8"),
    (dict(attn_int8=True), "int8"),
    (dict(head_int8=True), "int8"),
])
def test_model_axis_refuses_fused_and_int8_layouts(changes, match):
    """With ``model`` 2 the fused and int8 layouts are laid out as the
    rules say, not refused: a fused weight is a plain split of the
    reference's q | k | v (gate | up) rows, so this rank (fsdp 0, model
    0) holds their first block, as XLA stores it (its block gathers the
    product whole and takes its heads); an int8 projection is the same
    column- or row-parallel ``DTensor`` a bf16 one is."""
    mesh = create_mesh(MeshConfig(fsdp=4, model=2), device="cpu")
    model = _model(**changes)
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(model, rules=flagship_partition_rules(), mesh=mesh)
    params = dict(trainer.model.named_parameters())
    cfg = trainer.model.cfg
    if match == "fused":
        name = ("blocks.0.attn.wqkv.weight" if cfg.fused_qkv
                else "blocks.0.mlp.w_gateup.weight")
        w = params[name]
        assert w.placements == (Shard(1), Shard(0))
        n, k = whole[name].shape
        assert torch.equal(w.to_local(), whole[name][:n // 2, :k // 4])
        block = trainer.model.blocks[0]
        assert block.attn.tp.size == 2 and not block.attn.compact
        assert block.mlp.tp.size == 2 and not block.mlp.compact
    else:
        for name, dim in (("blocks.1.attn.wq.weight", 0),
                          ("blocks.1.attn.wo.weight", 1),
                          ("blocks.0.mlp.w_down.weight", 1),
                          ("lm_head", 1)):
            assert params[name].placements[-1] == Shard(dim), name
        flag = next(iter(changes))
        assert getattr(cfg, flag)


def test_fused_and_int8_layouts_run_on_fsdp_meshes():
    """Without a model axis FSDP2 gathers whole weights: the fused and int8
    layouts are laid out."""
    mesh = create_mesh(MeshConfig(data=2, fsdp=4), device="cpu")
    trainer = Trainer(_model(fused_qkv=True, mlp_fused_gateup=True,
                             mlp_int8=True, head_int8=True),
                      rules=flagship_partition_rules(), mesh=mesh)
    wqkv = dict(trainer.model.named_parameters())["blocks.0.attn.wqkv.weight"]
    assert wqkv.placements == (Replicate(), Shard(1))


def test_indivisible_heads_raise_naming_the_head_count():
    """tiny has 4 query heads on 2 kv heads: model 4 splits a kv head
    across ranks, as the rules split wk's rows. The reference's XLA
    reshards it; the port lays it out as the rules say and each rank runs
    its own query head against both kv heads, gathered whole: this rank's
    query head 0 reads kv head 0."""
    mesh = create_mesh(MeshConfig(fsdp=2, model=4), device="cpu")
    trainer = Trainer(_model(), rules=flagship_partition_rules(), mesh=mesh)
    wk = dict(trainer.model.named_parameters())["blocks.0.attn.wk.weight"]
    assert wk.placements == (Shard(1), Shard(0))
    assert wk.to_local().shape == (2 * 16 // 4, 64 // 2)   # half a head
    attn = trainer.model.blocks[0].attn
    assert (attn.own_q, attn.own_kv, attn.kv_index) == (True, False, (0,))
    with pytest.raises(ShardingValidationError, match="model=3"):
        Trainer(_model(), rules=flagship_partition_rules(),
                mesh=create_mesh(MeshConfig(fsdp=2, model=3),
                                 device="cpu", ranks=range(6)))


def test_trainer_accepts_a_seq_mesh():
    """A ``seq`` axis splits the decoder's sequences: the ``Trainer`` lays
    the model out on it, every block's attention runs over that mesh, and
    ``shard_batch`` keeps each ``[B, L+1]`` row whole over ``seq`` even
    where ``seq`` divides L+1 (the steps cut each rank's chunk after the
    shift); the rows split over ``fsdp`` alone."""
    mesh = create_mesh(MeshConfig(fsdp=4, seq=2), device="cpu")
    trainer = Trainer(_model(attn_impl="ring"),
                      rules=flagship_partition_rules(), mesh=mesh)
    assert all(b.attn.seq_mesh is mesh for b in trainer.model.blocks)
    tokens = torch.arange(8 * 18, dtype=torch.int32).reshape(8, 18)
    assert torch.equal(trainer.shard_batch(tokens), tokens[:2])
    assert trainer.data_shard() == (0, 4)


def test_expert_axis_still_raises():
    """An ``expert`` axis > 1 lays an MoE model's experts out (each rank
    its E/expert experts); it still raises for a dense model and for
    experts it does not divide (naming both numbers). An MoE model lays
    out on a ``seq`` axis: each block routes over the whole sequence."""
    mesh = create_mesh(MeshConfig(fsdp=4, expert=2), device="cpu")
    with pytest.raises(NotImplementedError, match="expert"):
        Trainer(_model(), rules=flagship_partition_rules(), mesh=mesh)
    trainer = Trainer(_model(n_experts=4), rules=flagship_partition_rules(),
                      mesh=mesh)
    w_up = trainer.model.blocks[0].moe.w_up
    assert w_up.shape == (4, 64, 128)
    assert w_up.to_local().shape == (2, 16, 128)
    with pytest.raises(ValueError, match="expert mesh axis \\(2\\) does "
                       "not divide n_experts \\(3\\)"):
        Trainer(_model(n_experts=3), rules=flagship_partition_rules(),
                mesh=create_mesh(MeshConfig(fsdp=4, expert=2), device="cpu"))
    seq_mesh = create_mesh(MeshConfig(fsdp=4, seq=2), device="cpu")
    trainer = Trainer(_model(n_experts=4), rules=flagship_partition_rules(),
                      mesh=seq_mesh)
    moe = trainer.model.blocks[0].moe
    assert moe.seq is not None and moe.seq.size == 2
    assert trainer.model.blocks[0].attn.seq_mesh is seq_mesh
    with pytest.raises(NotImplementedError, match="expert"):
        Trainer(_model(), rules=flagship_partition_rules(),
                mesh=create_mesh(MeshConfig(fsdp=2, seq=2, expert=2),
                                 device="cpu"))


def test_seq_axis_is_refused_where_it_is_not_ported():
    """Serving refuses a ``seq`` axis > 1, as the reference's
    ``serving_mesh`` fixes it at 1; training lays out on it, and
    ``cli_common.bring_up --seq-axis 2`` makes the mesh."""
    from tpu_on_k8s_torch import cli_common
    from tpu_on_k8s_torch.parallel.sharded import check_mesh
    mesh = create_mesh(MeshConfig(fsdp=4, seq=2), device="cpu")
    with pytest.raises(NotImplementedError, match="serving_mesh"):
        check_mesh(TransformerConfig.tiny(), mesh, serving=True)
    check_mesh(TransformerConfig.tiny(), mesh)
    args = cli_common.standard_parser("test").parse_args(
        ["--device", "cpu", "--seq-axis", "2"])
    with cli_common.bring_up(args) as (dev, got):
        assert dev.type == "cpu"
        assert mesh_shape(got)["seq"] == 2


def test_rules_are_validated_before_any_placement():
    mesh = create_mesh(MeshConfig(fsdp=8), device="cpu")
    model = _model()
    bad = [PartitionRule(r"attn\.wq\.weight", (None, None, AXIS_FSDP))]
    with pytest.raises(ShardingValidationError,
                       match=r"blocks\.0\.attn\.wq\.weight.*names 3 dims"):
        Trainer(model, rules=bad, mesh=mesh)
    # nothing was laid out: the model's parameters are plain tensors
    assert not any(hasattr(p, "placements") for p in model.parameters())


def test_named_sharding_placements_match_the_reference_blocks():
    """A spec's blocks per rank, the port's against the reference's
    ``devices_indices_map``, for a tuple entry (outer axis major)."""
    mesh = create_mesh(MeshConfig(data=2, fsdp=4), device="cpu")
    ref_mesh = jmesh.create_mesh(jmesh.MeshConfig(data=2, fsdp=4))
    import jax
    for spec in [((AXIS_DATA, AXIS_FSDP), None), (AXIS_FSDP, AXIS_DATA),
                 (None, AXIS_FSDP)]:
        shape = (16, 8)
        got = NamedSharding(mesh, spec).shard_index(shape)
        ref = jax.sharding.NamedSharding(ref_mesh, P(*spec))
        for dev, idx in ref.devices_indices_map(shape).items():
            want = tuple((s.start or 0, s.stop or n)
                         for s, n in zip(idx, shape))
            assert got[dev.id] == want, (spec, dev.id)


def test_kernel_wrappers_refuse_a_dtensor():
    """A DTensor never reaches a kernel's wrapper: each raises, so a
    sharded call cannot quietly take another route (on a mesh the kernels
    see each rank's local blocks)."""
    from torch.distributed.tensor import distribute_tensor

    from tpu_on_k8s_torch.ops import flash_attention as fa
    from tpu_on_k8s_torch.ops import int8_matmul as i8
    from tpu_on_k8s_torch.ops import quantization as qz
    mesh = create_mesh(MeshConfig(fsdp=8), device="cpu")

    def dt(*shape, dtype=torch.float32):
        return distribute_tensor(torch.zeros(*shape, dtype=dtype), mesh,
                                 [Replicate()] * mesh.ndim,
                                 src_data_rank=None)

    q = dt(1, 2, 8, 16)
    calls = [
        lambda: fa.flash_attention_bhld(q, q, q),
        lambda: fa.flash_with_lse_fwd(q, q, q),
        lambda: i8.int8_matmul(dt(4, 16), dt(8, 16)),
        lambda: i8.int8_matmul_pallas(dt(4, 16), dt(8, 16)),
        lambda: qz.quantize_int8(dt(4, 16)),
        lambda: qz.dequantize_int8(dt(4, 16, dtype=torch.int8), dt(4, 1)),
    ]
    for call in calls:
        with pytest.raises(TypeError, match="not a DTensor"):
            call()
