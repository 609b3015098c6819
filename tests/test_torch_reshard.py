"""Live mesh reconfiguration in the port (``parallel/reshard.py``) against
the JAX package's ``tests/test_reshard.py``, case for case.

The oracle is the reference's: a mid-run 2→4→2 reshard of parameters and
optimizer state, with a {data, fsdp} → {data, model} rule change, gives a
loss trajectory bit-identical to the uninterrupted run on the 2-rank mesh
(here within the port: a world of 4 gloo ranks, the 2-rank mesh on ranks
{0, 1}), and both trajectories match the reference's within
``FP32_TOL``. As there, the step shards the state's storage and gathers it
for the compute (gather → the same replicated step → scatter), so the
per-step arithmetic is the same on every mesh and the oracle holds exactly
what the reshard layer owns: the transform.

The layout cases (plans, byte counts, validation) and the agent's protocol
run in this process, the plans on a world of 8 over ``FakeStore``; the
transforms, the train loop and the checkpoint arm run on one spawned world
(``test_torch_mesh_train.run_world``) whose rank bodies import no JAX.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_torch_mesh_train import FP32_TOL, case_result, run_cases, run_world

torch.set_num_threads(1)

RULES_FSDP_SPECS = {"w1": (("data", "fsdp"), None), "w2": ("fsdp", None)}
RULES_MODEL_SPECS = {"w1": (None, "model"), "w2": (None, "model")}
LR, B1, B2, EPS = 1e-2, 0.9, 0.999, 1e-8
STEPS, UP_AT, DOWN_AT = 9, 3, 6


# ---- the port's harness (no JAX: the rank bodies run it) --------------------

def rules(specs):
    from tpu_on_k8s_torch.parallel.partition import PartitionRule
    return [PartitionRule(f"{name}$", spec) for name, spec in specs.items()]


def mesh_of(n, **axes):
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    return create_mesh(MeshConfig(**{**dict(data=1, fsdp=1, model=1, seq=1),
                                     **axes}), ranks=list(range(n)),
                       device="cpu")


def init_state(seed=0):
    r = np.random.default_rng(seed)
    params = {"w1": torch.from_numpy(r.normal(size=(8, 16)).astype(np.float32)),
              "w2": torch.from_numpy(r.normal(size=(16, 4)).astype(np.float32))}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    return {"params": params,
            "opt": {"mu": dict(zeros),
                    "nu": {k: v.clone() for k, v in zeros.items()},
                    "count": torch.zeros((), dtype=torch.int32)}}


def batch_at(i, seed=7):
    r = np.random.default_rng((seed, i))
    return (torch.from_numpy(r.normal(size=(8, 8)).astype(np.float32)),
            torch.from_numpy(r.normal(size=(8, 4)).astype(np.float32)))


def _compute(state, batch):
    """The replicated step body on full tensors: optax.adam(1e-2)'s
    arithmetic on the reference's loss."""
    x, y = batch
    p = {k: v.detach().clone().requires_grad_() for k, v
         in state["params"].items()}
    loss = ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()
    loss.backward()
    count = state["opt"]["count"] + 1
    c = count.float()
    new = {"params": {}, "opt": {"mu": {}, "nu": {}, "count": count}}
    for k in p:
        g = p[k].grad
        mu = (1 - B1) * g + B1 * state["opt"]["mu"][k]
        nu = (1 - B2) * g * g + B2 * state["opt"]["nu"][k]
        mu_hat = mu / (1 - B1 ** c)
        nu_hat = nu / (1 - B2 ** c)
        new["params"][k] = state["params"][k] + (
            -LR * (mu_hat / (torch.sqrt(nu_hat) + EPS)))
        new["opt"]["mu"][k], new["opt"]["nu"][k] = mu, nu
    return new, {"loss": loss.detach()}


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def make_step(mesh, rule_list, state_tree):
    """Storage-sharded, compute-gathered step: gather(state) → the
    replicated compute → scatter onto (mesh, rules). A rank outside the
    mesh holds no block and computes nothing."""
    from tpu_on_k8s_torch.parallel.partition import named_sharding
    from torch.distributed.tensor import distribute_tensor
    shardings = named_sharding(state_tree, mesh, rule_list)

    def step(state, batch):
        if mesh.get_coordinate() is None:
            return state, {"loss": torch.tensor(float("nan"))}
        out, m = _compute(_map(lambda t: t.full_tensor(), state), batch)
        from tpu_on_k8s_torch.parallel.partition import map_tree
        return map_tree(lambda path, t: distribute_tensor(
            t, mesh, shardings[path].placements, src_data_rank=None),
            out), m

    return step


def run_fixed(n, rule_list, steps, **axes):
    from tpu_on_k8s_torch.parallel.partition import shard_pytree
    mesh = mesh_of(n, **axes)
    state = shard_pytree(init_state(), mesh, rule_list)
    step = make_step(mesh, rule_list, state)
    losses = []
    for i in range(steps):
        state, m = step(state, batch_at(i))
        losses.append(float(m["loss"]))
    return losses, _full(state)


def _full(state):
    """Every leaf's full value (a collective on its mesh's members)."""
    from torch.distributed.tensor import DTensor
    return _map(lambda t: (t.full_tensor() if isinstance(t, DTensor)
                           and t.device_mesh.get_coordinate() is not None
                           else t.to_local() if isinstance(t, DTensor)
                           else t).clone(), state)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---- the world's cases -------------------------------------------------------

def _case_round_trip():
    from tpu_on_k8s_torch.parallel.partition import shard_pytree
    from tpu_on_k8s_torch.parallel.reshard import reshard_state
    mesh2, mesh4 = mesh_of(2, fsdp=2), mesh_of(4, data=2, model=2)
    state = shard_pytree(init_state(), mesh2, rules(RULES_FSDP_SPECS))
    before = _full(state)
    moved, plan = reshard_state(state, mesh2, rules(RULES_FSDP_SPECS),
                                mesh4, rules(RULES_MODEL_SPECS))
    w1 = moved["params"]["w1"]
    back, _ = reshard_state(moved, mesh4, rules(RULES_MODEL_SPECS), mesh2,
                            rules(RULES_FSDP_SPECS))
    after = _full(back)
    return dict(n_moved=plan.n_moved, w1_placements=" ".join(map(str, w1.placements)),
                w1_ranks=w1.device_mesh.mesh.flatten().tolist(),
                equal=all(torch.equal(a, b) for a, b in zip(
                    _flat(before).values(), _flat(after).values())))


def _resharded_run(via_checkpoint, tmp):
    from tpu_on_k8s_torch.parallel.partition import shard_pytree
    from tpu_on_k8s_torch.parallel.reshard import (
        reshard_state,
        restore_resharded,
    )
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
    fsdp, model = rules(RULES_FSDP_SPECS), rules(RULES_MODEL_SPECS)
    mesh2, mesh4 = mesh_of(2, fsdp=2), mesh_of(4, data=2, model=2)
    state = shard_pytree(init_state(), mesh2, fsdp)
    step = make_step(mesh2, fsdp, state)
    losses, moved = [], []
    schedule = {UP_AT: (mesh2, fsdp, mesh4, model),
                DOWN_AT: (mesh4, model, mesh2, fsdp)}
    for i in range(STEPS):
        hop = schedule.get(i)
        if hop is not None:
            src_mesh, src_rules, dst_mesh, dst_rules = hop
            if via_checkpoint:
                mgr = CheckpointManager(f"{tmp}/gen{i}")
                mgr.save(state, step=i, generation=i)
                state, _, _ = restore_resharded(mgr, state, dst_mesh,
                                                dst_rules)
                mgr.close()
            else:
                state, plan = reshard_state(state, src_mesh, src_rules,
                                            dst_mesh, dst_rules)
                moved.append(plan.n_moved)
            step = make_step(dst_mesh, dst_rules, state)
        state, m = step(state, batch_at(i))
        losses.append(float(m["loss"]))
    return dict(losses=losses, state=_flat(_full(state)), moved=moved)


def _notices(generation=None):
    from tpu_on_k8s_torch.parallel.reshard import ReshardNotice
    fsdp, model = rules(RULES_FSDP_SPECS), rules(RULES_MODEL_SPECS)
    mesh2, mesh4 = mesh_of(2, fsdp=2), mesh_of(4, data=2, model=2)
    return (mesh2, mesh4,
            [ReshardNotice(mesh2, fsdp, mesh4, model,
                           step_builder=lambda m, st: make_step(m, model, st),
                           generation=generation, tag="up"),
             ReshardNotice(mesh4, model, mesh2, fsdp,
                           step_builder=lambda m, st: make_step(m, fsdp, st),
                           tag="down")])


def _run_loop(steps=9, up_at=4, down_at=7, use_up_only=False,
              reshard_generation=None, **loop_kwargs):
    """A TrainLoop whose reshard_signal delivers 2→4 before loop step
    ``up_at`` and 4→2 before ``down_at`` (1-based)."""
    from tpu_on_k8s_torch.parallel.partition import shard_pytree
    from tpu_on_k8s_torch.train.loop import TrainLoop
    mesh2, _, notices = _notices(reshard_generation)
    if use_up_only:
        notices = notices[:1]
    fsdp = rules(RULES_FSDP_SPECS)
    state = shard_pytree(init_state(), mesh2, fsdp)
    fired = {"n": 0}

    def signal():
        fired["n"] += 1
        if fired["n"] == up_at:
            return notices[0]
        if len(notices) > 1 and fired["n"] == down_at:
            return notices[1]
        return None

    loop = TrainLoop(make_step(mesh2, fsdp, state), state,
                     (batch_at(i) for i in range(steps)),
                     reshard_signal=signal, **loop_kwargs)
    return loop.run(steps)


def _case_loop_global_steps():
    result = _run_loop(log_every=1)
    return dict(steps=result.steps, preempted=result.preempted,
                reshards=result.reshards,
                fallback=result.reshard_fallback,
                history_steps=[s for s, _ in result.history],
                losses=[h["loss"] for _, h in result.history])


def _case_loop_accounting():
    from tpu_on_k8s_torch.metrics import ReshardMetrics, TrainMetrics
    from tpu_on_k8s_torch.obs.account import TrainingAccountant
    tmetrics = TrainMetrics(registry=None)
    rmetrics = ReshardMetrics(registry=None)
    acct = TrainingAccountant(metrics=tmetrics)
    result = _run_loop(log_every=3, accountant=acct, metrics=tmetrics,
                       reshard_metrics=rmetrics)
    return dict(reshards=result.reshards, waste=dict(acct.waste_s),
                goodput=acct.goodput_fraction(),
                gauge=tmetrics.gauges["goodput_fraction"],
                counters=dict(rmetrics.counters),
                transform_seconds=rmetrics.gauges["transform_seconds"])


def _case_loop_spans():
    from tpu_on_k8s_torch.obs.trace import Tracer
    tracer = Tracer(time.monotonic)
    _run_loop(log_every=2, tracer=tracer)
    return tracer.export()


def _case_loop_drains():
    drains = []

    class Mgr:
        def save(self, state, *, step, generation=0, wait=True):
            drains.append(("save", step, generation, wait))

        def wait_until_finished(self):
            drains.append(("drain",))

    result = _run_loop(log_every=10, checkpoint_manager=Mgr(),
                       checkpoint_every=2, use_up_only=True, up_at=4,
                       reshard_generation=5)
    return dict(drains=drains, history_steps=[s for s, _ in result.history])


def _case_loop_abort(tmp):
    from tpu_on_k8s_torch import chaos
    from tpu_on_k8s_torch.metrics import ReshardMetrics
    from tpu_on_k8s_torch.parallel.partition import shard_pytree
    from tpu_on_k8s_torch.parallel.reshard import restore_resharded
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
    from tpu_on_k8s_torch.train.loop import TrainLoop
    fsdp = rules(RULES_FSDP_SPECS)
    mgr = CheckpointManager(f"{tmp}/abort")
    rmetrics = ReshardMetrics(registry=None)
    mesh2, _, notices = _notices()
    state = shard_pytree(init_state(), mesh2, fsdp)
    fired = {"n": 0}

    def signal():
        fired["n"] += 1
        return notices[0] if fired["n"] == 4 else None

    failed = []
    notices[0].on_failed = lambda: failed.append(True)
    loop = TrainLoop(make_step(mesh2, fsdp, state), state,
                     (batch_at(i) for i in range(9)), log_every=1,
                     reshard_signal=signal, reshard_metrics=rmetrics,
                     checkpoint_manager=mgr)
    inj = chaos.live_reshard_abort(at_transform=1).injector()
    with inj:
        result = loop.run(9)
    out = dict(fired=inj.fired_total(), events=list(inj.events),
               fallback=result.reshard_fallback,
               preempted=result.preempted, steps=result.steps,
               reshards=result.reshards,
               fallbacks=rmetrics.counters["reshard_fallbacks"],
               failed=failed)
    restored, _, at = restore_resharded(mgr, init_state(), mesh_of(2, fsdp=2),
                                        fsdp)
    resumed = TrainLoop(make_step(mesh_of(2, fsdp=2), fsdp, restored),
                        restored, (batch_at(i) for i in range(3, 9)),
                        log_every=1).run(6)
    out.update(at=at, stitched=[h["loss"] for _, h in result.history]
               + [h["loss"] for _, h in resumed.history])
    mgr.close()
    return out


def _case_loop_failed_ack():
    from tpu_on_k8s_torch.metrics import ReshardMetrics
    from tpu_on_k8s_torch.parallel.partition import shard_pytree
    from tpu_on_k8s_torch.train.loop import TrainLoop
    fsdp = rules(RULES_FSDP_SPECS)
    rmetrics = ReshardMetrics(registry=None)
    mesh2, _, notices = _notices()

    def boom():
        raise ConnectionResetError("apiserver blipped")

    notices[0].on_applied = boom
    state = shard_pytree(init_state(), mesh2, fsdp)
    fired = {"n": 0}

    def signal():
        fired["n"] += 1
        return notices[0] if fired["n"] == 3 else None

    result = TrainLoop(make_step(mesh2, fsdp, state), state,
                       (batch_at(i) for i in range(6)), log_every=2,
                       reshard_signal=signal,
                       reshard_metrics=rmetrics).run(6)
    return dict(steps=result.steps, reshards=result.reshards,
                preempted=result.preempted,
                ack_failures=rmetrics.counters["reshard_ack_failures"])


def _case_restore_other_layout(tmp):
    from tpu_on_k8s_torch.parallel.partition import shard_pytree
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
    mesh2, mesh4 = mesh_of(2, fsdp=2), mesh_of(4, data=2, model=2)
    state = shard_pytree(init_state(), mesh2, rules(RULES_FSDP_SPECS))
    mgr = CheckpointManager(f"{tmp}/other")
    mgr.save(state, step=7, generation=2)
    restored, gen, at = mgr.restore(_map(torch.zeros_like, init_state()),
                                    mesh=mesh4,
                                    rules=rules(RULES_MODEL_SPECS))
    w1 = restored["params"]["w1"]
    out = dict(gen_step=(gen, at), w1_placements=" ".join(map(str, w1.placements)),
               w1_ranks=w1.device_mesh.mesh.flatten().tolist(),
               w1_local=tuple(w1.to_local().shape),
               equal=all(torch.equal(a, b) for a, b in zip(
                   _flat(_full(state)).values(),
                   _flat(_full(restored)).values())))
    mgr.close()
    return out


def _case_restore_validates(tmp):
    from tpu_on_k8s_torch.parallel.partition import (
        PartitionRule,
        ShardingValidationError,
        shard_pytree,
    )
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
    mesh2 = mesh_of(2, fsdp=2)
    state = shard_pytree(init_state(), mesh2, rules(RULES_FSDP_SPECS))
    mgr = CheckpointManager(f"{tmp}/validates")
    mgr.save(state, step=1)
    mesh3 = mesh_of(3, model=3)
    bad = [PartitionRule(r"w1$|w2$", ("model", None))]   # 8 % 3 != 0
    try:
        mgr.restore(state, mesh=mesh3, rules=bad)
    except ShardingValidationError as e:
        return str(e)
    finally:
        mgr.close()
    return None


def _reshard_world(rank, world, tmp):
    fsdp = rules(RULES_FSDP_SPECS)
    return run_cases(rank, {
        "fixed": lambda: run_fixed(2, fsdp, STEPS, fsdp=2),
        "round_trip": _case_round_trip,
        "live": lambda: _resharded_run(False, tmp),
        "via_checkpoint": lambda: _resharded_run(True, tmp),
        "loop_global_steps": _case_loop_global_steps,
        "loop_accounting": _case_loop_accounting,
        "loop_spans": _case_loop_spans,
        "loop_drains": _case_loop_drains,
        "loop_abort": lambda: _case_loop_abort(tmp),
        "loop_failed_ack": _case_loop_failed_ack,
        "restore_other_layout": lambda: _case_restore_other_layout(tmp),
        "restore_validates": lambda: _case_restore_validates(tmp),
    })


# ---- the parent --------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    return run_world(_reshard_world, (str(tmp),), tmp)


@pytest.fixture(scope="module")
def reference_losses():
    """The reference's uninterrupted 2-device trajectory
    (``tests/test_reshard.py``'s ``run_fixed``)."""
    import test_reshard
    return test_reshard.run_fixed(2, test_reshard.RULES_FSDP,
                                  STEPS, fsdp=2)


def _fixed(world):
    return case_result(world, "fixed")


class TestPlan:
    """Plans and byte counts, in this process on a world of 8."""

    @pytest.fixture(scope="class", autouse=True)
    def fake_world(self):
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        yield
        dist.destroy_process_group()

    def _state(self, mesh):
        from tpu_on_k8s_torch.parallel.partition import shard_pytree
        return shard_pytree(init_state(), mesh, rules(RULES_FSDP_SPECS))

    def test_plan_counts_moved_leaves_and_bytes(self):
        from tpu_on_k8s_torch.parallel.reshard import plan_reshard
        mesh2, mesh4 = mesh_of(2, fsdp=2), mesh_of(4, data=2, model=2)
        state = self._state(mesh2)
        plan = plan_reshard(state, mesh2, rules(RULES_FSDP_SPECS), mesh4,
                            rules(RULES_MODEL_SPECS))
        leaves = _flat(state)
        assert len(plan.moves) == len(leaves)
        # every leaf moves: the rank set changed
        assert plan.n_moved == len(leaves)
        assert plan.bytes_moved == sum(t.numel() * t.element_size()
                                       for t in leaves.values())
        assert "reshard fsdp=2 -> data=2,model=2" in plan.describe()

    def test_identity_plan_moves_nothing(self):
        from tpu_on_k8s_torch.parallel.reshard import plan_reshard
        mesh2 = mesh_of(2, fsdp=2)
        plan = plan_reshard(self._state(mesh2), mesh2,
                            rules(RULES_FSDP_SPECS), mesh2,
                            rules(RULES_FSDP_SPECS))
        assert plan.n_moved == 0 and plan.bytes_moved == 0

    def test_axis_size_swap_on_same_devices_counts_as_moved(self):
        """Same ranks, same spec names, other axis sizes ({data:2, fsdp:4}
        -> {data:4, fsdp:2}): the blocks move, so the plan prices it."""
        from tpu_on_k8s_torch.parallel.partition import (
            PartitionRule,
            shard_pytree,
        )
        from tpu_on_k8s_torch.parallel.reshard import plan_reshard
        mesh_a, mesh_b = mesh_of(8, data=2, fsdp=4), mesh_of(8, data=4,
                                                             fsdp=2)
        rule_list = [PartitionRule(r"w1$|w2$", ("fsdp", None))]
        state = shard_pytree(init_state(), mesh_a, rule_list)
        plan = plan_reshard(state, mesh_a, rule_list, mesh_b, rule_list)
        sharded = [m for m in plan.moves if "w" in m.path]
        assert sharded and all(m.moved for m in sharded)
        assert plan.bytes_moved > 0

    def test_illegal_destination_fails_before_any_move(self):
        from tpu_on_k8s_torch.parallel.partition import (
            PartitionRule,
            ShardingValidationError,
        )
        from tpu_on_k8s_torch.parallel.reshard import plan_reshard
        from torch.distributed.tensor import Shard
        mesh2, mesh3 = mesh_of(2, fsdp=2), mesh_of(3, model=3)
        bad = [PartitionRule(r"w1$|w2$", ("model", None))]  # 8 % 3 != 0
        state = self._state(mesh2)
        with pytest.raises(ShardingValidationError) as ei:
            plan_reshard(state, mesh2, rules(RULES_FSDP_SPECS), mesh3, bad)
        msg = str(ei.value)
        assert "w2" in msg or "w1" in msg
        assert "model" in msg and "not divisible" in msg
        # untouched: still the source layout on the source mesh
        assert state["params"]["w1"].placements[1] == Shard(0)

    def test_reshard_spec_round_trip(self):
        from tpu_on_k8s.gang import topology
        from tpu_on_k8s_torch.parallel.reshard import (
            format_reshard_spec,
            parse_reshard_spec,
        )
        spec = format_reshard_spec(3, 4, {"data": 2, "fsdp": 8, "model": 1})
        assert spec == "gen=3;hosts=4;mesh=data=2,fsdp=8"
        assert spec == topology.format_reshard_spec(
            3, 4, {"data": 2, "fsdp": 8, "model": 1})
        assert parse_reshard_spec(spec) == (3, 4, {"data": 2, "fsdp": 8})
        for raw in ("garbage", "gen=x;hosts=2;mesh=", "gen=1;hosts=0;mesh=",
                    spec):
            assert parse_reshard_spec(raw) == topology.parse_reshard_spec(raw)
        assert parse_reshard_spec("garbage") is None


class TestBitExactOracle:
    def test_fixed_run_matches_the_reference(self, world, reference_losses):
        losses, state = _fixed(world)
        np.testing.assert_allclose(losses, reference_losses[0],
                                   atol=FP32_TOL["loss"], rtol=0)
        ref = reference_losses[1]
        for k in ("w1", "w2"):
            np.testing.assert_allclose(state["params"][k].numpy(),
                                       np.asarray(ref["params"][k]),
                                       atol=FP32_TOL["params"], rtol=0)

    def test_reshard_state_round_trip_is_bit_exact(self, world):
        got = case_result(world, "round_trip")
        assert got["n_moved"] > 0
        assert got["w1_placements"] == "R R R R S(1)"
        assert got["w1_ranks"] == [0, 1, 2, 3]
        assert got["equal"]

    def test_live_reshard_trajectory_bit_identical(self, world,
                                                   reference_losses):
        fixed_losses, fixed_state = _fixed(world)
        live = case_result(world, "live")
        assert all(n > 0 for n in live["moved"])
        assert live["losses"] == fixed_losses
        # optimizer state included: every leaf bit-equal at the end
        for k, v in _flat(fixed_state).items():
            assert torch.equal(v, live["state"][k]), k
        np.testing.assert_allclose(live["losses"], reference_losses[0],
                                   atol=FP32_TOL["loss"], rtol=0)

    def test_checkpoint_restart_reshard_trajectory_bit_identical(self,
                                                                 world):
        assert case_result(world, "via_checkpoint")["losses"] == \
            _fixed(world)[0]


class TestTrainLoopReshard:
    def test_run_never_exits_and_counts_global_steps(self, world):
        got = case_result(world, "loop_global_steps")
        assert got["steps"] == 9 and not got["preempted"]
        assert got["reshards"] == 2 and not got["fallback"]
        assert got["history_steps"] == list(range(1, 10))
        assert got["losses"] == _fixed(world)[0]

    def test_pause_attributed_to_reshard_not_restart(self, world):
        got = case_result(world, "loop_accounting")
        assert got["reshards"] == 2
        assert got["waste"]["reshard"] > 0
        assert got["waste"]["restart"] == 0 and got["waste"]["preempt"] == 0
        assert 0 < got["goodput"] < 1
        assert got["gauge"] == pytest.approx(got["goodput"])
        assert got["counters"]["reshards"] == 2
        assert got["counters"]["bytes_moved"] > 0
        assert got["transform_seconds"] > 0
        assert got["counters"].get("reshard_fallbacks", 0) == 0

    def test_reshard_span_on_the_trace_timeline(self, world):
        spans = case_result(world, "loop_spans")
        reshards = [s for s in spans if s["name"] == "train.reshard"]
        assert len(reshards) == 2
        assert [s["attrs"]["tag"] for s in reshards] == ["up", "down"]
        assert all(s["status"] == "ok" for s in reshards)
        assert all(s["attrs"]["bytes_moved"] > 0 for s in reshards)
        # the partial window the first reshard synced adds a sixth
        assert [s["name"] for s in spans].count("train.window") == 6

    def test_pending_window_and_saves_drain_before_transform(self, world):
        got = case_result(world, "loop_drains")
        drains = got["drains"]
        assert drains[0] == ("save", 2, 0, False)
        assert drains[1] == ("drain",)
        assert got["history_steps"][0] == 3
        # the saves after the reshard land in the notice's generation
        assert ("save", 4, 5, False) in drains

    def test_abort_falls_back_to_checkpoint_restart_uncorrupted(self, world):
        got = case_result(world, "loop_abort")
        assert got["fired"] == 1
        assert "reshard_abort" in got["events"][0]
        assert got["fallback"] and got["preempted"]
        assert got["steps"] == 3 and got["reshards"] == 0
        assert got["fallbacks"] == 1
        assert got["failed"] == [True]
        # the preemption path saved the intact pre-transform state: the
        # resumed run reproduces the fault-free trajectory exactly
        assert got["at"] == 3
        assert got["stitched"] == _fixed(world)[0]

    def test_failed_ack_does_not_kill_the_run(self, world):
        got = case_result(world, "loop_failed_ack")
        assert got["steps"] == 6 and got["reshards"] == 1
        assert not got["preempted"]
        assert got["ack_failures"] == 1

    def test_warm_batch_has_nothing_to_compile(self):
        """The reference's ``warm_batch`` AOT-compiles the rebuilt jitted
        step; the port's steps are eager, so a notice refuses one before
        anything moves."""
        from tpu_on_k8s_torch.parallel.reshard import ReshardNotice
        with pytest.raises(ValueError, match="nothing to compile"):
            ReshardNotice(None, [], None, [], warm_batch=batch_at(0))


class TestRestoreIntoDifferentLayout:
    def test_restore_accepts_target_sharding_differing_from_saved(self,
                                                                   world):
        got = case_result(world, "restore_other_layout")
        assert got["gen_step"] == (2, 7)
        assert got["w1_placements"] == "R R R R S(1)"
        assert got["w1_ranks"] == [0, 1, 2, 3]
        # each rank reads its block of the new layout only
        assert got["w1_local"] == (8, 8)
        assert got["equal"]

    def test_restore_rejects_half_specified_target(self, tmp_path):
        from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(ValueError, match="mesh and rules together"):
            mgr.restore(init_state(), mesh=object())
        mgr.close()

    def test_restore_validates_target_layout_before_reading(self, world):
        msg = case_result(world, "restore_validates")
        assert msg is not None and "not divisible" in msg and "model" in msg


class TestReshardAgent:
    def _cluster_with_job(self, annotations=None):
        from tpu_on_k8s.api.core import (
            Container,
            ObjectMeta,
            PodSpec,
            PodTemplateSpec,
        )
        from tpu_on_k8s.api.types import TaskSpec, TaskType, TPUJob, TPUJobSpec
        from tpu_on_k8s.client import InMemoryCluster

        cluster = InMemoryCluster()
        template = PodTemplateSpec(
            spec=PodSpec(containers=[Container(name="t", image="i")]))
        job = TPUJob(metadata=ObjectMeta(name="rj",
                                         annotations=annotations or {}),
                     spec=TPUJobSpec(tasks={TaskType.MASTER: TaskSpec(
                         num_tasks=1, template=template)}))
        cluster.create(job)
        return cluster

    @staticmethod
    def _agent(cluster, factory, **kw):
        from tpu_on_k8s.api.types import TPUJob
        from tpu_on_k8s_torch.parallel.reshard import ReshardAgent
        kw.setdefault("min_poll_interval_s", 0)
        return ReshardAgent(cluster, "default", "rj", factory, TPUJob, **kw)

    def _factory_recording(self, seen):
        from tpu_on_k8s_torch.parallel.reshard import ReshardNotice

        def factory(mesh_shape, generation):
            seen.append((mesh_shape, generation))
            return ReshardNotice(None, [], None, [])

        return factory

    @staticmethod
    def _annotations(cluster):
        from tpu_on_k8s.api.types import TPUJob
        return cluster.get(TPUJob, "default", "rj").metadata.annotations

    def test_request_becomes_notice_and_ack_closes_protocol(self):
        from tpu_on_k8s_torch import constants
        cluster = self._cluster_with_job({
            constants.ANNOTATION_RESHARD_REQUESTED_SPEC:
                "gen=4;hosts=2;mesh=data=2,fsdp=4"})
        seen = []
        agent = self._agent(cluster, self._factory_recording(seen))
        notice = agent.poll()
        assert notice is not None and notice.generation == 4
        assert seen == [({"data": 2, "fsdp": 4}, 4)]
        notice.on_applied()
        assert self._annotations(cluster)[
            constants.ANNOTATION_RESHARD_COMPLETED_SPEC] == "4"
        # an acknowledged request is not delivered again
        assert agent.poll() is None

    def test_failed_transform_clears_the_request(self):
        from tpu_on_k8s_torch import constants
        cluster = self._cluster_with_job({
            constants.ANNOTATION_RESHARD_REQUESTED_SPEC:
                "gen=4;hosts=2;mesh=fsdp=8"})
        agent = self._agent(cluster, self._factory_recording([]))
        notice = agent.poll()
        notice.on_failed()
        assert constants.ANNOTATION_RESHARD_REQUESTED_SPEC \
            not in self._annotations(cluster)
        assert agent.poll() is None

    def test_malformed_or_absent_request_is_no_request(self):
        from tpu_on_k8s_torch import constants
        agent = self._agent(self._cluster_with_job(),
                            self._factory_recording([]))
        assert agent.poll() is None
        agent2 = self._agent(self._cluster_with_job({
            constants.ANNOTATION_RESHARD_REQUESTED_SPEC: "not-a-spec"}),
            self._factory_recording([]))
        assert agent2.poll() is None

    def test_factory_decline_withdraws_the_request(self):
        from tpu_on_k8s_torch import constants
        cluster = self._cluster_with_job({
            constants.ANNOTATION_RESHARD_REQUESTED_SPEC:
                "gen=4;hosts=8;mesh=fsdp=32"})
        agent = self._agent(cluster, lambda shape, gen: None)
        assert agent.poll() is None
        assert constants.ANNOTATION_RESHARD_REQUESTED_SPEC \
            not in self._annotations(cluster)

    def test_poll_is_rate_limited_off_the_hot_loop(self):
        from tpu_on_k8s_torch import constants
        cluster = self._cluster_with_job({
            constants.ANNOTATION_RESHARD_REQUESTED_SPEC:
                "gen=4;hosts=2;mesh=fsdp=8"})
        gets = {"n": 0}
        real_try_get = cluster.try_get

        def counting_try_get(*a, **k):
            gets["n"] += 1
            return real_try_get(*a, **k)

        cluster.try_get = counting_try_get
        clock = {"t": 0.0}
        agent = self._agent(cluster, self._factory_recording([]),
                            min_poll_interval_s=5.0,
                            clock=lambda: clock["t"])
        assert agent.poll() is not None
        for _ in range(50):                 # 50 steps inside the window
            assert agent.poll() is None
        assert gets["n"] == 1
        clock["t"] = 6.0
        assert agent.poll() is not None
        assert gets["n"] == 2

    def test_factory_hooks_chain_before_the_agent_ack(self):
        from tpu_on_k8s_torch import constants
        from tpu_on_k8s_torch.parallel.reshard import ReshardNotice
        cluster = self._cluster_with_job({
            constants.ANNOTATION_RESHARD_REQUESTED_SPEC:
                "gen=4;hosts=2;mesh=fsdp=8"})
        order = []
        agent = self._agent(cluster, lambda shape, gen: ReshardNotice(
            None, [], None, [], on_applied=lambda: order.append("factory")))
        agent.poll().on_applied()
        assert order == ["factory"]
        assert self._annotations(cluster)[
            constants.ANNOTATION_RESHARD_COMPLETED_SPEC] == "4"

    def test_ack_survives_a_deleted_job(self):
        from tpu_on_k8s.api.types import TPUJob
        from tpu_on_k8s_torch import constants
        cluster = self._cluster_with_job({
            constants.ANNOTATION_RESHARD_REQUESTED_SPEC:
                "gen=4;hosts=2;mesh=fsdp=8"})
        notice = self._agent(cluster, self._factory_recording([])).poll()
        cluster.delete(TPUJob, "default", "rj")
        notice.on_applied()                 # must not raise
        notice.on_failed()                  # must not raise


def test_protocol_constants_are_the_operators():
    from tpu_on_k8s.api import constants as ref
    from tpu_on_k8s_torch import constants
    for name in ("ANNOTATION_RESHARD_REQUESTED_SPEC",
                 "ANNOTATION_RESHARD_COMPLETED_SPEC",
                 "ENV_COORDINATOR_ADDRESS", "ENV_NUM_PROCESSES",
                 "ENV_PROCESS_ID", "ENV_TPU_WORKER_HOSTNAMES",
                 "ENV_MEGASCALE_NUM_SLICES", "ENV_MEGASCALE_SLICE_ID",
                 "ENV_MODEL_PATH"):
        assert getattr(constants, name) == getattr(ref, name), name
