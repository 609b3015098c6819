"""Reshard soak: live mesh reconfiguration against checkpoint-restart,
raced on the seeded virtual-clock cost model, twice, byte-compared (the
counterpart of the reference's ``tools/reshard_soak.py``).

One fixed seed drives the same elastic-training timeline through two arms:

* **live arm**: the mid-run 2→4→2 rescale lands as a state transform
  (``parallel/reshard.py``): the transfer plan comes from the real planner
  over an abstract flagship-shaped state (meta tensors: shapes and dtypes,
  no data), so the bytes moved come from the per-leaf layout diff; the
  pause is plan bytes over interconnect bandwidth plus a warm compile, and
  the ``TrainingAccountant`` books it in the ``reshard`` bucket while the
  global steps keep counting.
* **restart arm**: the same rescale as a cold restart: final checkpoint,
  teardown, reschedule, cold recompile, restore, and a replay of every step
  since the last periodic checkpoint, each booked in its own waste bucket.

Both arms feed the real ``TrainingAccountant`` and ``ReshardMetrics`` and
emit deterministic event lines (no wall clock: the cost model is the
clock); ``--repeat 2`` (the default) asserts the logs replay
byte-identically. The live arm's pause must beat the restart arm's, and its
``goodput_fraction`` must end higher.

The planner needs meshes of 2 and 4 ranks in this one process: with no
``torch.distributed`` world initialised, the soak makes a world of 8 ranks
whose collectives do nothing (the ``fake`` backend; this process is rank
0) and destroys it afterwards together with DTensor's sharding-propagation
cache, so a later world in the process starts clean.

``--bench`` swaps the cost model for the real thing: a small train state
moves 2→4→2 through ``TrainLoop`` and ``ReshardNotice`` on a spawned world
of 4 ranks (gloo with ``--device cpu``; NCCL, one card a rank, with
``--device cuda``, which needs 4 cards and raises otherwise), recording the
measured pause seconds and bytes.

Usage::

    python -m tpu_on_k8s_torch.reshard_soak                  # seed 6172
    python -m tpu_on_k8s_torch.reshard_soak --seed 7 --repeat 1
    python -m tpu_on_k8s_torch.reshard_soak --bench --device cpu

On failure the seed is printed (``RESHARD_SOAK_FAILED seed=...``) on stderr.
The cost-model race touches no device; ``--device`` picks the ``--bench``
world's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
import tempfile
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch.device import resolve_device

DEFAULT_SEED = 6172

# ---- the cost model (seconds; stated once so both arms price identically)
STEP_DT_2 = 0.050            # per-step seconds on the 2-chip mesh
EFFICIENCY = 0.85            # scaling efficiency going 2 -> 4 chips
RESHARD_BW = 10e9            # bytes/s the transform moves shards at
WARM_COMPILE_S = 2.0         # warm compile through the persistent cache
SAVE_BW = 2e9                # checkpoint write bandwidth
COLD_COMPILE_S = 120.0       # the cold-restart recompile
TEARDOWN_S = 10.0            # SIGTERM -> pods gone
RESCHEDULE_S = 20.0          # gang rescheduling + image pull (warm node)
INIT_S = 30.0                # process boot + backend init + restore read

#: the ``--bench`` world
BENCH_WORLD = 4


def _abstract_state(n_layers: int = 12, d_model: int = 768,
                    d_ff: int = 3072) -> dict:
    """Flagship-shaped abstract params and Adam moments: fp32 tensors on
    the meta device (the planner needs shapes and dtypes, never data)."""

    def leaf(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    def params():
        p = {f"layers_{i}": {
            "attn": {"wqkv": {"kernel": leaf(d_model, 3 * d_model)},
                     "wo": {"kernel": leaf(d_model, d_model)}},
            "mlp": {"w_gateup": {"kernel": leaf(d_model, 2 * d_ff)},
                    "w_down": {"kernel": leaf(d_ff, d_model)}}}
            for i in range(n_layers)}
        p["embed"] = leaf(32768, d_model)
        return p

    return {"params": params(), "mu": params(), "nu": params()}


@contextlib.contextmanager
def planning_world():
    """A world for the planner's meshes: the initialised one if it has the
    4 ranks of the larger mesh, else (with none initialised) a ``fake``
    world of 8 ranks made here and destroyed on exit with DTensor's
    sharding-propagation cache (torch keys that cache by a mesh's shape and
    axis names, not by its world, so a later world would replay specs whose
    process groups are gone)."""
    if dist.is_initialized():
        if dist.get_world_size() < 4:
            raise RuntimeError(
                f"the planner needs 4 ranks; the initialised world has "
                f"{dist.get_world_size()}")
        yield
        return
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _clear_sharding_prop_cache()


def _plans() -> Tuple[object, object]:
    """(2→4 plan, 4→2 plan) from the real planner: the bytes-moved numbers
    the live arm prices."""
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.parallel.partition import PartitionRule
    from tpu_on_k8s_torch.parallel.reshard import plan_reshard

    rules_fsdp = [PartitionRule(r"kernel$|embed$", ("fsdp", None))]
    rules_model = [PartitionRule(r"kernel$|embed$", (None, "model"))]
    with planning_world():
        mesh2 = create_mesh(MeshConfig(data=1, fsdp=2, model=1, seq=1),
                            ranks=range(2), device="cpu")
        mesh4 = create_mesh(MeshConfig(data=2, fsdp=1, model=2, seq=1),
                            ranks=range(4), device="cpu")
        state = _abstract_state()
        up = plan_reshard(state, mesh2, rules_fsdp, mesh4, rules_model)
        down = plan_reshard(state, mesh4, rules_model, mesh2, rules_fsdp)
    return up, down


def _step_dt(rng, chips: int) -> float:
    """Seeded per-step time on a ``chips``-chip mesh: the 2-chip baseline
    scaled by chips with the stated efficiency, plus bounded seeded jitter
    (which makes the byte-identical replay a real determinism check)."""
    base = STEP_DT_2 * 2.0 / (chips * (EFFICIENCY if chips > 2 else 1.0))
    return round(base * (1.0 + 0.02 * float(rng.random())), 9)


class _CellClock:
    """Mutable virtual-clock cell the decision ledger reads: the arm sets
    ``t`` to its own virtual time before each ledger append, so records
    carry cost-model time, never wall time."""

    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def run_arm(seed: int, live: bool, *, steps_total: int = 600,
            rescale_up_at: int = 210, rescale_down_at: int = 410,
            ckpt_every: int = 50, ledger=None,
            lclock: "_CellClock" = None) -> Tuple[List[str], Dict]:
    """One arm of the race: the same timeline (2 chips → 4 before step
    ``rescale_up_at`` → back to 2 before ``rescale_down_at``), rescales
    executed live or via checkpoint-restart. The rescale points sit off
    the checkpoint cadence on purpose: the restart arm must replay the
    steps since its last periodic save, which the accountant's high-water
    mark books as replay. Returns (event log, summary)."""
    from tpu_on_k8s_torch.metrics import ReshardMetrics, TrainMetrics
    from tpu_on_k8s_torch.obs.account import TrainingAccountant

    up, down = _plans()
    tmetrics = TrainMetrics(registry=None)
    rmetrics = ReshardMetrics(registry=None)
    acct = TrainingAccountant(metrics=tmetrics)
    events: List[str] = []
    arm = "live" if live else "restart"
    chips = 2
    vclock = 0.0
    pause_total = 0.0
    step = 0
    pending = {rescale_up_at: (4, up), rescale_down_at: (2, down)}
    while step < steps_total:
        target = pending.pop(step, None)
        if target is not None:
            to_chips, plan = target
            rec = None
            if ledger is not None:
                # one provenance record per rescale decision, on the arm's
                # own virtual clock (byte-identical per seed)
                lclock.t = vclock
                rec = ledger.decision(
                    loop=f"reshard/{arm}", tick=step, action="reshard",
                    current=chips, target=to_chips,
                    reason=("live transform" if live
                            else "checkpoint restart"),
                    commit="landed",
                    signals=(("bytes", str(plan.bytes_moved if live
                                           else plan.bytes_total)),),
                    horizon_open=True)
            if live:
                pause = plan.bytes_moved / RESHARD_BW + WARM_COMPILE_S
                acct.pause("reshard", pause)
                rmetrics.inc("reshards")
                rmetrics.inc("bytes_moved", plan.bytes_moved)
                rmetrics.set_gauge("transform_seconds", pause)
                events.append(f"{arm}: step={step} {plan.describe()} "
                              f"pause={pause:.6f}")
            else:
                save_s = plan.bytes_total / SAVE_BW
                # pause(), not waste(): the arms differ in WHICH bucket eats
                # the rescale, never in whether the residual re-books it
                acct.pause("checkpoint", save_s)
                acct.pause("restart", TEARDOWN_S + RESCHEDULE_S + INIT_S)
                acct.pause("recompile", COLD_COMPILE_S)
                pause = (save_s + TEARDOWN_S + RESCHEDULE_S + INIT_S
                         + COLD_COMPILE_S)
                # resume from the last periodic checkpoint: the steps since
                # it re-execute, and the accountant books them as replay
                replay_from = (step // ckpt_every) * ckpt_every
                events.append(f"{arm}: step={step} cold restart -> "
                              f"{to_chips} chips pause={pause:.6f} "
                              f"replay_from={replay_from}")
                step = replay_from
            chips = to_chips
            vclock += pause
            pause_total += pause
            if rec is not None:
                # the rescale's effect horizon closes when the pause ends
                # and stepping resumes at the new size
                lclock.t = vclock
                ledger.horizon(rec.seq, loop=f"reshard/{arm}",
                               event="rollout_complete", closing=True)
        rng = np.random.default_rng((seed, step))
        dt = _step_dt(rng, chips)
        step += 1
        vclock += dt
        acct.window(step, 1, dt)
    acct.run_complete(vclock)
    summary = {
        "arm": arm,
        "steps": steps_total,
        "pause_s": round(pause_total, 6),
        "virtual_seconds": round(vclock, 6),
        "goodput_fraction": acct.summary()["goodput_fraction"],
        "waste_s": acct.summary()["waste_s"],
        "reshards": rmetrics.counters.get("reshards", 0),
        "bytes_moved": rmetrics.counters.get("bytes_moved", 0),
    }
    events.append(f"{arm}: done steps={steps_total} "
                  f"pause={pause_total:.6f} "
                  f"goodput={summary['goodput_fraction']}")
    return events, summary


# ------------------------------------------------------------- bench mode
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _bench_rank(rank: int, world: int, port: int, seed: int, device: str,
                out: str) -> None:
    """One rank of the ``--bench`` world: the state moves 2→4→2 through
    ``TrainLoop`` and ``ReshardNotice``; rank 0 writes the record."""
    import time

    from tpu_on_k8s_torch.metrics import ReshardMetrics
    from tpu_on_k8s_torch.obs.account import TrainingAccountant
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.parallel.partition import (
        PartitionRule,
        shard_pytree,
    )
    from tpu_on_k8s_torch.parallel.reshard import ReshardNotice
    from tpu_on_k8s_torch.train.distributed import backend_for
    from tpu_on_k8s_torch.train.loop import TrainLoop

    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group(backend_for(dev),
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        rules_fsdp = [PartitionRule(r"w$", ("fsdp", None))]
        rules_model = [PartitionRule(r"w$", (None, "model"))]
        mesh2 = create_mesh(MeshConfig(data=1, fsdp=2, model=1, seq=1),
                            ranks=range(2), device=dev.type)
        mesh4 = create_mesh(MeshConfig(data=2, fsdp=1, model=2, seq=1),
                            ranks=range(4), device=dev.type)
        rng = np.random.default_rng(seed)
        state = {"w": torch.from_numpy(rng.normal(size=(256, 256)).astype(
                     np.float32)).to(dev),
                 "m": torch.zeros(256, 256, device=dev)}
        state = shard_pytree(state, mesh2, rules_fsdp)

        def step_fn(s, batch):
            if s["w"].device_mesh.get_coordinate() is None:
                # outside the state's mesh: no block, nothing to compute
                return s, {"loss": torch.full((), float("nan"), device=dev)}
            g = s["w"] * 0.0 + batch
            return ({"w": s["w"] - 0.01 * g, "m": s["m"] * 0.9 + g},
                    {"loss": g.mean().full_tensor()})

        def batches():
            while True:
                yield 1.0

        schedule = [
            ReshardNotice(mesh2, rules_fsdp, mesh4, rules_model, tag="up"),
            ReshardNotice(mesh4, rules_model, mesh2, rules_fsdp, tag="down"),
        ]

        def signal():
            return schedule.pop(0) if schedule else None

        rmetrics = ReshardMetrics(registry=None)
        acct = TrainingAccountant()
        t0 = time.perf_counter()
        result = TrainLoop(step_fn, state, batches(), log_every=2,
                           reshard_signal=signal, reshard_metrics=rmetrics,
                           accountant=acct).run(6)
        wall = time.perf_counter() - t0
        if rank == 0:
            with open(out, "w") as f:
                json.dump({
                    "mode": "bench",
                    "seed": seed,
                    "steps": result.steps,
                    "reshards": result.reshards,
                    "bytes_moved": rmetrics.counters.get("bytes_moved", 0),
                    "transform_seconds_last": rmetrics.gauges.get(
                        "transform_seconds"),
                    "reshard_pause_s": round(acct.waste_s.get("reshard",
                                                              0.0), 6),
                    "goodput_fraction": acct.goodput_fraction(),
                    "wall_seconds": round(wall, 3),
                    "devices": world,
                    "platform": dev.type,
                }, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_bench(seed: int, device: str | torch.device = "cuda") -> Dict:
    """The real thing, measured: a 256 x 256 train state moves in a world of
    ``BENCH_WORLD`` spawned ranks 2→4→2 (fsdp rules → model rules and back)
    through ``TrainLoop`` and ``ReshardNotice``, recording the measured
    pause seconds and bytes. On ``cuda`` each rank takes one card, so the
    world needs 4 cards and raises without them."""
    import torch.multiprocessing as mp

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < BENCH_WORLD:
        raise RuntimeError(
            f"--bench on cuda runs a world of {BENCH_WORLD} ranks, one card "
            f"a rank, and this machine has {torch.cuda.device_count()} "
            f"card(s); run it with 4 cards, or with --device cpu over gloo")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "bench.json")
        mp.spawn(_bench_rank, args=(BENCH_WORLD, _free_port(), seed,
                                    dev.type, out),
                 nprocs=BENCH_WORLD, join=True)
        with open(out) as f:
            return json.load(f)


# --------------------------------------------------------------------- main
def run_all(seed: int, ledger_out: str = "") -> Dict:
    ledger = None
    lclock = None
    if ledger_out:
        from tpu_on_k8s_torch.obs.ledger import DecisionLedger

        lclock = _CellClock()
        ledger = DecisionLedger(lclock)
    live_events, live = run_arm(seed, live=True, ledger=ledger,
                                lclock=lclock)
    restart_events, restart = run_arm(seed, live=False, ledger=ledger,
                                      lclock=lclock)
    events = live_events + restart_events
    assert live["pause_s"] < restart["pause_s"], (
        f"live reshard must beat checkpoint-restart on pause seconds: "
        f"{live['pause_s']} vs {restart['pause_s']}")
    assert live["goodput_fraction"] > restart["goodput_fraction"], (
        f"live reshard must beat checkpoint-restart on goodput_fraction: "
        f"{live['goodput_fraction']} vs {restart['goodput_fraction']}")
    assert live["reshards"] == 2, "both rescales must run live"
    assert "reshard" in live["waste_s"] and \
        "reshard" not in restart["waste_s"], (
        "the pause must be attributed to the reshard bucket on the live "
        "arm only")
    out = {
        "seed": seed,
        "live": live,
        "restart": restart,
        "pause_win_s": round(restart["pause_s"] - live["pause_s"], 6),
        "goodput_win": round(live["goodput_fraction"]
                             - restart["goodput_fraction"], 6),
        "events": events,
        "events_crc": f"{zlib.crc32(chr(10).join(events).encode()):08x}",
    }
    if ledger is not None:
        from tpu_on_k8s_torch import chaos

        inj = chaos.active()
        ledger.dump(ledger_out,
                    extra=({"chaos_events": list(inj.events)}
                           if inj is not None and inj.events else None))
        out["ledger_out"] = ledger_out
        out["ledger_records"] = len(ledger.records)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="live-reshard vs checkpoint-restart soak")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--repeat", type=int, default=2,
                   help="run the race this many times and assert "
                        "identical event logs (default 2)")
    p.add_argument("--bench", action="store_true",
                   help="measure a real 2->4->2 reshard on a world of 4 "
                        "ranks instead of the cost model")
    p.add_argument("--ledger-out", default="",
                   help="write both arms' rescale decisions as a "
                        "decision ledger (obs/ledger.py dump, cost-model "
                        "clock) here")
    p.add_argument("--device", default="cuda",
                   help="the --bench world's device: 'cuda' (default; one "
                        "card a rank) or 'cpu' (gloo)")
    args = p.parse_args(argv)
    try:
        if args.bench:
            print(json.dumps(run_bench(args.seed, args.device), indent=2))
            return 0
        runs = [run_all(args.seed, ledger_out=args.ledger_out)
                for _ in range(max(args.repeat, 1))]
        for later in runs[1:]:
            assert later["events"] == runs[0]["events"], (
                "event logs diverged across repeats:\n"
                f"run 1: {runs[0]['events']}\nrun n: {later['events']}")
        out = dict(runs[0])
        out["repeats"] = len(runs)
        out["identical_logs"] = len(runs) > 1
        print(json.dumps(out, indent=2))
        return 0
    except Exception as e:  # noqa: BLE001 — the seed line is the contract
        print(f"RESHARD_SOAK_FAILED seed={args.seed}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        raise


if __name__ == "__main__":
    sys.exit(main())
