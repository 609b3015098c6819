"""Long-context evidence: the long-context machinery at long context, with
memory numbers showing the score matrix never materializes (the
counterpart of the reference's ``tools/longcontext_proof.py``).

Two halves; the flag picks one (the port never picks by what it finds):

* **CPU** (``--cpu``): a world of 8 gloo ranks that the module spawns:
  1. a ring-attention training step at seq **32768** on an 8-way ``seq``
     mesh (tiny model, a real ``Trainer`` step): loss finite, and the
     step's peak of CPU tensor memory per rank (``torch.profiler`` with
     ``profile_memory``: the running sum of the step's allocations and
     frees, its peak above the step's start) against the ``[H, L, L]``
     fp32 score matrix a naive attention would allocate;
  2. the same for an Ulysses step at seq **16384** (8 heads over the 8
     ranks);
  3. parity: the ring loss at seq 4096 against the same parameters
     through the plain attention on one rank (the logsumexp merge's
     exactness at scale, ``abs_diff < 5e-3``).
  The reference asserts ``temp < naive / 10`` on each step's memory; here
  the gates are checked after all three records are written, so a failed
  gate leaves the records to read. On the CPU the flash wrappers run their
  plain twins, which hold a rank's whole ``[h, Lq, Lk]`` scores.
* **Card** (the default): one card, the reference's ``TransformerConfig``
  (vocab 32768, d 1024, 4 layers, 16 heads over 8 kv heads, d_ff 4096,
  remat ``mlp``, flash attention), batch 2, at seq 4096 and at a ragged
  4000: the kernels mask the ragged tail themselves (no padding). A
  ``Trainer`` with Adam's first moment in bf16, 2 warm-up steps, 10 timed
  steps; memory from the CUDA allocator: one step's peak above the bytes
  held before it (``temp_bytes``) beside the naive ``B·H·L²·4``. The
  ragged/aligned per-token ratio is recorded (``ragged_cliff_check``), not
  gated.

Results merge into ``LONGCONTEXT_torch.json`` at the repository's root (git
ignores it); ``out=`` points the functions elsewhere. The default device is
``cuda``, which raises without a card.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist

from tpu_on_k8s_torch.device import resolve_device

OUT = Path(__file__).resolve().parents[1] / "LONGCONTEXT_torch.json"

#: the CPU half's world
CPU_WORLD = 8
#: what the CPU half's memory figure measures
CPU_MEMORY_MEASURE = ("torch.profiler profile_memory: peak of the running "
                      "sum of CPU tensor allocations and frees over one "
                      "step, above the step's start, per rank")
CARD_MEMORY_MEASURE = ("torch.cuda.max_memory_allocated over one step less "
                       "torch.cuda.memory_allocated before it")


def _merge(update: dict, out: Path = OUT) -> None:
    out = Path(out)
    data = {}
    if out.exists():
        with open(out) as f:
            data = json.load(f)
    data.update(update)
    with open(out, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")
    print(json.dumps(update), flush=True)


def _tiny_cfg(seq: int, attn: str):
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        vocab_size=256, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
        d_ff=64, max_seq_len=seq, remat=False, attn_impl=attn)


def _tokens(seed: int, seq: int, vocab: int,
            device: torch.device) -> torch.Tensor:
    return torch.randint(0, vocab, (1, seq + 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed)
                         ).to(device)


def _profiled_peak(fn) -> int:
    """The peak of ``fn()``'s CPU tensor memory above its start, from
    ``torch.profiler``'s memory accounting, as bytes. An op's own
    allocations count from its start; its negative own figure (what its
    callees allocated and it freed before returning) counts at its end,
    so the figure bounds the true peak from above."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        fn()
    deltas = sorted((e.time_range.start if e.self_cpu_memory_usage > 0
                     else e.time_range.end, e.self_cpu_memory_usage)
                    for e in prof.events() if e.self_cpu_memory_usage)
    running = peak = 0
    for _, nbytes in deltas:
        running += nbytes
        peak = max(peak, running)
    return int(peak)


def _cpu_step(cfg, mesh, tokens) -> tuple:
    """One real sharded training step on ``mesh``: (loss, the step's peak
    CPU tensor bytes on this rank, wall seconds)."""
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
    from tpu_on_k8s_torch.train import Trainer, default_optimizer

    model = load_model(cfg, init_params(
        cfg, torch.Generator().manual_seed(0), "cpu",
        dtype=cfg.param_dtype), "cpu")
    trainer = Trainer(model, default_optimizer(
        model.parameters(), warmup_steps=1, decay_steps=10),
        rules=flagship_partition_rules(), mesh=mesh)
    rows = trainer.shard_batch(tokens)
    out = {}
    t0 = time.perf_counter()
    temp = _profiled_peak(lambda: out.update(trainer.train_step(rows)))
    return float(out["loss"]), temp, time.perf_counter() - t0


def _cpu_rank(rank: int, world: int, store: str, out: str, sizes: dict,
              parity_params, parity_tokens) -> None:
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.models.transformer import (
        TransformerConfig,
        flagship_partition_rules,
    )
    from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh
    from tpu_on_k8s_torch.train import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    records: Dict[str, dict] = {}
    try:
        mesh = create_mesh(MeshConfig(data=1, fsdp=1, model=1, seq=world),
                           device="cpu")
        # --- the ring step --------------------------------------------------
        seq = sizes["ring_seq"]
        cfg = _tiny_cfg(seq, "ring")
        loss, temp, wall = _cpu_step(cfg, mesh,
                                     _tokens(1, seq, cfg.vocab_size,
                                             torch.device("cpu")))
        naive = cfg.n_heads * seq * seq * 4  # fp32 [H, L, L] per rank
        records["ring_32k_dryrun"] = {
            "seq": seq, "devices": world, "mesh": f"seq={world}",
            "loss": loss, "loss_finite": math.isfinite(loss),
            "wall_s_cpu": round(wall, 1),
            "per_device_temp_bytes": temp,
            "memory_measure": CPU_MEMORY_MEASURE,
            "naive_score_matrix_bytes": naive,
            "temp_vs_naive": round(temp / naive, 4) if temp else None,
        }
        # --- the Ulysses step: the all-to-all flavour of seq parallelism ----
        seq = sizes["ulysses_seq"]
        ucfg = TransformerConfig(
            vocab_size=256, d_model=64, n_layers=1, n_heads=8, n_kv_heads=8,
            d_ff=64, max_seq_len=seq, remat=False, attn_impl="ulysses")
        loss, temp, wall = _cpu_step(ucfg, mesh,
                                     _tokens(3, seq, ucfg.vocab_size,
                                             torch.device("cpu")))
        naive = ucfg.n_heads * seq * seq * 4
        records["ulysses_16k_dryrun"] = {
            "seq": seq, "devices": world,
            "mesh": f"seq={world} (heads after all-to-all)",
            "loss": loss, "loss_finite": math.isfinite(loss),
            "wall_s_cpu": round(wall, 1),
            "per_device_temp_bytes": temp,
            "memory_measure": CPU_MEMORY_MEASURE,
            "naive_score_matrix_bytes": naive,
            "temp_vs_naive": round(temp / naive, 4) if temp else None,
        }
        # --- parity: the ring against the plain attention, same params ------
        seq = sizes["parity_seq"]
        cfg_r, cfg_x = _tiny_cfg(seq, "ring"), _tiny_cfg(seq, "xla")
        tokens = (parity_tokens if parity_tokens is not None
                  else _tokens(2, seq, cfg_r.vocab_size, torch.device("cpu")))
        params = (parity_params if parity_params is not None
                  else init_params(cfg_x, torch.Generator().manual_seed(3),
                                   "cpu"))

        def loss_of(cfg, in_mesh) -> float:
            model = load_model(cfg, {k: v.clone() for k, v in params.items()},
                               "cpu")
            trainer = (Trainer(model) if in_mesh is None else Trainer(
                model, rules=flagship_partition_rules(), mesh=in_mesh))
            with torch.no_grad():
                return float(trainer.eval_step(
                    trainer.shard_batch(tokens))["loss"])

        ring_loss = loss_of(cfg_r, mesh)
        xla_loss = loss_of(cfg_x, None)
        records["ring_parity_4096"] = {
            "seq": seq, "ring_loss": ring_loss, "xla_loss": xla_loss,
            "abs_diff": abs(ring_loss - xla_loss)}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(records, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def cpu_records(*, ring_seq: int = 32768, ulysses_seq: int = 16384,
                parity_seq: int = 4096,
                parity_params: Optional[Dict[str, torch.Tensor]] = None,
                parity_tokens: Optional[torch.Tensor] = None) -> dict:
    """The CPU half's three records, from a spawned world of ``CPU_WORLD``
    gloo ranks (rank 0's). ``parity_params`` and ``parity_tokens`` replace
    the parity's own (torch seeds 3 and 2)."""
    import torch.multiprocessing as mp

    sizes = dict(ring_seq=ring_seq, ulysses_seq=ulysses_seq,
                 parity_seq=parity_seq)
    with tempfile.TemporaryDirectory() as d:
        result = os.path.join(d, "records.json")
        mp.spawn(_cpu_rank, args=(CPU_WORLD, os.path.join(d, "store"),
                                  result, sizes, parity_params,
                                  parity_tokens),
                 nprocs=CPU_WORLD, join=True)
        with open(result) as f:
            return json.load(f)


def cpu_gates(records: dict) -> list:
    """The reference's gates on the CPU records: each step's loss finite
    and its memory below a tenth of the naive score matrix, the parity
    within 5e-3. Returns the failed ones."""
    failed = []
    for key in ("ring_32k_dryrun", "ulysses_16k_dryrun"):
        rec = records[key]
        if not rec["loss_finite"]:
            failed.append(f"{key} loss not finite: {rec['loss']}")
        temp = rec["per_device_temp_bytes"]
        naive = rec["naive_score_matrix_bytes"]
        if temp and not temp < naive / 10:
            failed.append(f"{key} temp {temp} suspiciously close to naive "
                          f"{naive}")
    parity = records["ring_parity_4096"]
    if not parity["abs_diff"] < 5e-3:
        failed.append(f"ring/xla diverge: {parity}")
    return failed


def cpu_part(out: Path = OUT, **sizes) -> dict:
    """The CPU half (``cpu_records``' keywords): the records merge into
    ``out`` first, then ``AssertionError`` names every gate that failed."""
    records = cpu_records(**sizes)
    for key, rec in records.items():
        _merge({key: rec}, out)
    failed = cpu_gates(records)
    assert not failed, "; ".join(failed)
    return records


def _card_config(seq: int):
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    return TransformerConfig(
        vocab_size=32768, d_model=1024, n_layers=4, n_heads=16,
        n_kv_heads=8, d_ff=4096, max_seq_len=seq, remat=True,
        remat_policy="mlp", scan_unroll=4, attn_impl="flash")


def card_part(out: Path = OUT, device: str | torch.device = "cuda"
              ) -> dict:
    """The card half at seq 4096 and 4000; returns ``{label: record}``
    (``ragged_cliff_check`` included)."""
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.train import Trainer, default_optimizer

    dev = resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    results = {}
    for seq, label in ((4096, "flash_4096"), (4000, "flash_4000_padded")):
        cfg = _card_config(seq)
        batch = 2
        gen = torch.Generator(device=dev).manual_seed(0)
        model = load_model(cfg, init_params(cfg, gen, dev,
                                            dtype=cfg.param_dtype), dev)
        trainer = Trainer(model, default_optimizer(
            model.parameters(), warmup_steps=1, decay_steps=10,
            mu_dtype=torch.bfloat16))
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                               generator=torch.Generator(device=dev)
                               .manual_seed(1), device=dev,
                               dtype=torch.int32)
        temp = None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        loss = float(trainer.train_step(tokens)["loss"])
        compile_wall = time.perf_counter() - t0
        if dev.type == "cuda":
            temp = torch.cuda.max_memory_allocated(dev) - held
        for _ in range(2):
            metrics = trainer.train_step(tokens)
        float(metrics["loss"])
        steps = 10
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = trainer.train_step(tokens)
        float(metrics["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = (time.perf_counter() - t0) / steps
        naive_scores = batch * cfg.n_heads * seq * seq * 4
        record = {
            "seq": seq, "batch": batch, "layers": cfg.n_layers,
            "device_kind": kind, "loss": loss,
            "loss_finite": math.isfinite(loss),
            "step_ms": round(dt * 1e3, 1),
            "tokens_per_sec": round(batch * seq / dt, 1),
            "compile_s": round(compile_wall, 1),
            "temp_bytes": temp,
            "memory_measure": CARD_MEMORY_MEASURE,
            "naive_score_matrix_bytes": naive_scores,
            "attn_path": ("flash (the port's kernels)" if seq % 128 == 0
                          else "flash (the port's kernels mask the ragged "
                               "tail themselves; no padding)"),
        }
        assert record["loss_finite"], f"{label} loss not finite"
        _merge({label: record}, out)
        results[label] = record
        del trainer, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # the ragged length against the aligned one, per token, and their
    # temporaries: recorded as the reference records them, not gated
    a, b = results["flash_4096"], results["flash_4000_padded"]
    ratio = (b["step_ms"] / b["seq"]) / (a["step_ms"] / a["seq"])
    cliff = {"per_token_ratio_4000_vs_4096": round(ratio, 3)}
    if isinstance(a.get("temp_bytes"), int) and isinstance(
            b.get("temp_bytes"), int) and a["temp_bytes"]:
        cliff["temp_ratio_4000_vs_4096"] = round(
            b["temp_bytes"] / a["temp_bytes"], 3)
    cliff["within_15pct"] = bool(ratio <= 1.15)
    _merge({"ragged_cliff_check": cliff}, out)
    results["ragged_cliff_check"] = cliff
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="long-context evidence")
    p.add_argument("--cpu", action="store_true",
                   help="the CPU half (a world of 8 gloo ranks) instead of "
                        "the card half")
    args = p.parse_args(argv)
    if args.cpu:
        cpu_part()
    else:
        card_part()


if __name__ == "__main__":
    sys.exit(main())
