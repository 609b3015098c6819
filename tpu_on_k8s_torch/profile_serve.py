"""Where the continuous-batching engine's time goes on the card: a
``torch.profiler`` trace of its decode step and of its admission prefills.

    python -m tpu_on_k8s_torch.profile_serve --config llama2_7b --n-slots 8 \\
        --max-len 2048

Random weights from ``--seed``; ``--cache-int8`` keeps the int8 KV cache;
``--mesh`` serves on ``serving_mesh(model=1)`` of a world of one rank (the
mesh engine's command header and collectives, on one card) and then times
its step model against the same weights laid out with ``DTensor``s
(``time_tp_layouts``);
``--host-top K`` adds the K operators with the most host time.
The engine's slots are filled with requests
of ``--prompt-len`` tokens and warmed up; then one decode step at full
occupancy is traced, and one admission prefill at each of ``--buckets``
(one request, batch 1, into a slot just freed). Each trace prints the wall
time, the device time summed over kernels, the device's busy share and the
kernels with the most device time (``profile_generate.report``). Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.generate import CONFIGS
from tpu_on_k8s_torch.models.decode import decode_model
from tpu_on_k8s_torch.models.params import init_params
from tpu_on_k8s_torch.models.serving import (
    ContinuousBatchingEngine,
    multislot_twin,
)
from tpu_on_k8s_torch.parallel.mesh import AXIS_MODEL, serving_mesh
from tpu_on_k8s_torch.parallel.serving import shutdown_mesh_workers
from tpu_on_k8s_torch.parallel.sharded import tensor_parallel
from tpu_on_k8s_torch.profile_generate import report
from tpu_on_k8s_torch.train.distributed import local_world


def time_tp_layouts(eng: ContinuousBatchingEngine, params, mesh,
                    n: int = 20) -> Dict[str, List[float]]:
    """One decode step of a dense mesh engine's step model (plain local
    tensors and explicit collectives: ``sharded.shard_serving_model``)
    against the same weights laid out as the training layout does
    (``DTensor`` parameters: ``sharded.tensor_parallel``), each over the
    engine's slot pool at its slots' positions, ``n`` times each in turn.
    Prints and returns the ms of each on the host clock, a step ending in
    a synchronize."""
    if eng._cache is None:
        raise ValueError("the layouts are timed on a dense slot pool")
    base = (dataclasses.replace(eng.cfg, max_seq_len=eng.max_len)
            if eng.cfg.pos_emb == "rope" else eng.cfg)
    dtensor = decode_model(base, params, eng.device)
    tensor_parallel(dtensor, mesh[AXIS_MODEL])
    models = {"plain": eng._step_model, "dtensor": multislot_twin(dtensor)}
    cache = eng._cache.layers()
    tok = torch.zeros(eng.n_slots, 1, dtype=torch.int32, device=eng.device)
    pos = torch.tensor([[s.pos if s is not None else eng.max_len]
                        for s in eng._slots], dtype=torch.int32,
                       device=eng.device)
    ms: Dict[str, List[float]] = {name: [] for name in models}
    with torch.inference_mode():
        logits = {name: m(tok, pos, cache) for name, m in models.items()}
        for _ in range(n):
            for name, m in models.items():
                _sync(eng.device)
                t0 = time.perf_counter()
                m(tok, pos, cache)
                _sync(eng.device)
                ms[name].append((time.perf_counter() - t0) * 1e3)
    same = torch.equal(logits["plain"], logits["dtensor"])
    print(f"[tp layouts] decode step of the step model, {n} each: plain "
          f"median {statistics.median(ms['plain']):.2f} ms (min "
          f"{min(ms['plain']):.2f}), DTensor median "
          f"{statistics.median(ms['dtensor']):.2f} ms (min "
          f"{min(ms['dtensor']):.2f}); logits equal: {same}")
    return ms


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="profile the serving engine")
    p.add_argument("--config", default="llama2_7b", choices=sorted(CONFIGS))
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=2048)
    p.add_argument("--prompt-len", type=int, default=512)
    p.add_argument("--buckets", default="128,1024",
                   help="prompt lengths of the traced admission prefills")
    p.add_argument("--kv-pages", type=int, default=0)
    p.add_argument("--cache-int8", action="store_true",
                   help="the int8 KV cache (cache_int8)")
    p.add_argument("--mesh", action="store_true",
                   help="serve on serving_mesh(model=1) of a one-rank world")
    p.add_argument("--host-top", type=int, default=0,
                   help="operators with the most host time in each trace")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(CONFIGS[args.config](),
                              cache_int8=args.cache_int8)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    mesh = None
    if args.mesh:
        local_world(dev)
        mesh = serving_mesh(model=1, device=dev)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=args.n_slots,
                                   max_len=args.max_len,
                                   kv_pages=args.kv_pages, device=dev,
                                   mesh=mesh)
    rng = np.random.default_rng(args.seed)

    def prompt(n: int) -> np.ndarray:
        return rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)

    budget = args.max_len - args.prompt_len
    ids = [eng.submit(prompt(args.prompt_len), budget)
           for _ in range(args.n_slots)]
    for _ in range(4):                      # admission, then warm-up steps
        eng.step()
    print(f"[setup] {args.config} engine, {args.n_slots} slots of "
          f"{args.max_len} positions{', paged' if args.kv_pages else ''}"
          f"{', int8 KV cache' if args.cache_int8 else ''}, "
          f"prompts {args.prompt_len}{', on a one-rank mesh' if mesh else ''}"
          f", on {torch.cuda.get_device_name(0)}")
    report(f"decode step, occupancy {args.n_slots}", eng.step, args.top,
           host_top=args.host_top)
    # a one-token request retires at its admission, freeing the slot again
    eng.abort(ids[-1])
    for n in (int(b) for b in args.buckets.split(",")):
        eng.submit(prompt(n), 1)
        report(f"admission prefill, bucket {n} x 1, then a decode step at "
               f"occupancy {args.n_slots - 1}", eng.step, args.top)
    if mesh is not None:
        time_tp_layouts(eng, params, mesh)
        eng.close()
        shutdown_mesh_workers()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
