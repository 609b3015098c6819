"""Where the continuous-batching engine's time goes on the card: a
``torch.profiler`` trace of its decode step and of its admission prefills.

    python -m tpu_on_k8s_torch.profile_serve --config llama2_7b --n-slots 8 \\
        --max-len 2048

Random weights from ``--seed``; ``--cache-int8`` keeps the int8 KV cache.
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

import numpy as np
import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.generate import CONFIGS
from tpu_on_k8s_torch.models.params import init_params
from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
from tpu_on_k8s_torch.profile_generate import report


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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = dataclasses.replace(CONFIGS[args.config](),
                              cache_int8=args.cache_int8)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    eng = ContinuousBatchingEngine(cfg, params, n_slots=args.n_slots,
                                   max_len=args.max_len,
                                   kv_pages=args.kv_pages, device=dev)
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
          f"prompts {args.prompt_len}, on {torch.cuda.get_device_name(0)}")
    report(f"decode step, occupancy {args.n_slots}", eng.step, args.top)
    # a one-token request retires at its admission, freeing the slot again
    eng.abort(ids[-1])
    for n in (int(b) for b in args.buckets.split(",")):
        eng.submit(prompt(n), 1)
        report(f"admission prefill, bucket {n} x 1, then a decode step at "
               f"occupancy {args.n_slots - 1}", eng.step, args.top)


if __name__ == "__main__":
    main()
