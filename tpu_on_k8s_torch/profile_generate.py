"""Where ``generate``'s time goes on the card: a ``torch.profiler`` trace.

    python -m tpu_on_k8s_torch.profile_generate --config llama2_7b \\
        --batch 4 --prompt-len 512 --max-new-tokens 16

Random weights from ``--seed``. After one warm-up request it traces a
one-token request (the prefill) and a ``--max-new-tokens`` request, and
prints for each: the wall time, the device time summed over kernels, the
device's busy share (kernel time over wall time) and the kernels with the
most device time. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import collections
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.generate import CONFIGS
from tpu_on_k8s_torch.models.decode import generate
from tpu_on_k8s_torch.models.params import init_params


def _report(label: str, fn, top: int) -> None:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = by_name[evt.name]
            entry[0] += 1
            entry[1] += evt.time_range.elapsed_us()
    busy_us = sum(us for _, us in by_name.values())
    if busy_us == 0:
        raise RuntimeError("the profiler saw no device time")
    launches = sum(n for n, _ in by_name.values())
    print(f"[{label}] wall {wall_us / 1e3:.2f} ms, kernels "
          f"{busy_us / 1e3:.2f} ms in {launches} launches, device busy "
          f"{busy_us / wall_us:.1%}")
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:top]:
        print(f"[{label}]   {us / 1e3:9.3f} ms {us / busy_us:6.1%} "
              f"x{n:<5d} {name[:110]}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="profile generate on the card")
    p.add_argument("--config", default="llama2_7b", choices=sorted(CONFIGS))
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=512)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top", type=int, default=12)
    args = p.parse_args(argv)

    dev = resolve_device("cuda")
    cfg = CONFIGS[args.config]()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    print(f"[setup] {args.config} batch {args.batch} prompt "
          f"{args.prompt_len} new {args.max_new_tokens} on "
          f"{torch.cuda.get_device_name(0)}")
    generate(cfg, params, prompt, args.max_new_tokens, device=dev)  # warm-up
    _report("prefill", lambda: generate(cfg, params, prompt, 1, device=dev),
            args.top)
    _report(f"generate {args.max_new_tokens}",
            lambda: generate(cfg, params, prompt, args.max_new_tokens,
                             device=dev), args.top)


if __name__ == "__main__":
    main()
