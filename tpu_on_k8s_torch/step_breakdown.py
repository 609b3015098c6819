"""Where does the step time go? forward / forward+backward / optimizer at
the flagship config (the counterpart of the reference's
``tools/step_breakdown.py``).

    python -m tpu_on_k8s_torch.step_breakdown [int8=1] [nu=bf16] [batch=12]
        [--device D]

The keys are the reference's (``perf_sweep``'s names; this tool reads
``int8``, ``nu`` and ``batch``). ``serve_load.bench_config()`` with
``mlp_int8`` from ``int8``, on one card without a mesh; random fp32 master
weights from torch seed 0, one fixed batch of tokens from torch seed 1, Adam
with a bf16 first moment (and a bf16 second moment under ``nu=bf16``). Four
parts are timed, each a warm call and then ``steps`` calls ending in one
synchronize: the forward and loss (no graph kept), the forward and backward
(``torch.autograd.grad``), the optimizer's update alone on those gradients,
and the full ``Trainer`` step. Then the ideal forward and backward times at
the card's dense bf16 peak (``perf_sweep.PEAK_FLOPS``; ``nan`` on the CPU)
and the breakdown line. The default device is ``cuda``, which raises
without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.perf_sweep import bench_config, device_peak, n_params


def timeit(name, fn, dev, steps=20):
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / steps
    print(f"{name:28s} {dt * 1e3:8.1f} ms", flush=True)
    return dt


def breakdown(opts: dict, device: str | torch.device = "cuda",
              steps: int = 20) -> dict:
    """The four parts at ``opts`` (``{key: value}`` strings); prints the
    reference's lines and returns ``{fwd, fwd_bwd, opt, step, sum_parts}``
    in ms."""
    from tpu_on_k8s_torch.models.params import init_params, load_model
    from tpu_on_k8s_torch.train import Trainer, default_optimizer
    from tpu_on_k8s_torch.train import trainer as trainer_mod

    dev = resolve_device(device)
    cfg = dataclasses.replace(bench_config(),
                              mlp_int8=opts.get("int8", "0") == "1")
    nu = torch.bfloat16 if opts.get("nu", "fp32") == "bf16" else None
    batch = int(opts.get("batch", "12"))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = load_model(cfg, init_params(cfg, gen, dev,
                                        dtype=cfg.param_dtype), dev)
    opt = default_optimizer(model.parameters(), warmup_steps=10,
                            decay_steps=1000, mu_dtype=torch.bfloat16,
                            nu_dtype=nu)
    trainer = Trainer(model, opt)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq_len + 1),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev, dtype=torch.int32)
    loss_fn = trainer_mod._make_loss_fn(model, 0, None)
    params = list(model.parameters())

    def fwd():
        with torch.no_grad():
            return loss_fn(tokens)[0]

    def vgrad():
        loss, _ = loss_fn(tokens)
        return loss, torch.autograd.grad(loss, params)

    t_fwd = timeit("fwd (loss only)", fwd, dev, steps)
    t_vg = timeit("fwd+bwd (value_and_grad)", vgrad, dev, steps)
    _, grads = vgrad()
    for p, g in zip(params, grads):
        p.grad = g
    t_opt = timeit("optimizer update", opt.step, dev, steps)
    for p in params:
        p.grad = None
    del grads
    t_step = timeit("full train_step", lambda: trainer.train_step(tokens),
                    dev, steps)
    peak = device_peak(dev)
    toks = batch * cfg.max_seq_len
    print(f"\nfwd ideal {2 * n_params(cfg) * toks / peak * 1e3:.1f} ms, "
          f"bwd ideal {4 * n_params(cfg) * toks / peak * 1e3:.1f} ms")
    print(f"breakdown: fwd {t_fwd*1e3:.1f} | bwd {(t_vg - t_fwd)*1e3:.1f} | "
          f"opt {t_opt*1e3:.1f} | step {t_step*1e3:.1f} "
          f"(sum parts {(t_vg + t_opt)*1e3:.1f})")
    return dict(fwd=t_fwd * 1e3, fwd_bwd=t_vg * 1e3, opt=t_opt * 1e3,
                step=t_step * 1e3, sum_parts=(t_vg + t_opt) * 1e3)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="fwd / bwd / optimizer split of "
                                            "the flagship's step")
    p.add_argument("opts", nargs="*", help="key=value (int8, nu, batch)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    return breakdown(dict(kv.split("=", 1) for kv in args.opts), args.device)


if __name__ == "__main__":
    main()
