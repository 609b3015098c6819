"""Autoregressive generation on the card (the port's serving entry point).

Counterpart of ``examples/generate.py``: random weights from ``--seed`` (no
checkpoint restore yet), a random prompt, and ``models.decode.generate``::

    python -m tpu_on_k8s_torch.generate --config llama2_7b --batch 4 \\
        --prompt-len 512 --max-new-tokens 64
"""
from __future__ import annotations

import argparse

import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.models.decode import generate
from tpu_on_k8s_torch.models.params import init_params
from tpu_on_k8s_torch.models.transformer import TransformerConfig

CONFIGS = {
    "llama2_7b": TransformerConfig.llama2_7b,
    "llama2_1b": TransformerConfig.llama2_1b,
    "tiny": TransformerConfig.tiny,
}


def main(argv=None) -> torch.Tensor:
    p = argparse.ArgumentParser(description="generate with random weights")
    p.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--prompt-len", type=int, default=8)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0,
                   help="sample only the k highest-probability tokens")
    p.add_argument("--top-p", type=float, default=0.0,
                   help="nucleus sampling: smallest token set with mass p")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CONFIGS[args.config]()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    out = generate(cfg, params, prompt, args.max_new_tokens,
                   temperature=args.temperature, top_k=args.top_k,
                   top_p=args.top_p, device=dev,
                   generator=torch.Generator(device=dev).manual_seed(
                       args.seed + 1))
    for row in range(args.batch):
        print(f"prompt[{row}]:", prompt[row].tolist())
        print(f"continuation[{row}]:", out[row].tolist())
    return out


if __name__ == "__main__":
    main()
