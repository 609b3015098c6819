"""Autoregressive generation on the card (the port's serving entry point).

Counterpart of ``examples/generate.py``: the parameters of a checkpoint
(``--checkpoint-dir``, a directory ``train_llama --checkpoint-dir`` wrote;
``train/checkpoint.py``), of a local Hugging Face checkpoint directory of
the Llama or GPT-2 family (``--hf-model``, served with bf16 weights through
``models/convert.py``; it overrides ``--config`` and ``--checkpoint-dir``
and needs ``transformers``, imported only for it) or random weights from
``--seed``, a random prompt, and ``models.decode.generate``;
``--draft-config`` decodes greedily
through ``speculative_generate`` with a draft of that config (same
vocabulary, ``--spec-k`` proposals a round), restored from
``--draft-checkpoint-dir`` or random, and prints its stats::

    python -m tpu_on_k8s_torch.generate --config llama2_7b --batch 4 \\
        --prompt-len 512 --max-new-tokens 64
    python -m tpu_on_k8s_torch.generate --config tiny --device cpu \\
        --draft-config tiny
    python -m tpu_on_k8s_torch.generate --hf-model ./gpt2 --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.models.convert import from_hf_gpt2, from_hf_llama
from tpu_on_k8s_torch.models.decode import generate, speculative_generate
from tpu_on_k8s_torch.models.params import init_params
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.train.checkpoint import load_params

CONFIGS = {
    "llama2_7b": TransformerConfig.llama2_7b,
    "llama2_1b": TransformerConfig.llama2_1b,
    "gpt2_small": TransformerConfig.gpt2_small,
    "tiny": TransformerConfig.tiny,
}


def load_hf(path: str, device: torch.device
            ) -> Tuple[TransformerConfig, Dict[str, torch.Tensor]]:
    """(config, bf16 parameters on ``device``) of the local Hugging Face
    checkpoint directory ``path``, a Llama or GPT-2 family causal LM.
    ``transformers`` is imported here, for this path only."""
    try:
        import transformers
    except ImportError as e:
        raise ImportError("--hf-model needs the transformers package, which "
                          "is not installed") from e
    hf = transformers.AutoModelForCausalLM.from_pretrained(path)
    conv = {"llama": from_hf_llama, "gpt2": from_hf_gpt2}.get(
        hf.config.model_type)
    if conv is None:
        raise SystemExit(f"unsupported HF model_type "
                         f"{hf.config.model_type!r} (llama | gpt2)")
    cfg, params = conv(hf, dtype=torch.bfloat16, device=device)
    print(f"loaded HF {hf.config.model_type} from {path} "
          f"({sum(p.numel() for p in params.values()):,} params)")
    return cfg, params


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
    p.add_argument("--draft-config", default="",
                   choices=["", *sorted(CONFIGS)],
                   help="greedy speculative decoding with a random draft of "
                        "this config (same vocabulary): a mechanism demo, "
                        "acceptance of a random draft is ~0")
    p.add_argument("--checkpoint-dir", default="",
                   help="restore the model's parameters from here (the "
                        "newest generation and step)")
    p.add_argument("--hf-model", default="",
                   help="local HF checkpoint dir (Llama or GPT-2 family), "
                        "served with bf16 weights; overrides --config and "
                        "--checkpoint-dir")
    p.add_argument("--draft-checkpoint-dir", default="",
                   help="restore the draft's parameters from here; without "
                        "it the draft is random")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft proposals per speculative round")
    args = p.parse_args(argv)
    if args.draft_checkpoint_dir and not args.draft_config:
        raise SystemExit("--draft-checkpoint-dir needs --draft-config")
    if args.draft_config and args.temperature:
        raise SystemExit("speculative decoding is greedy-only")

    dev = resolve_device(args.device)
    cfg = CONFIGS[args.config]()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.hf_model:
        cfg, params = load_hf(args.hf_model, dev)
    elif args.checkpoint_dir:
        params, ck_gen, ck_step = load_params(args.checkpoint_dir, dev,
                                              cfg.dtype)
        print(f"restored generation={ck_gen} step={ck_step}")
    else:
        params = init_params(cfg, gen, dev)
    # the prompt: the seed's first draw with a checkpoint or an HF model,
    # its draw after the random weights without one
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev, dtype=torch.int32)
    if args.draft_config:
        draft_cfg = CONFIGS[args.draft_config]()
        if args.draft_checkpoint_dir:
            draft_params, d_gen, d_step = load_params(
                args.draft_checkpoint_dir, dev, draft_cfg.dtype)
            print(f"restored draft generation={d_gen} step={d_step}")
        else:
            draft_params = init_params(draft_cfg, torch.Generator(
                device=dev).manual_seed(args.seed + 2), dev)
        out, stats = speculative_generate(cfg, params, draft_cfg,
                                          draft_params, prompt,
                                          args.max_new_tokens, k=args.spec_k,
                                          device=dev)
        print("speculative stats:", stats)
    else:
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
