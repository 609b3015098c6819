"""Where the port runs: the CUDA card by default, the CPU only when asked."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    ``"cuda"`` (the default) raises when PyTorch sees no CUDA card: the port
    never drops to the CPU on its own. Only an explicit ``"cpu"`` runs there,
    which is how the CPU tests drive it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {str(dev)!r} (use 'cuda' or 'cpu')")
