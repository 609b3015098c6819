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


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise ``TypeError`` if any of ``tensors`` is a ``DTensor``: a
    kernel's wrapper takes plain tensors (on a mesh, each rank's local
    blocks), so a sharded call cannot quietly take another route."""
    from torch.distributed.tensor import DTensor
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(
                f"{name} takes plain tensors, not a DTensor "
                f"({t.placements} on {t.device_mesh}): pass each rank's "
                f"local block (DTensor.to_local())")
