"""PyTorch/CUDA port of the tpu_on_k8s compute plane, for NVIDIA Hopper.

The JAX package ``tpu_on_k8s`` stays the reference; each module here keeps its
counterpart's name (``models/transformer.py``, ``models/decode.py``,
``ops/flash_attention.py`` ...). Plain tensor code is PyTorch; every Pallas
TPU kernel on a ported path is a CUDA C++ kernel for ``sm_90a`` under
``ops/csrc/``, built on first use by ``ops/_build.py``.

This package imports nothing of ``tpu_on_k8s`` and nothing of JAX. Entry
points run on the CUDA card unless given ``device="cpu"``.
"""
from tpu_on_k8s_torch.device import resolve_device

__all__ = ["resolve_device"]
