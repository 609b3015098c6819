"""Host-to-device prefetch: overlap the next batch's copy with compute.

The counterpart of ``tpu_on_k8s/data/prefetch.py``: the generator keeps
``depth`` batches ahead of the training loop on the device, so the copy of
batch N+1 runs while step N computes. It takes a ``torch.device`` where the
reference takes a sharding (this port has no mesh yet).

On ``cuda`` each batch is staged in pinned host memory and copied on a
copy stream of its own with ``non_blocking=True``; before a batch is
yielded, the consumer's current stream waits on the copy's event, and each
tensor is ``record_stream``-ed onto that stream, so the caching allocator
does not hand its memory to the copy stream again while a step still reads
it. On the CPU the batches are yielded as given (numpy arrays as tensors
that share their memory).
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.asarray(leaf))


def device_prefetch(batches: Iterable, device: str | torch.device,
                    depth: int = 2,
                    transform: Optional[Callable] = None) -> Iterator:
    """Yield device-resident batches, keeping ``depth`` in flight.

    A batch is an array or a tensor, or a tuple, list or dict of them.
    ``transform`` runs on the host before the copy (e.g. split image and
    label)."""
    device = torch.device(device)
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    queue: collections.deque = collections.deque()
    it = iter(batches)
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)

    def staged(leaf) -> torch.Tensor:
        t = _as_tensor(leaf)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(device, non_blocking=True)

    def enqueue(n: int) -> None:
        for _ in range(n):
            try:
                batch = next(it)
            except StopIteration:
                return
            if transform is not None:
                batch = transform(batch)
            if copy_stream is None:
                queue.append((tree_map(_as_tensor, batch), None))
                continue
            with torch.cuda.stream(copy_stream):
                out = tree_map(staged, batch)
                copied = torch.cuda.Event()
                copied.record(copy_stream)
            queue.append((out, copied))

    enqueue(depth)
    while queue:
        out, copied = queue.popleft()
        if copied is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(copied)
            for t in tree_leaves(out):
                t.record_stream(consumer)
        enqueue(1)
        yield out
