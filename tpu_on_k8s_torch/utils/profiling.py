"""Profiling hooks on ``torch.profiler``: the counterpart of
``tpu_on_k8s/utils/profiling.py``.

``trace("/dir")`` around training steps records the host and the card
(CPU and CUDA activities) and writes a Chrome trace into the directory at
its end; ``annotate(name)`` is a named region on that timeline
(``torch.profiler.record_function``). PyTorch has no live profiler server
to attach to, so ``start_server`` raises; the training loop turns that
into a warning and its ``profiling_failures`` counter, as it does for a
server that fails to bind.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


def start_server(port: int):
    """There is no live profiler server in PyTorch: raises
    ``RuntimeError``. Capture a trace with ``trace`` instead."""
    raise RuntimeError(f"no live profiler server on :{port}: torch.profiler "
                       f"has none; capture a trace with the profile "
                       f"directory instead")


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed steps and write a Chrome trace
    (``trace-<pid>-<time>.json``) into ``log_dir`` when they end."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region that shows up on the trace timeline."""
    import torch

    with torch.profiler.record_function(name):
        yield
