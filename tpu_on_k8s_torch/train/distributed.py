"""Worker-side runtime init: the consumer of the operator's env, the
counterpart of ``tpu_on_k8s/train/distributed.py``.

The operator (``controller/torchjob.py``) injects ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` into every task pod — the
variables torchrun sets too — and ``parse_env`` reads them (with the model
path) from the names in ``api/constants.py``. ``initialize`` joins the
job's ``torch.distributed`` world with them: NCCL on the card, and gloo
only where the caller asked for ``device="cpu"``. Off-cluster (no such
env) it is a no-op returning a single-process context, so one training
script runs on a laptop, in tests and on a cluster; ``local_world`` then
makes a world of one rank in the process itself, for a mesh of one card.

    from tpu_on_k8s_torch.train.distributed import initialize
    ctx = initialize()              # no-op off-cluster
    mesh = create_mesh(...)         # spans all ctx.num_processes ranks
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from tpu_on_k8s_torch import constants
from tpu_on_k8s_torch.device import resolve_device

#: the rendezvous variables, the operator's and torchrun's alike; all four
#: set select their rendezvous
TORCHRUN_ENV = (constants.ENV_PROCESS_ID, constants.ENV_NUM_PROCESSES,
                constants.ENV_MASTER_ADDR, constants.ENV_MASTER_PORT)


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """What the pod env says about this worker's place in the job."""

    coordinator_address: Optional[str] = None
    process_id: int = 0
    num_processes: int = 1
    model_path: Optional[str] = None

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1 and self.coordinator_address is not None

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def parse_env(env: Optional[Mapping[str, str]] = None) -> DistributedContext:
    """Read the operator-injected variables (missing ⇒ single-process)."""
    env = os.environ if env is None else env
    addr = env.get(constants.ENV_MASTER_ADDR)
    port = env.get(constants.ENV_MASTER_PORT)
    return DistributedContext(
        coordinator_address=f"{addr}:{port}" if addr and port else None,
        process_id=int(env.get(constants.ENV_PROCESS_ID) or "0"),
        num_processes=int(env.get(constants.ENV_NUM_PROCESSES) or "1"),
        model_path=env.get(constants.ENV_MODEL_PATH) or None,
    )


def backend_for(device: str | torch.device = "cuda") -> str:
    """NCCL for the card (which must be there: ``resolve_device`` raises
    without one), gloo for an explicit CPU run. Nothing else: a CUDA run
    never drops to gloo."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _set_card(device: str | torch.device, local_rank: int) -> None:
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def initialize(env: Optional[Mapping[str, str]] = None,
               device: str | torch.device = "cuda") -> DistributedContext:
    """Join the job's ``torch.distributed`` world if the env says there is
    one, and return this worker's context: with ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR`` and ``MASTER_PORT`` all set, the rendezvous at
    ``tcp://MASTER_ADDR:MASTER_PORT`` as rank ``RANK`` of ``WORLD_SIZE``, at
    any world size (one included); else a no-op (single process).

    The backend is NCCL on the card and gloo for ``device="cpu"``; a CUDA
    run that cannot join over NCCL raises. A world already initialised is
    left as it is."""
    env = os.environ if env is None else env
    ctx = parse_env(env)
    if all(env.get(k) for k in TORCHRUN_ENV) and not dist.is_initialized():
        _set_card(device, int(env.get("LOCAL_RANK", ctx.process_id)))
        dist.init_process_group(
            backend_for(device),
            init_method=f"tcp://{ctx.coordinator_address}",
            rank=ctx.process_id, world_size=ctx.num_processes)
    return ctx


def local_world(device: str | torch.device = "cuda") -> bool:
    """A world of one rank in this process (an in-process store: no
    address, no port), for a mesh over the one card (or, with
    ``device="cpu"``, the CPU) when no launcher made one. Returns whether
    it made the world (False when one was initialised already)."""
    if dist.is_initialized():
        return False
    _set_card(device, 0)
    dist.init_process_group(backend_for(device), store=dist.HashStore(),
                            rank=0, world_size=1)
    return True

