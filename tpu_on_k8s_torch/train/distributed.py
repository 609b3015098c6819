"""Worker-side runtime init: the consumer of the operator's env, the
counterpart of ``tpu_on_k8s/train/distributed.py``.

The operator injects the coordinator's address, the process count and this
process's index into every task pod; ``parse_env`` reads them under the
reference's names and ``initialize`` joins the job's
``torch.distributed`` world with them: NCCL on the card, and gloo only
where the caller asked for ``device="cpu"``. Where torchrun's ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` are set, their
rendezvous takes the place of the operator's (the torch runtime's own launcher, as
``jax.distributed`` detects its cluster). Off-cluster (neither env) it is a
no-op returning a single-process context, so one training script runs on a
laptop, in tests and on a cluster; ``local_world`` then makes a world of
one rank in the process itself, for a mesh of one card.

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

#: torchrun's rendezvous variables; all four set select their rendezvous
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class DistributedContext:
    """What the pod env says about this worker's place in the job."""

    coordinator_address: Optional[str] = None
    process_id: int = 0
    num_processes: int = 1
    worker_hostnames: tuple = ()
    num_slices: int = 1
    slice_id: int = 0
    model_path: Optional[str] = None

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1 and self.coordinator_address is not None

    @property
    def is_multislice(self) -> bool:
        return self.num_slices > 1

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0


def parse_env(env: Optional[Mapping[str, str]] = None) -> DistributedContext:
    """Read the operator-injected variables (missing ⇒ single-process)."""
    env = os.environ if env is None else env
    hostnames = tuple(
        h for h in env.get(constants.ENV_TPU_WORKER_HOSTNAMES, "").split(",")
        if h)
    return DistributedContext(
        coordinator_address=env.get(constants.ENV_COORDINATOR_ADDRESS) or None,
        process_id=int(env.get(constants.ENV_PROCESS_ID, "0")),
        num_processes=int(env.get(constants.ENV_NUM_PROCESSES, "1")),
        worker_hostnames=hostnames,
        num_slices=int(env.get(constants.ENV_MEGASCALE_NUM_SLICES, "1")),
        slice_id=int(env.get(constants.ENV_MEGASCALE_SLICE_ID, "0")),
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
    one, and return this worker's context.

    * torchrun's four variables set: their rendezvous
      (``tcp://MASTER_ADDR:MASTER_PORT`` at ``RANK`` of ``WORLD_SIZE``), at
      any world size;
    * else the operator's ``XLA_COORDINATOR_ADDRESS`` with
      ``TPU_NUM_PROCESSES`` > 1: ``tcp://<address>`` at rank
      ``TPU_PROCESS_ID``;
    * else a no-op (single process).

    The backend is NCCL on the card and gloo for ``device="cpu"``; a CUDA
    run that cannot join over NCCL raises. A world already initialised is
    left as it is."""
    env = os.environ if env is None else env
    if all(env.get(k) for k in TORCHRUN_ENV):
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        ctx = dataclasses.replace(
            parse_env(env),
            coordinator_address=f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
            process_id=rank, num_processes=world)
        if not dist.is_initialized():
            _set_card(device, int(env.get("LOCAL_RANK", rank)))
            dist.init_process_group(
                backend_for(device),
                init_method=f"tcp://{ctx.coordinator_address}", rank=rank,
                world_size=world)
        return ctx
    ctx = parse_env(env)
    if ctx.is_distributed and not dist.is_initialized():
        _set_card(device, ctx.process_id)
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
