"""The mesh workers of a serving engine: how the engine's device programs
run on every rank of its mesh.

The reference's engine is one SPMD program under one controller: XLA
inserts the collectives and the host bookkeeping exists once. A PyTorch
mesh has one process per rank, and the serving plane's host objects (the
engine's queues, the gateway, the fleet, their clocks and locks) cannot be
kept in step across processes. So all host state lives on one rank, the
**driver** (the rank whose caller builds the engine: the first rank of the
engine's mesh), and every other rank of the world runs
``serve_mesh_worker``. This module has no counterpart in the reference:
its single controller needs none.

* ``CommandChannel``: one gloo group over the world's ranks, kept for
  commands. Before each device program, the driver broadcasts a fixed
  int32 header. A decode step or a verify (``HOT_ARGS``) rides in it
  whole: the program, the engine's id, and its token, position and
  block-table arrays, with their shapes (a second broadcast carries what
  does not fit). Any other command (admissions, exports, imports, loads,
  closes) follows the header as a pickled object: the program's name, the
  engine's id, its host arguments, the shapes and dtypes of any tensor
  payload, and the frees and closes that garbage collection deferred. A
  world of one runs it all the same.
* ``share_payload``: a payload's tensors (parameters, a KV payload to
  import) go from the driver to every rank of the mesh over the mesh's own
  groups (NCCL on the card, gloo on the CPU), one mesh dim after another
  from the driver's coordinate.
* ``serve_mesh_worker(meshes)``: a worker's loop. It builds its half of
  every engine the driver builds on one of ``meshes`` (its shard of the
  parameters and of the KV pool), runs each program the driver names on
  its shard, with the driver's inputs, and drops an engine when the driver
  closes it. It decides nothing from its own clock or RNG: sampling, slot
  and page choices all come from the driver.

Every mesh a world serves on is made (collectively, by every rank) before
the workers enter their loop and before the driver builds its first
engine: the loop takes no part in making new process groups.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_on_k8s_torch.parallel.mesh import mesh_ranks, mesh_shape

#: ``(name, shape, dtype)`` of each tensor of a payload, in order
Specs = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]

#: the programs whose commands ride the fixed header, and their arguments:
#: int32 arrays of at most two dims, or None
HOT_ARGS = {"decode": ("toks", "pos", "tables"),
            "verify": ("chunk", "cpos", "tables")}
_HOT = tuple(HOT_ARGS)
#: the header's int32 words: the command's code (0: a pickled command
#: follows; i > 0: ``_HOT[i - 1]``) and engine id, three (ndim, d0, d1)
#: triples (ndim -1: None), then the arrays' values
HEADER_WORDS = 256
_DATA = 2 + 3 * 3


def mesh_key(mesh: DeviceMesh) -> tuple:
    """What names a mesh in a command: its ranks in grid order and its
    axis sizes. Two meshes with the same key place every block alike."""
    return (mesh_ranks(mesh), tuple(mesh_shape(mesh).items()))


class CommandChannel:
    """The world's serving command channel: a gloo group over every rank of
    the ``torch.distributed`` world; the driver broadcasts, the workers
    receive. ``of_world`` makes it once per world (collectively)."""

    #: the current world's channel: one per ``torch.distributed`` world,
    #: which is itself process-wide state
    _current: Optional["CommandChannel"] = None

    def __init__(self, driver: int) -> None:
        self.world = dist.group.WORLD
        self.group = dist.new_group(backend="gloo")
        self.driver = driver
        self.is_driver = dist.get_rank() == driver
        # appended from garbage collection, drained by ``send``: a deque,
        # whose appends and pops need no lock
        self._deferred: deque = deque()
        self._engine_ids = itertools.count(1)

    @classmethod
    def of_world(cls, driver: int = 0) -> "CommandChannel":
        """The channel of the current world, made on first use: the first
        call is collective (every rank makes it, in the same order among
        the world's process groups)."""
        if not dist.is_initialized():
            raise RuntimeError(
                "mesh serving needs an initialised torch.distributed world "
                "(tpu_on_k8s_torch.train.distributed.initialize or "
                "local_world)")
        ch = cls._current
        if ch is None or ch.world is not dist.group.WORLD:
            ch = cls._current = cls(driver)
        if ch.driver != driver:
            raise ValueError(f"the world's driver is rank {ch.driver}, "
                             f"not {driver}")
        return ch

    def new_engine_id(self) -> int:
        return next(self._engine_ids)

    def defer(self, kind: str, engine: int, handle: Optional[int] = None
              ) -> None:
        """Queue a ``free`` (a dropped cache handle) or a ``close`` (an
        engine gone) for the next header: garbage collection may run in
        the middle of a broadcast, so it never sends itself."""
        self._deferred.append((kind, engine, handle))

    def _broadcast(self, t: torch.Tensor) -> None:
        dist.broadcast(t, src=self.driver, group=self.group)

    def send(self, engine: int, op: str, args: Optional[dict] = None,
             specs: Specs = ()) -> None:
        """Broadcast one command (the driver only)."""
        packed = (None if specs or self._deferred
                  else pack_header(engine, op, args or {}))
        if packed is not None:
            head, rest = packed
            self._broadcast(torch.from_numpy(head))
            if rest.size:
                self._broadcast(torch.from_numpy(rest))
            return
        deferred = []
        while self._deferred:
            deferred.append(self._deferred.popleft())
        head = np.zeros(HEADER_WORDS, np.int32)
        head[1] = engine
        self._broadcast(torch.from_numpy(head))
        dist.broadcast_object_list(
            [(op, engine, args or {}, tuple(specs), tuple(deferred))],
            src=self.driver, group=self.group)

    def recv(self) -> tuple:
        """The next command: ``(op, engine, args, specs, deferred)``."""
        head = torch.empty(HEADER_WORDS, dtype=torch.int32)
        self._broadcast(head)
        if int(head[0]) == 0:
            box = [None]
            dist.broadcast_object_list(box, src=self.driver,
                                       group=self.group)
            return box[0]

        def rest(n: int) -> np.ndarray:
            t = torch.empty(n, dtype=torch.int32)
            self._broadcast(t)
            return t.numpy()

        op, engine, args = unpack_header(head.numpy(), rest)
        return op, engine, args, (), ()


def pack_header(engine: int, op: str, args: dict
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """A ``HOT_ARGS`` command as the header and the values that do not fit
    in it; None for any other command (or arrays that are not int32)."""
    arrays = [args[name] for name in HOT_ARGS.get(op, ())]
    if not arrays or not all(a is None or a.dtype == np.int32
                             for a in arrays):
        return None
    head = np.zeros(HEADER_WORDS, np.int32)
    head[0], head[1] = _HOT.index(op) + 1, engine
    for j, a in enumerate(arrays):
        head[2 + 3 * j] = -1 if a is None else a.ndim
        if a is not None:
            head[3 + 3 * j:3 + 3 * j + a.ndim] = a.shape
    data = np.concatenate([a.ravel() for a in arrays if a is not None])
    fit = min(data.size, HEADER_WORDS - _DATA)
    head[_DATA:_DATA + fit] = data[:fit]
    return head, np.ascontiguousarray(data[fit:])


def unpack_header(head: np.ndarray, rest: Callable[[int], np.ndarray]
                  ) -> Tuple[str, int, dict]:
    """``(op, engine, args)`` of a packed header; ``rest(n)`` returns the
    ``n`` values that did not fit."""
    op = _HOT[head[0] - 1]
    shapes = [None if head[2 + 3 * j] < 0 else
              tuple(int(d) for d in head[3 + 3 * j:3 + 3 * j
                                         + head[2 + 3 * j]])
              for j in range(3)]
    total = sum(int(np.prod(sh)) for sh in shapes if sh is not None)
    fit = min(total, HEADER_WORDS - _DATA)
    data = head[_DATA:_DATA + fit]
    if fit < total:
        data = np.concatenate([data, rest(total - fit)])
    args, at = {}, 0
    for name, sh in zip(HOT_ARGS[op], shapes):
        n = 0 if sh is None else int(np.prod(sh))
        args[name] = None if sh is None else data[at:at + n].reshape(sh).copy()
        at += n
    return op, int(head[1]), args


def broadcast_from_origin(t: torch.Tensor, mesh: DeviceMesh) -> None:
    """Broadcast ``t`` (contiguous) in place from the mesh's first rank to
    every rank of the mesh: along each mesh dim in turn, the ranks that
    hold it (coordinate 0 on this dim and every later one) send along the
    dim. Dims of size 1 move nothing."""
    coord = mesh.get_coordinate()
    flat = t.view(-1).view(torch.uint8)
    for d in range(mesh.ndim):
        if mesh.size(d) == 1 or any(coord[j] for j in range(d + 1,
                                                            mesh.ndim)):
            continue
        g = mesh.get_group(d)
        dist.broadcast(flat, src=dist.get_global_rank(g, 0), group=g)


def payload_specs(payload: Dict[str, torch.Tensor]) -> Specs:
    return tuple((name, tuple(t.shape), t.dtype)
                 for name, t in payload.items())


def share_payload(mesh: Optional[DeviceMesh], device: torch.device,
                  payload: Optional[Dict[str, torch.Tensor]],
                  specs: Specs) -> Dict[str, torch.Tensor]:
    """The payload on ``device`` on every rank of ``mesh``: the driver
    passes its tensors (moved to ``device``; a tensor already there is
    used as it is), a worker ``None`` (it allocates from ``specs``)."""
    out = {}
    for name, shape, dtype in specs:
        if payload is not None:
            t = payload[name].to(device).contiguous()
        else:
            t = torch.empty(shape, dtype=dtype, device=device)
        if mesh is not None:
            broadcast_from_origin(t, mesh)
        out[name] = t
    return out


def serve_mesh_worker(meshes: DeviceMesh | Sequence[DeviceMesh],
                      driver: int = 0) -> Dict[str, int]:
    """This rank's half of every engine the driver builds on one of
    ``meshes`` (module docstring), until the driver calls
    ``shutdown_mesh_workers``. Returns ``{"served": engines built,
    "open": engines neither closed nor collected on the driver}``."""
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    if isinstance(meshes, DeviceMesh):
        meshes = [meshes]
    chan = CommandChannel.of_world(driver)
    if chan.is_driver:
        raise ValueError("the driver rank builds the engines; every other "
                         "rank runs serve_mesh_worker")
    by_key = {mesh_key(m): m for m in meshes}
    me = dist.get_rank()
    engines: Dict[int, ContinuousBatchingEngine] = {}
    served = 0
    while True:
        op, eid, args, specs, deferred = chan.recv()
        _apply_deferred(engines, deferred)
        if op == "shutdown":
            return {"served": served, "open": len(engines)}
        if op == "init":
            key = args["mesh"]
            if me not in key[0]:
                continue
            mesh = by_key.get(key)
            if mesh is None:
                raise RuntimeError(
                    f"rank {me} is in the mesh {key} of engine {eid} but "
                    f"was not given it: pass every serving mesh to "
                    f"serve_mesh_worker")
            engines[eid] = ContinuousBatchingEngine._as_mesh_worker(
                args["spec"], mesh, specs)
            served += 1
            continue
        if op == "close":
            engines.pop(eid, None)
            continue
        eng = engines.get(eid)
        if eng is None:
            continue                     # an engine on another mesh
        eng._serve_command(op, args, specs)


def _apply_deferred(engines: dict, deferred: Iterable[tuple]) -> None:
    for kind, eid, handle in deferred:
        if kind == "close":
            engines.pop(eid, None)
        elif eid in engines:
            engines[eid]._p_reset([handle])


def shutdown_mesh_workers(driver: int = 0) -> None:
    """End every worker's ``serve_mesh_worker`` loop (the driver, when it
    has served its last engine)."""
    CommandChannel.of_world(driver).send(0, "shutdown")
