"""Generation-versioned checkpoints and the checkpoint agent: the
counterpart of ``tpu_on_k8s/train/checkpoint.py``.

* ``CheckpointManager`` saves a training state under
  ``<root>/gen_<G:06d>/<step>/``, one generation per elastic rescale, with
  the reference's ``generations``, ``latest``, ``max_to_keep`` (per
  generation), ``save(wait=False)``, ``wait_until_finished`` and ``close``.
  The files are ``torch.distributed.checkpoint``'s (one process, no
  process group), so a sharded layout can later restore the same files.
  A step's directory appears only once its files are complete (written
  under a temporary name, then renamed): a crashed save never wins
  ``latest``.
* ``CheckpointAgent`` is the job side of the operator's 2-phase checkpoint
  protocol: it polls the job's ``ckpt-requested-version`` annotation, runs
  the save callback at that generation and acknowledges with
  ``ckpt-completed-version``.

A state is a ``TrainState`` (``train/trainer.py``: parameters, both Adam
moments in their stored dtypes, the optimizer's ``count`` and the step) or
a dict (nested dicts allowed) of tensors. ``restore`` takes a live or empty
state as its template and fills it: a ``TrainState`` in place, a dict as a
new dict of new tensors on the template's devices.

The async save (``wait=False``). The port's optimizer updates the
parameters in place, so step s's state must be captured before step s+1
writes to it, without holding up the host: on the card, a copy stream
waits for the work queued so far (step s), copies every tensor into spare
device buffers, and records an event; the compute stream waits on that
event, so the next step's updates start after the copy and the host never
blocks. A writer thread then copies the buffers into pinned host memory
on the copy stream (waiting on an event) and writes the files; its error,
if any, is raised by ``wait_until_finished``. The device and pinned
buffers are allocated on the first save and kept: pinning host memory
holds up the compute stream's launches while it runs, and so does a copy
into pageable memory. One save is in
flight at a time: a new ``save`` first waits for the previous one to end
(its error is kept for the drain). On the CPU the snapshot is a clone.

On a mesh (a state whose tensors are ``DTensor``s: a ``Trainer`` laid out
by ``parallel/sharded.py``) every rank takes part in each save and restore.
Each rank snapshots its own blocks (on the card into spare device buffers,
as above) and its writer thread saves them with ``dcp.save`` over a gloo
process group of the manager's own, made once on every rank at the first
sharded save or restore, so the save's collectives never interleave with
the step's NCCL ones. The coordinator (rank 0) renames the finished
directory; a barrier on that group then closes the save on every rank.
``restore(template, mesh=, rules=)`` lays the template out on another mesh
first (``parallel/reshard.py``'s ``abstract_resharded``, validated before
any read: ``ShardingValidationError``) and ``dcp.load`` reads each rank's
blocks of the new layout from whatever layout wrote the files.

This package cannot read the JAX package's orbax checkpoints (orbax and
tensorstore are not imported here); carry a JAX state across with
``models/params.py``'s ``from_jax_train_state`` instead.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor

from tpu_on_k8s_torch import constants
from tpu_on_k8s_torch.models.params import keeps_fp32
from tpu_on_k8s_torch.train.trainer import TrainState

#: Threads (and files) a step's directory is written with.
WRITE_THREADS = 4

# any width: gen dirs are zero-padded to 6 digits, but generations >= 1e6
# grow wider and discovery must still see them
_GEN_RE = re.compile(r"^gen_(\d+)$")


def _gen_dir(root: Path, generation: int) -> Path:
    return root / f"gen_{generation:06d}"


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """A state as the flat ``{key: tensor}`` mapping the files hold."""
    if isinstance(tree, TrainState):
        return tree.state_dict()
    if not isinstance(tree, dict):
        raise TypeError(f"a checkpointed state is a TrainState or a dict of "
                        f"tensors, not {type(tree).__name__}")
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{key}/"))
        elif isinstance(v, torch.Tensor):
            out[key] = v
        else:
            raise TypeError(f"{key!r} is a {type(v).__name__}, not a tensor")
    return out


def _sharded(flat: Dict[str, torch.Tensor]) -> bool:
    return any(isinstance(t, DTensor) for t in flat.values())


def _held(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``flat`` less the ``DTensor``s on a mesh this rank is not in (it
    holds no block of them: their members write and read them)."""
    return {k: t for k, t in flat.items()
            if not (isinstance(t, DTensor)
                    and t.device_mesh.get_coordinate() is None)}


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _like(t: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` in ``t``'s place: wrapped as a ``DTensor`` of ``t``'s
    layout when ``t`` is one."""
    if not isinstance(t, DTensor):
        return local
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def _unflatten_like(tree: dict, flat: Dict[str, torch.Tensor],
                    prefix: str = "") -> dict:
    return {k: (_unflatten_like(v, flat, f"{prefix}{k}/")
                if isinstance(v, dict) else flat[f"{prefix}{k}"])
            for k, v in tree.items()}


class CheckpointManager:
    """``torch.distributed.checkpoint`` files, one directory a step, one
    subdirectory a generation (see the module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.root = Path(directory)
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._errors: List[Exception] = []
        self._buffers: Dict[str, torch.Tensor] = {}
        self._host: Dict[str, torch.Tensor] = {}
        self._copy_stream = None
        self._group = None

    # ------------------------------------------------------------- discovery
    def generations(self) -> Sequence[int]:
        out = []
        for child in sorted(self.root.iterdir()) if self.root.exists() else []:
            m = _GEN_RE.match(child.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def steps(self, generation: int) -> List[int]:
        """The complete steps of a generation, oldest first."""
        d = _gen_dir(self.root, generation)
        if not d.is_dir():
            return []
        return sorted(int(c.name) for c in d.iterdir()
                      if c.is_dir() and c.name.isdigit())

    def latest(self) -> Optional[Tuple[int, int]]:
        """(generation, step) of the newest checkpoint, or None: the highest
        generation that holds a complete step (an empty gen dir from a
        crashed save never wins)."""
        for gen in reversed(self.generations()):
            steps = self.steps(gen)
            if steps:
                return gen, steps[-1]
        return None

    # ------------------------------------------------------------------- I/O
    def save(self, state: Any, *, step: int, generation: int = 0,
             wait: bool = True) -> None:
        """Save ``state`` as ``step`` of ``generation``. With ``wait=False``
        it returns once the snapshot is enqueued; the files are written on
        a thread (see the module docstring)."""
        self._join()
        flat = _flatten(state)
        group = self._process_group() if _sharded(flat) else None
        snapshot, host, copied = self._snapshot(_held(flat))
        target = _gen_dir(self.root, generation) / str(step)
        self._thread = threading.Thread(
            target=self._write,
            args=(snapshot, host, copied, target, generation, group),
            name="checkpoint-writer", daemon=True)
        self._thread.start()
        if wait:
            self.wait_until_finished()

    def _process_group(self):
        """The manager's own gloo group over the world, made on first use
        (on every rank at once: the first sharded save or restore)."""
        if self._group is None:
            self._group = dist.new_group(backend="gloo")
        return self._group

    def _snapshot(self, flat: Dict[str, torch.Tensor]):
        """Copies of ``flat``'s tensors (a ``DTensor``'s local block, as a
        ``DTensor`` of its layout) taken at this point of the stream order:
        (the copies, the pinned host buffers the writer copies the card's
        plain tensors into, the CUDA event after which the device copies
        hold them; both None on the CPU)."""
        on_card = [k for k, t in flat.items() if _local(t).is_cuda]
        snap = {k: _like(t, _local(t).detach().clone())
                for k, t in flat.items() if not _local(t).is_cuda}
        if not on_card:
            return snap, None, None
        device = flat[on_card[0]].device
        compute = torch.cuda.current_stream(device)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device)
        for k in on_card:
            t, buf = _local(flat[k]), self._buffers.get(k)
            if (buf is None or buf.shape != t.shape or buf.dtype != t.dtype
                    or buf.device != t.device):
                with torch.cuda.stream(self._copy_stream):
                    self._buffers[k] = torch.empty_like(
                        t, memory_format=torch.contiguous_format)
                if not isinstance(flat[k], DTensor):
                    # pinned, allocated once: a copy into pageable memory
                    # holds up the compute stream's launches for its whole
                    # length
                    self._host[k] = torch.empty(t.shape, dtype=t.dtype,
                                                pin_memory=True)
        self._copy_stream.wait_stream(compute)
        with torch.cuda.stream(self._copy_stream):
            torch._foreach_copy_([self._buffers[k] for k in on_card],
                                 [_local(flat[k]) for k in on_card])
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        compute.wait_event(copied)
        snap.update((k, _like(flat[k], self._buffers[k])) for k in on_card)
        # a DTensor's blocks go to the files from the device (dcp.save over
        # the manager's group copies them); plain tensors through pinned
        # host buffers
        host = {k: self._host[k] for k in on_card
                if not isinstance(flat[k], DTensor)}
        return snap, host, copied

    def _write(self, snap: Dict[str, torch.Tensor],
               host: Optional[Dict[str, torch.Tensor]], copied, target: Path,
               generation: int, group=None) -> None:
        try:
            if group is not None:
                self._write_sharded(snap, copied, target, generation, group)
                return
            if copied is not None:
                # device to pinned host memory on the copy stream, after
                # the snapshot; an event wait, not a stream sync
                with torch.cuda.stream(self._copy_stream):
                    self._copy_stream.wait_event(copied)
                    for k, dst in host.items():
                        dst.copy_(snap[k], non_blocking=True)
                    landed = torch.cuda.Event()
                    landed.record(self._copy_stream)
                landed.synchronize()
                snap = {**snap, **host}
            target.parent.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f".{target.name}.tmp-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            # the tensors are on the host already: no copy-ahead stream
            # (it would synchronize once a tensor)
            dcp.save(snap, storage_writer=dcp.FileSystemWriter(
                str(tmp), thread_count=WRITE_THREADS,
                per_thread_copy_ahead=0), no_dist=True)
            if target.exists():
                shutil.rmtree(target)
            os.replace(tmp, target)
            if self.max_to_keep:
                for old in self.steps(generation)[:-self.max_to_keep]:
                    shutil.rmtree(_gen_dir(self.root, generation) / str(old),
                                  ignore_errors=True)
        except Exception as e:  # noqa: BLE001 — raised at the drain
            self._errors.append(e)

    def _write_sharded(self, snap: Dict[str, torch.Tensor], copied,
                       target: Path, generation: int, group) -> None:
        """Every rank's blocks through ``dcp.save`` over the manager's
        group (on the card once the snapshot's event has fired); the
        coordinator renames and prunes, then a barrier."""
        coordinator = dist.get_rank(group) == 0
        tmp = target.with_name(f".{target.name}.tmp-sharded")
        if coordinator:
            target.parent.mkdir(parents=True, exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
        dist.barrier(group=group)
        if copied is not None:
            # dcp.save copies the blocks off the card on streams of its
            # own: this thread waits for the snapshot first (the training
            # thread does not)
            copied.synchronize()
        dcp.save(snap, storage_writer=dcp.FileSystemWriter(
            str(tmp), thread_count=WRITE_THREADS), process_group=group)
        if coordinator:
            if target.exists():
                shutil.rmtree(target)
            os.replace(tmp, target)
            if self.max_to_keep:
                for old in self.steps(generation)[:-self.max_to_keep]:
                    shutil.rmtree(_gen_dir(self.root, generation) / str(old),
                                  ignore_errors=True)
        dist.barrier(group=group)

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, template: Any, *, generation: Optional[int] = None,
                step: Optional[int] = None, mesh: Any = None,
                rules: Optional[Sequence[Any]] = None
                ) -> Tuple[Any, int, int]:
        """Restore into ``template`` (a live or empty ``TrainState``, filled
        in place and returned, or a dict of tensors, whose keys name what
        to read: a new dict of new tensors comes back). Defaults to the
        newest generation and step. Returns (state, generation, step).
        Each tensor's shape and dtype must match the file's.

        ``mesh`` and ``rules`` (together or not at all) restore onto that
        layout, whatever layout wrote the files: the template is laid out
        there first (validated before any read), and a new state comes
        back (a ``TrainState`` on a fresh model laid out on the mesh, or a
        dict of ``DTensor``s)."""
        if (mesh is None) != (rules is None):
            raise ValueError("pass mesh and rules together (or neither)")
        if mesh is not None:
            from tpu_on_k8s_torch.parallel.reshard import abstract_resharded
            template = abstract_resharded(template, mesh, rules)
        generation, step, path = self._locate(generation, step)
        if isinstance(template, dict):
            flat = {k: (t if isinstance(t, DTensor) and mesh is not None
                        else torch.empty_like(t))
                    for k, t in _flatten(template).items()}
        else:
            flat = _flatten(template)
        self._check(path, flat)
        if _sharded(flat):
            dcp.load(_held(flat), checkpoint_id=str(path),
                     process_group=self._process_group())
        else:
            dcp.load(flat, checkpoint_id=str(path), no_dist=True)
        if isinstance(template, dict):
            return _unflatten_like(template, flat), generation, step
        template.load_state_dict(flat)
        return template, generation, step

    def _locate(self, generation: Optional[int], step: Optional[int]
                ) -> Tuple[int, int, Path]:
        if generation is None:
            latest = self.latest()
            if latest is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
            generation, latest_step = latest
            step = latest_step if step is None else step
        if step is None:
            steps = self.steps(generation)
            if not steps:
                raise FileNotFoundError(
                    f"no steps in generation {generation} under {self.root}")
            step = steps[-1]
        path = _gen_dir(self.root, generation) / str(step)
        if not path.is_dir():
            raise FileNotFoundError(f"no step {step} in generation "
                                    f"{generation} under {self.root}")
        return generation, step, path

    @staticmethod
    def metadata(path: Path) -> Dict[str, Tuple[torch.Size, torch.dtype]]:
        """Every tensor a checkpoint directory holds: key → (shape, dtype)."""
        meta = dcp.FileSystemReader(str(path)).read_metadata()
        return {k: (m.size, m.properties.dtype)
                for k, m in meta.state_dict_metadata.items()}

    def _check(self, path: Path, flat: Dict[str, torch.Tensor]) -> None:
        held = self.metadata(path)
        for k, t in flat.items():
            if k not in held:
                raise KeyError(f"{path} holds no {k!r}")
            if held[k] != (t.shape, t.dtype):
                raise ValueError(f"{k!r} is {tuple(held[k][0])} "
                                 f"{held[k][1]} in {path}; the template "
                                 f"holds {tuple(t.shape)} {t.dtype}")

    def wait_until_finished(self) -> None:
        """Wait for the save in flight; raise the first error of a save
        since the last drain."""
        self._join()
        if self._errors:
            error, self._errors = self._errors[0], []
            raise error

    def close(self) -> None:
        """Wait for the save in flight and free the snapshot buffers."""
        self._join()
        self._buffers.clear()
        self._host.clear()
        self._copy_stream = None


def load_params(directory: str, device: str | torch.device = "cuda",
                dtype: Optional[torch.dtype] = None,
                generation: Optional[int] = None, step: Optional[int] = None
                ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """The parameters alone of a saved ``TrainState`` (what serving
    restores): ``{name: tensor}`` on ``device``, the matrices cast to
    ``dtype`` when given (norm scales stay fp32, as ``init_params`` stores
    serving weights), else in their stored dtypes (the fp32 masters), with
    the generation and step (default: the newest). Norm biases stay fp32
    too (``params.keeps_fp32``)."""
    if not Path(directory).is_dir():
        raise FileNotFoundError(f"no checkpoints under {directory}")
    mgr = CheckpointManager(directory)
    generation, step, path = mgr._locate(generation, step)
    flat = {k: torch.empty(shape, dtype=held, device=device)
            for k, (shape, held) in mgr.metadata(path).items()
            if k.startswith("params/")}
    if not flat:
        raise KeyError(f"{path} holds no parameters (params/...)")
    dcp.load(flat, checkpoint_id=str(path), no_dist=True)
    params = {}
    for key, t in flat.items():
        name = key[len("params/"):]
        keep = dtype is None or keeps_fp32(name)
        params[name] = t if keep else t.to(dtype)
    return params, generation, step


class CheckpointAgent:
    """The job side of the operator's 2-phase checkpoint protocol.

    ``save_fn(generation)`` must persist training state (typically through
    ``CheckpointManager.save(..., generation=generation)``); when it
    returns, the agent acknowledges by writing ``ckpt-completed-version``,
    which unblocks the operator's victim cleanup and generation bump.
    ``cluster`` is duck-typed: ``try_get(job_cls, namespace, name)`` and
    ``patch_meta(job_cls, namespace, name, annotations=...)``; ``job_cls``
    is the job's type (the operator's ``TPUJob``, which this package does
    not import)."""

    def __init__(self, cluster: Any, namespace: str, job_name: str,
                 save_fn: Callable[[int], None], job_cls: type):
        self.cluster = cluster
        self.namespace = namespace
        self.job_name = job_name
        self.save_fn = save_fn
        self.job_cls = job_cls

    def pending_request(self) -> Optional[int]:
        job = self.cluster.try_get(self.job_cls, self.namespace, self.job_name)
        if job is None:
            return None
        ann = job.metadata.annotations or {}
        req = ann.get(constants.ANNOTATION_CKPT_REQUESTED_VERSION)
        if req is None:
            return None
        done = ann.get(constants.ANNOTATION_CKPT_COMPLETED_VERSION)
        if done is not None and int(done) >= int(req):
            return None
        return int(req)

    def poll_once(self) -> Optional[int]:
        """If a checkpoint is requested and unacknowledged: save and ack.
        Returns the completed generation, or None if nothing was pending."""
        gen = self.pending_request()
        if gen is None:
            return None
        self.save_fn(gen)
        self.cluster.patch_meta(
            self.job_cls, self.namespace, self.job_name,
            annotations={constants.ANNOTATION_CKPT_COMPLETED_VERSION: str(gen)})
        return gen
