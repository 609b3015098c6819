"""Continuous batching: requests join and leave a running decode batch.

Counterpart of ``tpu_on_k8s/models/serving.py``'s ``ContinuousBatchingEngine``
on one device. ``generate`` (``models/decode.py``) serves one batch of
same-length requests; serving traffic is ragged and asynchronous, and a
static batch runs until its longest member finishes. Here:

* The batch dimension is a fixed pool of ``n_slots`` **slots**, each serving
  one request or free. The cache is one ``[n_layers, n_slots, max_len, Hkv,
  Dh]`` pair of tensors read by a ``decode_multislot`` model: each row
  appends at its own position, and a free slot passes the sentinel position
  ``max_len``, whose append writes nothing.
* **Admission** prefills on the ordinary cursor-mode model: prompts pad to
  their 128-token bucket (``decode._bucket_len``), same-bucket arrivals
  prefill together in groups of ``_ADMIT_BATCH_SIZES``, and a fresh prefill
  attends among its own tokens through the flash forward kernel. Each row's
  first token comes from the hidden state at its own last prompt position;
  its first ``lp`` cache positions are then copied into its slot.
* A **step** advances every slot ``step_horizon`` tokens, active or not, and
  returns the tokens to the host once. Retirement is host bookkeeping: the
  next step runs without the request, and its row computes tokens nobody
  reads. Positions and tokens stay on the device for the whole horizon.
* **Prefix caching** (``register_prefix``): a shared prompt is prefilled
  once; a request carrying its id prefills only its own suffix, appended
  after the prefix by the cursor-mode model over the whole cache.
* **Chunked prefill** (``prefill_chunk``): a long prompt prefills one chunk
  per engine step in a private cache while the other slots keep decoding;
  its slot is reserved and admits it when the last chunk lands.
* **Paged KV** (``kv_pages``): the resident cache is a pool of fixed-size
  pages, refcounted so a registered prefix's full pages are aliased into
  every request that carries it (copy-on-write at the block table: a fork
  writes its own fork and suffix pages). A step gathers each slot's block
  table into the same ``[n_slots, max_len]`` view the dense step reads, runs
  the same model, and scatters back only each slot's two tail pages; page 0
  is the null page, zero after every scatter.
* **KV handoff** (disaggregated prefill): ``start_prefill`` runs a
  ``PrefillJob`` through the same prefill calls an admission would make and
  ends in a sealed host ``KVHandoff`` instead of a slot; ``submit_kv`` on
  another engine splices it into a free slot with no prefill at all.
  ``export_kv`` takes a decoding request's accumulated cache the same way
  (migration), and ``export_prefix`` / ``import_prefix`` move a registered
  prefix between engines (paged: aliasing a resident ancestor's pages).
* **Speculative decoding** (``draft_cfg``/``draft_params``): a second,
  small model (``_DraftRunner``) keeps its own dense multislot cache in step
  with the slot pool and proposes ``spec_k`` greedy tokens a slot a round;
  one batched ``[n_slots, spec_k+1]`` forward of the step model verifies
  every slot's chunk, and each slot emits its longest agreeing prefix plus
  the target's own next token. Rejected K/V needs no rollback: a query
  attends only to positions at or below its own, and the next round's
  appends overwrite it first. Slots the draft cannot seed (adopted
  handoffs, imported prefixes) ride the rounds at the sentinel position
  past column 0; a draft crash (``chaos.SITE_SPEC_DRAFT``) degrades the
  engine to the plain step.
* **Learned positions** (the GPT-2 family): the position table is sized
  by ``max_seq_len``, so the engine serves at that length (``max_len`` is
  pinned to it, a longer one refused) and a learned-position draft keeps
  its own table, refused when shorter than the engine's ``max_len``.
* **Metrics and chaos**: ``metrics=`` (``ServingMetrics``),
  ``kv_metrics=`` (``PagedKVMetrics``) and ``spec_metrics=``
  (``SpecMetrics``) are fed where the reference feeds them; ``step()``
  fires ``chaos.SITE_SERVE_STEP`` first.

The reference scans the horizon inside one compiled program and gathers
the paged view as a transient inside it. Run eagerly, the horizon is a
Python loop and the gathered view is one buffer allocated with the engine.

One thread calls ``step``/``run`` (the stepping thread); ``submit``,
``submit_kv`` and ``result`` may come from other threads. A lock
serializes the queues and the slot bookkeeping against the stepping
thread; device work is single-threaded.

With ``cache_int8`` every cache the engine keeps (the slot or page pool,
prefill and prefix caches, the draft's, every host payload) holds int8 K/V
and their fp32 scales: each of them is a set of leaves in the reference's
flatten order, ``k, k_scale, v, v_scale`` (``k, v`` unquantized), and
every copy, gather, scatter, export and checksum runs over all of them.

**Mesh serving** (``mesh=``, a ``parallel/mesh.serving_mesh``; ``rules=``,
default ``serving_partition_rules``): ``_ShardPlan`` holds the layout. The
two models are laid out by ``parallel/sharded.shard_serving_model``
(tensor parallelism over ``model``: a rank runs its H/model query heads and
Hkv/model kv heads, or the heads gathered whole where ``model`` does not
divide them or the rules leave attention whole; the logits are gathered
whole before any token is chosen; FSDP2 over ``fsdp``), every KV cache
holds the rank's kv heads (every kv head where they are not split), and
the dense slot pool puts slots ``[r·S/d, (r+1)·S/d)`` on ``data`` rank r
(the paged pool, and each prefill, run whole on every ``data`` rank). The
engine is the **driver**: all its host state stays here, and every device
program runs through ``_run``, which first sends the command to the mesh's
workers (``parallel/serving.py``), then runs the same program on this
rank's shard. Exports gather every rank's heads to the driver (the full
logical cache, so a payload's checksum is the meshless engine's); imports
put a payload's heads onto each rank, whatever mesh it came from. Sampling
draws on the driver from the gathered logits. ``shard_metrics=``
(``ShardMetrics``) takes the mesh shape and per-chip bytes at construction
and the export-gather bytes; ``shard_report()`` is the same surface as a
dict. ``close()`` releases the workers' shards.
"""
from __future__ import annotations

import copy
import dataclasses
import hashlib
import itertools
import threading
import time
import warnings
import weakref
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.metrics import count_detached_callback
from tpu_on_k8s_torch.models.decode import (
    PAGE_TOKENS,
    CacheShapes,
    _bucket_len,
    _greedy,
    _set_cursor,
    cache_shapes,
    decode_model,
    layer_caches,
    quantize_weights_for_serving,
    zeros_like_shapes,
)
from tpu_on_k8s_torch.models.layouts import CacheLayout
from tpu_on_k8s_torch.models.sampling import SamplingParams, sample
from tpu_on_k8s_torch.models.transformer import (
    KVCache,
    Transformer,
    TransformerConfig,
    serving_partition_rules,
)
from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    mesh_axes,
    mesh_shape,
)
from tpu_on_k8s_torch.parallel.serving import (
    CommandChannel,
    broadcast_from_origin,
    mesh_key,
    payload_specs,
    share_payload,
)
from tpu_on_k8s_torch.parallel.sharded import shard_serving_model


class EngineOverloadedError(RuntimeError):
    """``submit()`` refused: in-flight requests (queued + prefilling +
    decoding) already meet ``queue_cap``. The typed rejection for callers
    that bypass a gateway's bounded admission queue: an unbounded engine
    queue would absorb any burst and melt under it. Carries the saturation
    snapshot for a 429/Retry-After response."""

    def __init__(self, inflight: int, cap: int) -> None:
        super().__init__(f"engine saturated: {inflight} requests in flight "
                         f">= queue_cap {cap}")
        self.inflight = inflight
        self.cap = cap


class EngineCrashError(RuntimeError):
    """The engine died mid-step: every slot's request state is lost (the
    in-process shape of a decode-worker crash). ``reset()`` brings the
    engine itself back, with its models, prefixes and cache pool; whoever
    owns the requests re-admits them. A supervisor translating a real worker
    death raises it so that recovery stays typed."""


@dataclasses.dataclass
class _Slot:
    request_id: int
    pos: int                      # position of the NEXT append (== tokens
                                  # cached so far)
    last_token: int               # emitted but not yet fed back
    emitted: List[int]
    max_new_tokens: int
    eos_id: Optional[int]
    submitted_at: float = 0.0     # submit time on the engine's clock
    on_token: Optional[Callable[[int, int], Any]] = None
    draft: bool = False           # the draft runner holds this slot's
                                  # context (speculative rounds propose
                                  # for it)
    pages: Optional[List[int]] = None   # paged mode: this slot's block
                                  # table (pages[j] backs positions
                                  # [j*page, (j+1)*page)); leading entries
                                  # may alias shared prefix pages


@dataclasses.dataclass
class _Pending:
    request_id: int
    prompt: np.ndarray            # [lp] int32
    max_new_tokens: int
    eos_id: Optional[int]
    submitted_at: float = 0.0
    prefix_id: Optional[int] = None
    on_token: Optional[Callable[[int, int], Any]] = None


@dataclasses.dataclass
class _KVPending:
    """A ``submit_kv`` request waiting for a free slot: its prefill already
    happened elsewhere (the handoff carries the KV), so admission is a
    cache splice and runs no prefill here."""

    request_id: int
    handoff: "KVHandoff"
    max_new_tokens: int
    eos_id: Optional[int]
    prefix_id: Optional[int]
    submitted_at: float = 0.0
    on_token: Optional[Callable[[int, int], Any]] = None


@dataclasses.dataclass
class _KV:
    """A cache as its layer-stacked leaves ``[n_layers, B, length, ...]``,
    named and ordered as ``decode.cache_shapes`` gives them (``k, v``, or
    the int8 cache's ``k, k_scale, v, v_scale``); ``layers()`` gives the
    per-layer ``KVCache`` views a model writes through."""

    leaves: Dict[str, torch.Tensor]

    @property
    def k(self) -> torch.Tensor:
        return self.leaves["k"]

    @property
    def v(self) -> torch.Tensor:
        return self.leaves["v"]

    def layers(self) -> List[KVCache]:
        return layer_caches(self.leaves)

    def pairs(self, other: "_KV"):
        """(this leaf, ``other``'s leaf of the same name), leaf by leaf."""
        return ((t, other.leaves[name]) for name, t in self.leaves.items())


@dataclasses.dataclass
class _Prefilling:
    """A long prompt mid-chunked-prefill: its KV accumulates in a private
    batch-1 cache, one chunk per engine step, while decode continues for
    everyone else; the reserved slot admits it when the last chunk lands."""

    req: _Pending
    pre_cache: int                # handle of the [.., 1, max_len, ..]
                                  # cache accumulating its KV
    base: int                     # prefix length (0 without a prefix_id)
    done: int                     # positions cached so far (incl. prefix)
    total: int                    # base + prompt length
    dequeued_at: float            # left the queue (engine clock)
    pages: Optional[List[int]] = None   # paged mode: the block table
                                  # reserved at dequeue (admission must not
                                  # fail after chunks ran)
    fresh_from: int = 0           # leading entries of ``pages`` that alias
                                  # shared prefix pages


class _PagePool:
    """Host-side allocator for the paged KV pool: fixed-size pages of token
    positions, refcounted so shared-prefix pages can be aliased into many
    slots' block tables (copy-on-write at the block table: a fork writes its
    own fork and suffix pages and only references the shared full-prefix
    pages, so a write past the fork never touches a sibling's bytes).

    Page id 0 is the reserved null page: zero on the device, it backs every
    unallocated block-table entry, so appends past a request's reservation
    land there and are wiped after every scatter. Real pages are handed out
    ascending from a LIFO free stack, so seeded replays see identical page
    placement.

    Lock order: callers hold the engine lock first when they hold both;
    this lock is a leaf."""

    def __init__(self, n_pages: int) -> None:
        if n_pages < 1:
            raise ValueError(f"kv_pages must be >= 1, got {n_pages}")
        self.capacity = n_pages
        # pop() yields 1, 2, 3, ... — ascending first-use order
        self._free: List[int] = list(range(n_pages, 0, -1))
        self._refs = np.zeros(n_pages + 1, np.int32)
        self._lock = threading.Lock()

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.capacity - len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages at refcount 1, or None (all or nothing) when
        the pool cannot supply them: the caller stalls admission."""
        if n == 0:
            return []
        with self._lock:
            if len(self._free) < n:
                return None
            pids = [self._free.pop() for _ in range(n)]
            for p in pids:
                self._refs[p] = 1
            return pids

    def retain(self, pids: List[int]) -> None:
        """Alias already-live pages into another block table."""
        with self._lock:
            for p in pids:
                if self._refs[p] < 1:
                    raise ValueError(f"retain of dead page {p}")
                self._refs[p] += 1

    def release(self, pids: List[int]) -> int:
        """Drop one reference per pid; pages reaching zero return to the
        free stack (in the given order). Returns the count freed."""
        freed = 0
        with self._lock:
            for p in pids:
                if self._refs[p] < 1:
                    raise ValueError(f"release of dead page {p}")
                self._refs[p] -= 1
                if self._refs[p] == 0:
                    self._free.append(p)
                    freed += 1
        return freed


def _zeros(shapes: CacheShapes, device: torch.device) -> _KV:
    return _KV(zeros_like_shapes(shapes, device))


def _resized(shapes: CacheShapes, batch: int, length: int) -> CacheShapes:
    """``shapes`` with their batch and position axes (1 and 2) replaced:
    the paged pool's ``[L, pages, page, ...]`` and a staged row."""
    return {name: ((shape[0], batch, length, *shape[3:]), dtype)
            for name, (shape, dtype) in shapes.items()}


def _prefixed_cache(shapes: CacheShapes, device: torch.device,
                    prefix: Optional[Tuple[_KV, int]]) -> _KV:
    """A zeroed batch-1 cache of ``shapes`` holding a registered prefix's
    positions ``[0, plen)`` when ``prefix`` (its KV and length) is given;
    the prefix's own cache stays untouched."""
    kv = _zeros(shapes, device)
    if prefix is not None:
        pkv, plen = prefix
        for dst, src in kv.pairs(pkv):
            dst[:, :, :plen] = src[:, :, :plen]
    return kv


def multislot_twin(model: Transformer) -> Transformer:
    """The ``decode_multislot`` model over ``model``'s very modules and
    parameters: a shallow copy with its own config and registries (the
    blocks read the mode from each call's ``Positions``). An engine's (and
    a draft's) step model is the twin of its prefill model, so a layout
    applied to one (the blocks' FSDP2 state included) is the other's."""
    twin = copy.copy(model)
    # its own registries over the same objects: a leaf set on one model
    # alone stays its own
    twin._parameters = dict(model._parameters)
    twin._buffers = dict(model._buffers)
    twin._modules = dict(model._modules)
    twin.cfg = dataclasses.replace(model.cfg, decode_multislot=True)
    return twin


def _signature(params: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    return {name: (tuple(t.shape), t.dtype) for name, t in params.items()}


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy: never a view of an engine's cache, also
    when the engine runs on the CPU."""
    return t.to("cpu", copy=True).contiguous()


def _cache_nbytes(cache: Dict[str, torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in cache.values())


def _cache_checksum(cache: Dict[str, torch.Tensor], *meta) -> str:
    """Stable content hash of a host payload plus metadata ints: what lets
    an adopting engine reject a handoff corrupted in transfer instead of
    decoding wrong tokens from it. The bytes are the reference's (its cache
    leaves in flatten order, raw, C order; numpy has no bfloat16, so every
    leaf is hashed as bytes), so a payload carried across from the JAX
    package keeps its digest. A dict flattens in sorted key order there:
    ``k, v``, or ``k, k_scale, v, v_scale`` for the int8 cache. ``meta``
    must hold Python ints: under numpy 2 the ``repr`` of an ``np.int32``
    reads ``np.int32(5)``."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(tuple(meta)).encode())
    for name in sorted(cache):
        h.update(cache[name].contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def _zero_below(leaf: torch.Tensor, base: int) -> torch.Tensor:
    """Zero a host leaf's positions < ``base`` (axis 2, also of a scale
    leaf), in place: a suffix-only handoff transfers nothing the adopting
    engine supplies itself, and its checksum covers exactly the
    transferred bytes."""
    leaf[:, :, :base] = 0
    return leaf


@dataclasses.dataclass
class KVHandoff:
    """A completed prefill's KV, on the host and portable between engines:
    the payload a disaggregated fleet moves from its prefill pool to its
    decode pool.

    ``cache`` is ``{"k": Tensor, "v": Tensor}``, each ``[n_layers, 1, pb,
    Hkv, Dh]`` on the host (an int8 cache's adds ``k_scale`` and
    ``v_scale``, ``[n_layers, 1, pb, Hkv]``), trimmed to the position
    bucket ``pb`` of ``pos`` so payload, copy and checksum bytes scale
    with the request, not the engine's ``max_len``. ``pos`` counts all cached positions;
    ``base`` counts leading positions not carried (a suffix-only handoff:
    the shared prefix named by ``prefix_hash`` is expected resident on the
    adopting engine; its rows here are zero). ``emitted`` holds the tokens
    already produced (at least the prefill's first), so an adopted request
    resumes with its budget intact. ``verify()`` recomputes the transfer
    checksum: a corrupted payload must be rejected, never decoded.
    ``layout`` records the source engine's mesh and the bytes its export
    moved; it is metadata, outside the checksum."""

    cache: Dict[str, torch.Tensor]
    pos: int
    first_token: int
    emitted: Tuple[int, ...]
    base: int = 0
    prefix_hash: Optional[str] = None
    checksum: str = ""
    layout: Optional[CacheLayout] = None

    def seal(self) -> "KVHandoff":
        self.checksum = _cache_checksum(self.cache, self.pos, self.base,
                                        self.emitted)
        return self

    def verify(self) -> bool:
        return self.checksum == _cache_checksum(self.cache, self.pos,
                                                self.base, self.emitted)

    @property
    def nbytes(self) -> int:
        return _cache_nbytes(self.cache)


class _ShardPlan:
    """The engine's layout over a serving mesh (``parallel/mesh.
    serving_mesh``, or any mesh ``check_mesh`` accepts), as the
    reference's ``_ShardPlan``: ``mesh``, its non-trivial ``axes``,
    ``n_chips``, ``n_model``, ``n_data`` and ``n_fsdp``. Every parameter is
    validated against ``rules`` at construction (``partition.
    named_sharding``: a bad rule is a ``ShardingValidationError`` naming
    the path, the dim and the axis, before anything moves), then the
    mesh (``sharded.check_mesh``) and the layout the rules give the
    serving model (``sharded.serving_cuts``).

    ``put_params`` lays a model out (``sharded.shard_serving_model``).
    Caches: every leaf ``[L, B, len, Hkv, ...]`` (k, v, and an int8
    cache's scales) holds this rank's kv heads ``[r·Hkv/m, (r+1)·Hkv/m)``
    on dim 3 where the layout runs kv heads head parallel and ``m``
    divides them (``kv_split``), else every kv head, as the reference's
    ``kv_sharding`` replicates a dim the axis does not divide
    (``kv_shapes``; ``put_cache`` cuts a whole payload's, the
    reshard-on-import half, and ``gather_to_driver`` joins them again for
    an export). The dense slot pool puts slot rows ``[r·S/d, (r+1)·S/d)``
    on ``data`` rank r where d divides S (``rows_on_data``); a decode step
    runs the rank's own rows and ``gather_rows`` joins their tokens. The
    paged pool, prefill caches and registered prefixes are whole over
    ``data`` (and over ``fsdp``). ``bytes_per_chip`` counts what a rank
    really holds."""

    def __init__(self, mesh, params: Dict[str, torch.Tensor], rules,
                 cfg: TransformerConfig, n_slots: int, paged: bool) -> None:
        from tpu_on_k8s_torch.parallel.partition import named_sharding
        from tpu_on_k8s_torch.parallel.sharded import (
            check_mesh,
            serving_layout,
        )
        self.mesh = mesh
        self.rules = tuple(rules)
        named_sharding(params, mesh, self.rules)
        check_mesh(cfg, mesh, serving=True)
        sizes = mesh_shape(mesh)
        #: whether the caches hold this rank's kv heads (else every one)
        self.kv_split = serving_layout(cfg, params, self.rules,
                                       sizes[AXIS_MODEL]).kv_split
        self.axes = mesh_axes(mesh)
        self.n_chips = int(mesh.size())
        self.n_model = sizes[AXIS_MODEL]
        self.n_data = sizes[AXIS_DATA]
        self.n_fsdp = sizes[AXIS_FSDP]
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the engine's mesh")
        names = list(mesh.mesh_dim_names)
        self.is_origin = not any(coord)
        self.model_rank = coord[names.index(AXIS_MODEL)]
        self.data_rank = coord[names.index(AXIS_DATA)]
        self.fsdp_rank = coord[names.index(AXIS_FSDP)]
        self.model_group = mesh[AXIS_MODEL].get_group()
        self.data_group = mesh[AXIS_DATA].get_group()
        self.rows_on_data = (not paged and self.n_data > 1
                             and n_slots % self.n_data == 0)
        n = n_slots // self.n_data if self.rows_on_data else n_slots
        start = self.data_rank * n if self.rows_on_data else 0
        #: this rank's slot rows of the pool
        self.rows = slice(start, start + n)

    @property
    def kv_parts(self) -> int:
        """The ranks the kv heads are split over (1: each holds all)."""
        return self.n_model if self.kv_split else 1

    def kv_shapes(self, shapes: CacheShapes) -> CacheShapes:
        """``shapes`` with dim 3 (kv heads) cut to this rank's."""
        return {name: ((*shape[:3], shape[3] // self.kv_parts, *shape[4:]),
                       dtype)
                for name, (shape, dtype) in shapes.items()}

    def put_params(self, model: Transformer) -> None:
        """Lay a model holding the whole tree out on the mesh, in place
        (``sharded.shard_serving_model``)."""
        shard_serving_model(model, self.mesh, self.rules)

    def put_cache(self, leaves: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """This rank's kv heads of whole cache leaves (views): the
        reshard-on-import half, whatever mesh the leaves came from."""
        out = {}
        for name, t in leaves.items():
            n = t.shape[3] // self.kv_parts
            start = self.model_rank * n if self.kv_split else 0
            out[name] = t.narrow(3, start, n)
        return out

    def owner(self, slot: int) -> int:
        """The ``data`` rank that holds slot ``slot``."""
        if not self.rows_on_data:
            return self.data_rank
        return slot // (self.rows.stop - self.rows.start)

    def local_row(self, slot: int) -> Optional[int]:
        """Slot ``slot``'s row in this rank's pool; None if another
        ``data`` rank holds it."""
        if self.rows.start <= slot < self.rows.stop:
            return slot - self.rows.start
        return None

    def _gather(self, t: torch.Tensor, group, size: int, dim: int
                ) -> torch.Tensor:
        t = t.contiguous()
        parts = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                 for _ in range(size)]
        dist.all_gather([p.view(-1).view(torch.uint8) for p in parts],
                        t.view(-1).view(torch.uint8), group=group)
        return torch.cat(parts, dim=dim)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every slot's values from each ``data`` rank's rows (dim 0)."""
        if not self.rows_on_data:
            return t
        return self._gather(t, self.data_group, self.n_data, 0)

    def gather_to_driver(self, leaves: Optional[Dict[str, torch.Tensor]],
                         full: CacheShapes, src_data: int,
                         device: torch.device
                         ) -> Optional[Dict[str, torch.Tensor]]:
        """The whole heads of cache leaves that the ``data`` rank
        ``src_data`` holds (``leaves``: this rank's heads there; ignored
        elsewhere), on the driver; None on every other rank. The ranks of
        that data row (fsdp 0) gather over ``model``; if the row is not
        the driver's, its first rank sends the result along ``data``."""
        if self.fsdp_rank != 0:
            return None
        out = None
        if self.data_rank == src_data:
            out = {name: (self._gather(t, self.model_group, self.n_model, 3)
                          if self.kv_split else t)
                   for name, t in leaves.items()}
        if src_data != 0 and self.model_rank == 0:
            if out is None:
                out = {name: torch.empty(shape, dtype=dtype, device=device)
                       for name, (shape, dtype) in full.items()}
            src = dist.get_global_rank(self.data_group, src_data)
            for t in out.values():
                dist.broadcast(t.view(-1).view(torch.uint8), src=src,
                               group=self.data_group)
        return out if self.is_origin else None

    @staticmethod
    def bytes_per_chip(tensors) -> int:
        """Bytes of ``tensors`` as this rank holds them (an FSDP2 leaf's
        local shard)."""
        total = 0
        for t in tensors:
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
        return total


class _DraftRunner:
    """The draft half of batched speculative decoding: a second (small)
    model kept in step with the engine's slot pool.

    It owns a dense ``[n_layers, n_slots, max_len, Hkv, Dh]`` multislot
    cache (int8 with its scales when the draft's config, like
    ``truncated_draft``'s copy of the target's, has ``cache_int8``), also
    under a paged engine. Each admission seeds its slot's row
    (``seed``) with a batch-1 draft prefill of the request's whole context,
    never chunked; after a prefix mirrored through ``register_prefix``, a
    prefill of the suffix only. Each round ``propose`` runs ``k+1`` greedy
    multislot steps over every slot. Rows it could not seed (an adopted
    handoff carries no prompt; an imported prefix was never prefilled
    here) ride the rounds at the sentinel position ``max_len``, whose
    appends write nothing, and their proposals are ignored.
    ``fresh_prefills`` counts the prefills that start from an empty cache,
    each of which runs the flash forward kernel once a layer.

    A learned-position draft keeps its table (its ``max_seq_len``), which
    must reach the engine's ``max_len``; its caches are ``max_len`` long all
    the same, so the sentinel's appends write nothing.

    Greedy only (argmax): token identity with plain decode is the
    contract, and sampled speculation needs rejection sampling, which the
    engine does not implement."""

    def __init__(self, cfg: TransformerConfig,
                 params: Dict[str, torch.Tensor], n_slots: int,
                 max_len: int, k: int, device: torch.device) -> None:
        if cfg.pos_emb == "rope":
            base = dataclasses.replace(cfg, max_seq_len=max_len)
        elif cfg.max_seq_len < max_len:
            raise ValueError(
                f"draft max_seq_len {cfg.max_seq_len} < engine max_len "
                f"{max_len} (learned positions cannot extrapolate)")
        else:
            base = cfg
        self._prefill_model = decode_model(base, params, device)
        self._step_model = multislot_twin(self._prefill_model)
        self.device = device
        self.k = k
        self.max_len = max_len
        self.cache = _zeros(cache_shapes(self._step_model, n_slots, max_len),
                            device)
        self.prefixes: Dict[int, Tuple[_KV, int]] = {}  # engine pid → KV
        self.fresh_prefills = 0

    def propose(self, toks: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One draft phase over the whole slot pool, from each row's last
        token ``toks`` at ``pos`` → proposals ``[k, n_slots]`` on the host.
        The ``k+1``-th feed only caches ``d_k`` (a fully accepted round's
        next draft appends right after it), so it skips the head."""
        dev = self.device
        cache = self.cache.layers()
        with torch.inference_mode():
            tok = torch.from_numpy(toks).to(dev)
            p = torch.from_numpy(pos).to(dev)
            out = []
            for _ in range(self.k):
                tok = _greedy(self._step_model(tok[:, None], p[:, None],
                                               cache)[:, -1])
                out.append(tok)
                p = p + 1
            self._step_model.extend_cache(tok[:, None], p[:, None], cache)
            return torch.stack(out).cpu().numpy()

    def _prefill(self, kv: _KV, tokens: np.ndarray, start: int) -> None:
        """Prefill ``tokens`` into ``kv`` after the ``start`` positions it
        holds, padded to their bucket; from ``start == 0`` a fresh
        prefill. Only the cache is wanted, so the head is skipped."""
        n = int(tokens.size)
        bucket = _bucket_len(n, kv.k.shape[2] - start)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = tokens
        dev = self.device
        with torch.inference_mode():
            positions = start + torch.arange(bucket, dtype=torch.int32,
                                             device=dev)[None]
            self._prefill_model.extend_cache(
                torch.from_numpy(padded).to(dev), positions,
                _set_cursor(kv.layers(), start))
        self.fresh_prefills += start == 0

    def _fresh_cache(self, n: int) -> _KV:
        return _zeros(cache_shapes(self._prefill_model, 1,
                                   _bucket_len(n, self.max_len)), self.device)

    def register_prefix(self, pid: int, tokens: np.ndarray) -> None:
        """Prefill a shared prefix through the draft under the engine's
        prefix id, so that admissions carrying it seed their rows too."""
        kv = self._fresh_cache(int(tokens.size))
        self._prefill(kv, tokens, 0)
        self.prefixes[pid] = (kv, int(tokens.size))

    def drop_prefix(self, pid: int) -> None:
        self.prefixes.pop(pid, None)

    def seed(self, slot: int, prompt: np.ndarray,
             prefix_id: Optional[int]) -> bool:
        """Prefill ``prompt`` (the suffix, with ``prefix_id``) through the
        draft and copy its positions ``< lp`` into the draft cache's row
        ``slot``. False when the row cannot be drafted: an
        ``import_prefix`` id the draft never saw; the slot then decodes
        plain."""
        plen = 0
        if prefix_id is not None:
            entry = self.prefixes.get(prefix_id)
            if entry is None:
                return False
            plen = entry[1]
            with torch.inference_mode():
                kv = _prefixed_cache(
                    cache_shapes(self._prefill_model, 1, self.max_len),
                    self.device, entry)
        else:
            kv = self._fresh_cache(int(prompt.size))
        self._prefill(kv, prompt, plen)
        lp = plen + int(prompt.size)
        with torch.inference_mode():
            for dst, src in self.cache.pairs(kv):
                dst[:, slot, :lp] = src[:, 0, :lp]
        return True


class ContinuousBatchingEngine:
    """Slot-pool continuous batching over one model and parameter set.

    ``submit()`` enqueues a request; ``step()`` advances the world by one
    horizon (admitting queued requests into free slots first) and returns
    the requests that finished on it; ``run()`` drains everything. Greedy
    by default; ``temperature > 0`` samples, with random draws from
    ``generator`` (default: seed 0 on ``device``). ``device`` is where the
    engine runs: the card unless the caller asks for the CPU. ``metrics``
    (``tpu_on_k8s_torch.metrics.ServingMetrics``) takes request counters,
    the queue-wait, time-to-first-token and latency histograms and the slot
    and queue gauges; ``kv_metrics`` (``PagedKVMetrics``) the page gauges
    and the allocation, alias and stall counters.

    ``draft_cfg`` and ``draft_params`` (together) make the engine
    speculative: greedy rounds of ``spec_k`` draft proposals a slot and one
    batched verify (``_spec_round``). ``spec_metrics`` (``SpecMetrics``)
    takes their counts; ``on_spec_round(request_ids, draft_s, verify_s,
    proposed, accepted)`` fires after each round, and detaches with a
    warning if it raises.

    ``mesh`` (a ``DeviceMesh`` over the ``torch.distributed`` world, whose
    first rank is this one; every other rank runs ``parallel/serving.
    serve_mesh_worker``) serves on the mesh under ``rules`` (module
    docstring); ``shard_metrics`` (``ShardMetrics``) takes its gauges.
    """

    #: batched-admission prefill sizes (the largest that fits is used); a
    #: bounded set, so the prefill shapes do not proliferate
    _ADMIT_BATCH_SIZES = (4, 2, 1)

    def __init__(self, cfg: TransformerConfig,
                 params: Dict[str, torch.Tensor], n_slots: int = 8,
                 max_len: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, top_p: float = 0.0,
                 generator: Optional[torch.Generator] = None, mesh=None,
                 rules=None, step_horizon: int = 1, metrics=None,
                 int8_weights: bool = False, prefill_chunk: int = 0,
                 queue_cap: Optional[int] = None,
                 on_retire: Optional[Callable[[int, np.ndarray], Any]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 draft_cfg: Optional[TransformerConfig] = None,
                 draft_params: Optional[Dict[str, torch.Tensor]] = None,
                 spec_k: int = 4, spec_metrics=None,
                 on_spec_round: Optional[Callable[..., Any]] = None,
                 shard_metrics=None,
                 kv_pages: int = 0, page_tokens: Optional[int] = None,
                 kv_metrics=None, device: str | torch.device = "cuda",
                 _worker: bool = False):
        if step_horizon < 1:
            raise ValueError(f"step_horizon must be >= 1, got {step_horizon}")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError(f"queue_cap must be >= 1, got {queue_cap}")
        if prefill_chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got "
                             f"{prefill_chunk}")
        from torch.distributed.device_mesh import DeviceMesh
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a torch DeviceMesh "
                            f"(parallel.mesh.serving_mesh), got "
                            f"{type(mesh).__name__}")
        if rules is not None and mesh is None:
            raise ValueError("rules= lays the parameters out on a mesh: "
                             "pass mesh= too")
        if shard_metrics is not None and not hasattr(shard_metrics,
                                                     "set_mesh_axes"):
            raise TypeError(f"shard_metrics= takes a metrics.ShardMetrics, "
                            f"got {type(shard_metrics).__name__}")
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot serve on "
                             f"{self.device}")
        if int8_weights:
            cfg = dataclasses.replace(cfg, serve_int8_weights=True)
            params = quantize_weights_for_serving(params)
        self.metrics = metrics
        self.kv_metrics = kv_metrics
        #: every queue/slot timestamp (submitted_at, dequeued_at, the
        #: metrics' observations) reads THIS clock, so seeded replays on a
        #: virtual clock are wall-time-free
        self._clock = clock
        max_len = max_len or cfg.max_seq_len
        if cfg.pos_emb != "rope":
            if max_len > cfg.max_seq_len:
                raise ValueError("max_len beyond the trained table needs "
                                 "rope")
            # a learned position table is sized by max_seq_len: the engine
            # serves at the trained length
            max_len = cfg.max_seq_len
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        # ---- paged KV pool configuration ------------------------------
        if kv_pages < 0:
            raise ValueError(f"kv_pages must be >= 0, got {kv_pages}")
        #: tokens per KV page. Defaults to the position-bucket granule
        #: (``decode.PAGE_TOKENS``) so pages and buckets coincide; tiny
        #: configs (max_len < PAGE_TOKENS) shrink it to max_len, and an
        #: explicit override must keep the alignment: every prefill bucket
        #: is a PAGE_TOKENS multiple or max_len itself.
        page = (page_tokens if page_tokens is not None
                else min(PAGE_TOKENS, max_len))
        if kv_pages:
            if page < 1 or max_len % page != 0:
                raise ValueError(f"page_tokens {page} must divide max_len "
                                 f"{max_len}")
            if max_len > PAGE_TOKENS and PAGE_TOKENS % page != 0:
                raise ValueError(
                    f"page_tokens {page} must divide the position bucket "
                    f"granule {PAGE_TOKENS} (prefill buckets are its "
                    f"multiples; a non-dividing page would misalign them)")
            if step_horizon > page:
                raise ValueError(
                    f"step_horizon {step_horizon} exceeds page_tokens "
                    f"{page}: a horizon's appends must span at most two "
                    f"pages (the scatter-back window)")
        self.page_tokens = page
        self._nb_total = max_len // page if kv_pages else 0
        #: > 0: prompts longer than this prefill one chunk per engine step
        #: (in a private cache; the slot admits when the last chunk lands),
        #: so decode for the other slots continues between chunks. Chunks
        #: pad to PAGE_TOKENS prefill buckets, so at production lengths the
        #: chunk rounds up to a bucket multiple.
        if prefill_chunk and max_len > PAGE_TOKENS:
            prefill_chunk = -(-prefill_chunk // PAGE_TOKENS) * PAGE_TOKENS
        self.prefill_chunk = prefill_chunk
        self.sampling = SamplingParams(temperature=temperature,
                                       top_k=top_k, top_p=top_p)
        self._generator = (generator if generator is not None else
                           torch.Generator(device=self.device).manual_seed(0))
        self.step_horizon = step_horizon
        speculative = draft_cfg is not None or draft_params is not None
        if speculative:
            if draft_cfg is None or draft_params is None:
                raise ValueError("draft_cfg and draft_params come together")
            if step_horizon != 1:
                raise ValueError(
                    "speculative decoding replaces the step horizon (each "
                    "round already runs k draft steps); use step_horizon=1")
            if not self.sampling.is_greedy:
                raise ValueError(
                    "speculative decoding is greedy-only: token identity "
                    "with plain decode is the correctness contract, and "
                    "sampled acceptance needs rejection sampling")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            if kv_pages and spec_k + 1 > page:
                raise ValueError(
                    f"spec_k + 1 ({spec_k + 1}) exceeds page_tokens {page}: "
                    f"a verify chunk's appends must span at most two pages "
                    f"(the scatter-back window)")
        plan: Optional[_ShardPlan] = None
        self._channel: Optional[CommandChannel] = None
        if mesh is not None:
            if rules is None:
                rules = serving_partition_rules(int8=cfg.serve_int8_weights)
            plan = _ShardPlan(mesh, params, rules, cfg, n_slots,
                              bool(kv_pages))
            if not _worker:
                if not plan.is_origin:
                    raise ValueError("the engine's driver is the first "
                                     "rank of its mesh")
                self._channel = CommandChannel.of_world(dist.get_rank())
        self.mesh = mesh
        self._plan = plan
        self._worker = _worker
        #: {axis: size} of the mesh's non-trivial axes: {} without a mesh
        #: (the replica's sharding signature, the layout every export
        #: carries)
        self.mesh_axes: Dict[str, int] = dict(plan.axes) if plan else {}
        self.n_chips = plan.n_chips if plan else 1
        #: the grad mode of every device program: FSDP2's gather does not
        #: run under inference mode
        self._mode = (torch.no_grad if plan is not None and plan.n_fsdp > 1
                      else torch.inference_mode)
        #: every device cache but the pool, by handle: prefill outputs,
        #: private (suffix and chunked) caches, registered prefixes; the
        #: workers keep theirs under the same handles
        self._kvs: Dict[int, _KV] = {}
        self._handles = itertools.count()
        #: the tree as the caller handed it (prepared): what
        #: ``replace_params`` checks a new tree against and hands back, and
        #: the total the shard report counts. On a mesh the models hold
        #: this rank's blocks of a device copy, and the copy's whole
        #: tensors are not kept
        self._params = None if _worker else params
        if self._channel is not None:
            self._eid = self._channel.new_engine_id()
            specs = payload_specs(params)
            self._channel.send(self._eid, "init", dict(
                mesh=mesh_key(mesh),
                spec=dict(cfg=cfg, n_slots=n_slots, max_len=max_len,
                          temperature=temperature, top_k=top_k, top_p=top_p,
                          step_horizon=step_horizon,
                          prefill_chunk=prefill_chunk, kv_pages=kv_pages,
                          page_tokens=page_tokens, rules=rules)), specs)
            params = share_payload(mesh, self.device, params, specs)
            # a garbage-collected engine releases its workers' shards at
            # the next command; ``close()`` does it at once
            self._finalizer = weakref.finalize(
                self, self._channel.defer, "close", self._eid)
        self._load(params)

        self._cache: Optional[_KV] = None
        self._pool: Optional[_PagePool] = None
        self._pool_cache: Optional[_KV] = None
        if kv_pages:
            # every KV tensor becomes [L, P, page, ...]: the page axis where
            # the dense pool has slots, the position axis cut to one page.
            # P = kv_pages + 1: page id 0 is the null page.
            self._pool = _PagePool(kv_pages)
            self._pool_cache = _zeros(
                _resized(self._shapes(1), kv_pages + 1, page), self.device)
            #: the [L, n_slots, max_len, ...] view every paged step gathers
            #: the block tables into and decodes over
            self._view = _zeros(self._shapes(n_slots), self.device)
            #: per-slot block tables, host-resident (int32 page ids; 0 =
            #: unallocated → the null page). One small copy per step.
            self._tables = np.zeros((n_slots, self._nb_total), np.int32)
            self._prefix_pages: Dict[int, List[int]] = {}
            if kv_metrics is not None:
                kv_metrics.set_gauge("pages_total", self._pool.capacity)
                kv_metrics.set_gauge("pages_in_use", 0)
        else:
            rows = (plan.rows.stop - plan.rows.start) if plan else n_slots
            self._cache = _zeros(self._shapes(rows), self.device)
        #: prefix id → (cache handle, length)
        self._prefixes: Dict[int, Tuple[int, int]] = {}
        self._next_prefix_id = 0
        self.spec_metrics = spec_metrics
        self._on_spec_round = on_spec_round
        self._spec_k = spec_k
        self._draft: Optional[_DraftRunner] = (
            _DraftRunner(draft_cfg, draft_params, n_slots, max_len, spec_k,
                         self.device) if speculative else None)
        #: True on paged engines: ``import_prefix`` takes ``base_pid`` and
        #: ``base_len`` and aliases the ancestor's full pages; the fleet
        #: prefix store takes its page-aliasing promote on this
        self.supports_page_alias = bool(kv_pages)

        self._slots: List[Optional[_Slot]] = [None] * n_slots
        self._queue: deque[_Pending] = deque()
        self._kv_queue: deque[_KVPending] = deque()
        self._next_id = 0
        self._finished: Dict[int, np.ndarray] = {}
        self._prefilling: Optional[_Prefilling] = None
        self._reserved_slot: Optional[int] = None
        self._admitting: set = set()   # slots mid-admission (popped from
                                       # the queue, prefill in flight):
                                       # free_slots must not count them
        self.stats = {"steps": 0, "emitted": 0, "admitted": 0, "crashes": 0,
                      # prefill accounting: padded positions run through
                      # prefills, how many of those calls were shared-prefix
                      # registrations, and how many started from an empty
                      # cache (the calls that run the flash forward kernel)
                      "prefill_positions": 0, "prefix_prefills": 0,
                      "fresh_prefills": 0,
                      # KV handoffs adopted (``submit_kv``) and exported
                      # (``export_kv``), and the device-to-host bytes every
                      # KV or prefix export moved
                      "kv_adopted": 0, "kv_exported": 0,
                      "export_gather_bytes": 0,
                      # admission copy traffic, in cache POSITIONS: dense
                      # admissions copy the request's cached span into the
                      # pool; paged admissions copy only freshly written
                      # pages (aliased prefix pages move a reference)
                      "admit_copy_positions": 0,
                      # paged mode: pages allocated / aliased over the
                      # engine's lifetime, and admissions stalled on an
                      # exhausted pool (the request stays queued)
                      "pages_allocated": 0, "pages_aliased": 0,
                      "admission_stalls": 0,
                      # parameter swaps applied (``replace_params``)
                      "param_swaps": 0,
                      # speculative decoding: rounds run, draft tokens
                      # proposed and accepted, slot-rounds with at least one
                      # rejection, draft crashes (degradations to the plain
                      # step), and the seconds of the draft and verify
                      # phases on the engine's clock
                      "spec_rounds": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "spec_rollbacks": 0,
                      "draft_crashes": 0,
                      "spec_draft_s": 0.0, "spec_verify_s": 0.0}
        #: hard bound on requests in flight (queued + prefilling + slots);
        #: ``submit`` past it raises ``EngineOverloadedError``. None keeps an
        #: unbounded queue.
        self.queue_cap = queue_cap
        #: ``on_retire(request_id, tokens)`` fires (outside the lock) the
        #: moment a request finishes, during ``step()`` or mid-admission. A
        #: raising callback detaches with a warning.
        self._on_retire = on_retire
        self._lock = threading.Lock()
        #: optional ``metrics.ShardMetrics``: the mesh-shape gauges and the
        #: per-chip bytes here, the export-gather bytes at every export
        self.shard_metrics = shard_metrics
        if shard_metrics is not None:
            shard_metrics.set_mesh_axes(self.mesh_axes)
            shard_metrics.set_gauge("param_bytes_per_chip",
                                    self.param_bytes_per_chip)
            shard_metrics.set_gauge("kv_bytes_per_chip",
                                    self.kv_bytes_per_chip)

    @classmethod
    def _as_mesh_worker(cls, spec: dict, mesh, specs
                        ) -> "ContinuousBatchingEngine":
        """A worker's half of a driver's engine (``parallel/serving.
        serve_mesh_worker``): the parameters come from the driver."""
        dev = torch.device(mesh.device_type)
        params = share_payload(mesh, dev, None, specs)
        return cls(params=params, mesh=mesh, device=dev, _worker=True,
                   **spec)

    # ---- the device programs and their command channel ---------------------
    def _run(self, op: str, payload: Optional[Dict[str, torch.Tensor]] = None,
             **args):
        """Run device program ``_p_<op>`` with host ``args`` (and a tensor
        ``payload``): on a mesh the command goes to the workers first and
        the payload to every rank, then the program runs on this rank's
        shard. Host validation happens before this call, so a worker never
        waits in a collective the driver will not enter."""
        if self.mesh is not None and self._channel is None \
                and not self._worker:
            raise RuntimeError("the engine is closed")
        if self._channel is not None:
            specs = payload_specs(payload) if payload is not None else ()
            self._channel.send(self._eid, op, args, specs)
            if payload is not None:
                payload = share_payload(self.mesh, self.device, payload,
                                        specs)
        if payload is not None:
            args["payload"] = payload
        return getattr(self, f"_p_{op}")(**args)

    def _serve_command(self, op: str, args: dict, specs) -> None:
        """A worker runs the driver's command on its shard."""
        if specs:
            args = dict(args, payload=share_payload(
                self.mesh, self.device, None, specs))
        getattr(self, f"_p_{op}")(**args)

    def _new_handle(self) -> int:
        return next(self._handles)

    def _free(self, h: Optional[int]) -> None:
        """Drop a device cache here and, at the next command, on the
        workers."""
        if h is None:
            return
        self._kvs.pop(h, None)
        if self._channel is not None:
            self._channel.defer("free", self._eid, h)

    def _shapes(self, batch: int, length: Optional[int] = None
                ) -> CacheShapes:
        """The leaves of a cache as this rank holds them: its kv heads."""
        shapes = cache_shapes(self._prefill_model, batch, length)
        return self._plan.kv_shapes(shapes) if self._plan else shapes

    def close(self) -> None:
        """Release the workers' shards of this engine (on a mesh; nothing
        to do without one). The engine serves no more afterwards."""
        if self._channel is not None:
            self._finalizer.detach()
            self._channel.send(self._eid, "close")
            self._channel = None

    def _load(self, params: Dict[str, torch.Tensor]) -> None:
        """Build the two models around ``params``: the cursor-mode prefill
        model (tensors already in ``cfg.dtype`` on the device are used as
        they are) and its multislot twin, laid out on the mesh when there
        is one."""
        base = (dataclasses.replace(self.cfg, max_seq_len=self.max_len)
                if self.cfg.pos_emb == "rope" else self.cfg)
        prefill = decode_model(base, params, self.device)
        if self._plan is not None:
            self._plan.put_params(prefill)
            if self._plan.n_fsdp > 1:
                # each block is its own FSDP2 root, which keeps its
                # gathered weights after a forward: give them back
                for block in prefill.blocks:
                    block.register_forward_hook(
                        lambda m, args, out: m.reshard())
        self._step_model = multislot_twin(prefill)
        self._prefill_model = prefill

    def _p_load(self, payload: Dict[str, torch.Tensor]) -> None:
        self._load(payload)

    # ---- model hot-swap ----------------------------------------------------
    def replace_params(self, params: Dict[str, torch.Tensor], *,
                       quantized: bool = False) -> Dict[str, torch.Tensor]:
        """Swap the serving parameters for a tree of the same names, shapes
        and dtypes (the int8 conversion runs first on an ``int8_weights``
        engine unless ``quantized``). A mismatch raises before anything is
        touched, and so does a busy engine (queued, prefilling or in-slot
        requests): a mid-request swap would splice two models into one
        decode stream. A speculative engine refuses: the swap would desync
        the draft from the target. Returns the previous tree."""
        if self._draft is not None:
            raise ValueError(
                "replace_params on a speculative engine would desync the "
                "draft from the target; model pools run plain engines")
        if self.cfg.serve_int8_weights and not quantized:
            params = quantize_weights_for_serving(params)
        old, new = _signature(self._params), _signature(params)
        if set(new) != set(old):
            raise ValueError(
                f"replace_params: tree structure mismatch (names "
                f"{sorted(set(new) ^ set(old))} differ) — a swap takes a "
                f"same-config tree only")
        for name, sig in new.items():
            if sig != old[name]:
                raise ValueError(
                    f"replace_params: leaf mismatch {name} {sig} vs "
                    f"{old[name]} — same config shape is the swap contract")
        with self._lock:
            if (self._queue or self._prefilling is not None
                    or self._admitting
                    or any(s is not None for s in self._slots)):
                raise RuntimeError(
                    "replace_params on a busy engine: drain in-flight "
                    "requests first")
            prev = self._params
            # on a mesh: the new tree to every rank, laid out as the old
            self._run("load", payload=params)
            self._params = params
            self.stats["param_swaps"] += 1
        return prev

    # ---- paged-pool helpers ------------------------------------------------
    def _pages_for_span(self, end: int) -> int:
        """Block-table entries needed to back positions [0, end)."""
        return -(-end // self.page_tokens)

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """``n`` fresh pages, or None (a counted stall: the request stays
        queued and retries next step as pages free up)."""
        pids = self._pool.alloc(n)
        if pids is None:
            self.stats["admission_stalls"] += 1
            if self.kv_metrics is not None:
                self.kv_metrics.inc("admission_stalls")
            return None
        self._count_allocs(pids)
        return pids

    def _count_allocs(self, pids: List[int]) -> None:
        if pids:
            self.stats["pages_allocated"] += len(pids)
            if self.kv_metrics is not None:
                self.kv_metrics.inc("page_allocs", len(pids))

    def _alias_pages(self, pids: List[int]) -> List[int]:
        """Reference shared pages into another block table: the copy-free
        half of every prefix-seeded paged admission."""
        self._pool.retain(pids)
        if pids:
            self.stats["pages_aliased"] += len(pids)
            if self.kv_metrics is not None:
                self.kv_metrics.inc("pages_aliased", len(pids))
        return list(pids)

    def _update_page_gauges(self) -> None:
        if self.kv_metrics is not None and self._pool is not None:
            self.kv_metrics.set_gauge("pages_in_use", self._pool.in_use)

    @property
    def pages_in_use(self) -> int:
        """Pool pages held by slots and registered prefixes (0 on a dense
        engine): 0 once every request retired and every prefix dropped."""
        return self._pool.in_use if self._pool is not None else 0

    def null_page_is_zero(self) -> bool:
        """Whether page 0, which unallocated blocks read, holds only zeros
        (True on a dense engine). Reads the pool: one host sync."""
        if self._pool_cache is None:
            return True
        return not any(t[:, 0].any()
                       for t in self._pool_cache.leaves.values())

    def _release_pages(self, pages: Optional[List[int]]) -> None:
        if self._pool is not None and pages:
            self._pool.release(pages)

    def _prefix_alias_blocks(self, prefix_id: Optional[int],
                             plen: int) -> List[int]:
        """The shared FULL pages of a registered prefix (every block below
        the fork block ``plen // page``), which an admission aliases instead
        of copying. Empty when the prefix holds no page record (the pool was
        exhausted at registration): the admission then writes every block
        fresh, exactly as correct, without the sharing."""
        if prefix_id is None or self._pool is None:
            return []
        pids = self._prefix_pages.get(prefix_id, [])
        fb = plen // self.page_tokens
        return list(pids[:fb]) if len(pids) >= fb else []

    def _write_pages(self, kv: _KV, row: int,
                     pids_by_block: np.ndarray) -> None:
        """Copy the blocks of row ``row`` of a prefill cache into the pool
        pages ``pids_by_block [nb]`` names (0 = skip)."""
        blocks = np.flatnonzero(pids_by_block)
        if blocks.size == 0:
            return
        dev = self.device
        js = torch.from_numpy(blocks).to(dev)
        pids = torch.from_numpy(pids_by_block[blocks].astype(np.int64)).to(dev)
        with self._mode():
            for pool, pre in self._pool_cache.pairs(kv):
                pool[:, pids] = pre[:, row].unflatten(
                    1, (-1, self.page_tokens))[:, js]

    def _p_write_pages(self, h: int, row: int,
                       pids_by_block: np.ndarray) -> None:
        self._write_pages(self._kvs[h], row, pids_by_block)

    def _table_row(self, pages: Optional[List[int]]) -> np.ndarray:
        row = np.zeros(self._nb_total, np.int32)
        if pages:
            row[:len(pages)] = pages
        return row

    def _tail_args(self, tables: np.ndarray, pos: np.ndarray, span: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-slot tail blocks and their page ids ``[n_slots, 2]`` for a
        step appending ``span`` positions from each slot's ``pos``: the at
        most two blocks the appends can touch (span <= page, validated).
        Sentinel rows (free slots) and unallocated blocks resolve to page 0:
        their writes land in the null page, which is wiped."""
        nb, page = self._nb_total, self.page_tokens
        b0 = np.clip(pos // page, 0, nb - 1)
        b1 = np.clip((pos + span - 1) // page, 0, nb - 1)
        blocks = np.stack([b0, b1], axis=1).astype(np.int32)
        pids = np.take_along_axis(tables, blocks, axis=1)
        sentinel = pos >= self.max_len
        blocks[sentinel] = 0
        pids[sentinel] = 0
        return blocks, pids

    def _gather_view(self, tables: np.ndarray) -> None:
        """Fill the step's ``[L, n_slots, max_len, ...]`` view from the
        pool through the block ``tables`` (unallocated blocks read the null
        page's zeros; positions past a slot's cursor are never attended
        either way)."""
        flat = torch.from_numpy(tables.reshape(-1).astype(np.int64))
        flat = flat.to(self.device)
        for pool, view in self._pool_cache.pairs(self._view):
            torch.index_select(pool, 1, flat,
                               out=view.view(pool.shape[0], -1,
                                             *pool.shape[2:]))

    def _scatter_tails(self, tables: np.ndarray, pos: np.ndarray,
                       span: int) -> None:
        """Scatter each slot's two tail pages of the view back to the pool
        (the blocks that ``span`` appends from ``pos`` can touch), then zero
        the null page. Every other gathered page is unchanged private data
        or a shared prefix page below the fork, which appends never reach.
        Duplicate ids carry identical bytes (one block twice) or hit the
        null page, so the scatter is order-insensitive."""
        blocks, pids = self._tail_args(tables, pos, span)
        dev = self.device
        rows = torch.arange(self.n_slots, device=dev)[:, None]
        blocks = torch.from_numpy(blocks.astype(np.int64)).to(dev)
        pids = torch.from_numpy(pids.reshape(-1).astype(np.int64)).to(dev)
        for pool, view in self._pool_cache.pairs(self._view):
            tails = view.unflatten(2, (self._nb_total, self.page_tokens))
            pool[:, pids] = tails[:, rows, blocks].flatten(1, 2)
            pool[:, 0].zero_()

    # ---- prefill calls -----------------------------------------------------
    def _prefill(self, prompts: np.ndarray, lps: np.ndarray
                 ) -> Tuple[int, torch.Tensor]:
        """Prefill ``b`` same-bucket prompts ``[b, bucket]`` (true lengths
        ``lps [b]``) in one call of the cursor-mode model, into a fresh
        cache of the bucket's length (``_p_prefill``). Returns the cache's
        handle and each row's first token, sampled from the hidden state at
        its own ``lp - 1``."""
        b, bucket = prompts.shape
        h = self._new_handle()
        logits = self._run("prefill", h=h, prompts=prompts, lps=lps)
        with self._mode():
            first = sample(logits, self._generator, self.sampling)
        self.stats["fresh_prefills"] += 1
        self.stats["prefill_positions"] += bucket * b
        return h, first

    def _p_prefill(self, h: int, prompts: np.ndarray, lps: np.ndarray
                   ) -> torch.Tensor:
        """An empty cache and ``arange`` positions take the among-prompt
        branch, which runs the flash forward kernel. Returns each row's
        last-position logits ``[b, V]``."""
        b, bucket = prompts.shape
        dev = self.device
        with self._mode():
            kv = self._kvs[h] = _zeros(self._shapes(b, bucket), dev)
            positions = torch.arange(bucket, dtype=torch.int32,
                                     device=dev).expand(b, bucket)
            return self._prefill_model(
                torch.from_numpy(prompts).to(dev), positions, kv.layers(),
                at=torch.from_numpy(lps - 1).to(dev))[:, -1]

    def _private_cache(self, prefix_id: Optional[int]) -> int:
        """A batch-1 cache at ``max_len`` for a suffix or chunked prefill,
        holding the registered prefix's positions when ``prefix_id`` is
        given (``_prefixed_cache``); returns its handle."""
        h = self._new_handle()
        self._run("private", h=h, prefix=(
            None if prefix_id is None else self._prefixes[prefix_id]))
        return h

    def _p_private(self, h: int, prefix: Optional[Tuple[int, int]]) -> None:
        with self._mode():
            self._kvs[h] = _prefixed_cache(
                self._shapes(1), self.device,
                None if prefix is None else (self._kvs[prefix[0]],
                                             prefix[1]))

    def _append_prefill(self, h: int, tokens: np.ndarray,
                        start: int) -> torch.Tensor:
        """Prefill ``tokens`` (a suffix or a chunk) into cache ``h`` after
        the ``start`` positions it already holds, in place
        (``_p_append``). Returns the token sampled at the last real
        position."""
        logits = self._run("append", h=h, tokens=tokens, start=start)
        with self._mode():
            first = sample(logits, self._generator, self.sampling)
        if start == 0:
            self.stats["fresh_prefills"] += 1
        self.stats["prefill_positions"] += _bucket_len(
            int(tokens.size), self.max_len - start)
        return first

    def _p_append(self, h: int, tokens: np.ndarray, start: int
                  ) -> torch.Tensor:
        """The cursor set to ``start`` (``_set_cursor``), positions ``start
        + arange(bucket)``: from ``start > 0`` every query attends over the
        whole cache, prefix included; from an empty cache it is a fresh
        prefill. The bucket may not spill past max_len (appends land at
        start..start+bucket-1). Returns the last real position's logits."""
        n = int(tokens.size)
        bucket = _bucket_len(n, self.max_len - start)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = tokens
        dev = self.device
        with self._mode():
            positions = start + torch.arange(bucket, dtype=torch.int32,
                                             device=dev)[None]
            return self._prefill_model(
                torch.from_numpy(padded).to(dev), positions,
                _set_cursor(self._kvs[h].layers(), start),
                at=torch.full((1,), n - 1, device=dev))[:, -1]

    # ---- request lifecycle -------------------------------------------------
    def register_prefix(self, tokens) -> int:
        """Prefill a shared prefix (a system prompt) once and keep its KV on
        the device; requests submitted with the returned id attend to it
        without recomputing it, and each admission prefills only its own
        suffix. RoPE positions are absolute, so the prefix KV (at positions
        [0, len)) is valid under every continuation. Costs one batch-1
        cache of the prefix's bucket for the engine's lifetime (and, paged,
        its full pages in the pool)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("empty prefix")
        if tokens.size > self.max_len - 2:
            # every request needs >= 1 prompt token and >= 1 new token on
            # top of the prefix: a longer prefix could never be used
            raise ValueError(f"prefix {tokens.size} leaves no room under "
                             f"max_len {self.max_len}")
        lp = int(tokens.size)
        padded = np.zeros((1, _bucket_len(lp, self.max_len)), np.int32)
        padded[0, :lp] = tokens
        h, _ = self._prefill(padded, np.asarray([lp], np.int32))
        self.stats["prefix_prefills"] += 1
        with self._lock:
            pid = self._next_prefix_id
            self._next_prefix_id += 1
            self._prefixes[pid] = (h, lp)
        if self._pool is not None:
            # paged: ALSO write the prefix's full pages into the pool so
            # admissions alias them (refcount, not copy). The partial tail
            # block stays only in the prefix's own cache: each fork writes
            # its own fork page.
            fb = lp // self.page_tokens
            pids = (self._pool.alloc(fb) if fb else []) or []
            if pids:
                self._count_allocs(pids)
                self._run("write_pages", h=h, row=0,
                          pids_by_block=self._table_row(pids))
            self._prefix_pages[pid] = pids
            self._update_page_gauges()
        if self._draft is not None:
            # mirrored through the draft, so that admissions carrying the
            # prefix seed their draft rows too
            self._draft.register_prefix(pid, tokens)
        return pid

    def export_prefix(self, prefix_id: int
                      ) -> Tuple[Dict[str, torch.Tensor], int]:
        """Host copy of a registered prefix's KV: ``(payload, length)``,
        the payload's leaves (``KVHandoff.cache``'s) trimmed to the
        prefix's position bucket, what another engine adopts through
        ``import_prefix`` without recomputing the prefill."""
        with self._lock:
            h, lp = self._prefixes[prefix_id]
        host = self._run("export", h=h, pb=_bucket_len(lp, self.max_len))
        self._export_layout(_cache_nbytes(host))
        return host, lp

    def import_prefix(self, cache: Dict[str, torch.Tensor], lp: int,
                      base_pid: Optional[int] = None,
                      base_len: int = 0) -> int:
        """Register an already computed prefix KV (an ``export_prefix``
        payload of a same-config engine) without running a prefill: a
        host-to-device copy instead of compute. Returns the new prefix id.

        On a paged engine, ``base_pid`` / ``base_len`` name a registered
        ancestor of ``base_len`` positions that this prefix extends: the
        ancestor's full pages are aliased into the new prefix's page record
        instead of written again. When the pool is short, the prefix is
        recorded without pages: it still serves through its own cache, and
        admissions write every block."""
        lp = int(lp)
        if lp < 1 or lp > self.max_len - 2:
            raise ValueError(f"prefix length {lp} does not fit under "
                             f"max_len {self.max_len}")
        self._check_payload(cache, lp)
        h = self._new_handle()
        self._run("import", h=h, payload={
            name: cache[name] for name in cache_shapes(self._prefill_model,
                                                       1)})
        with self._lock:
            pid = self._next_prefix_id
            self._next_prefix_id += 1
            self._prefixes[pid] = (h, lp)
        if self._pool is not None:
            fb = lp // self.page_tokens
            aliased: List[int] = []
            if base_pid is not None and 0 < base_len <= lp:
                ab = min(base_len // self.page_tokens, fb)
                src = self._prefix_pages.get(base_pid, [])
                if ab and len(src) >= ab:
                    aliased = self._alias_pages(src[:ab])
            fresh_n = fb - len(aliased)
            fresh = self._pool.alloc(fresh_n) if fresh_n else []
            if fresh is None:
                self._release_pages(aliased)
                pids: List[int] = []
            else:
                if fresh:
                    self._count_allocs(fresh)
                    row = np.zeros(self._nb_total, np.int32)
                    row[len(aliased):fb] = fresh
                    self._run("write_pages", h=h, row=0, pids_by_block=row)
                pids = aliased + fresh
            self._prefix_pages[pid] = pids
            self._update_page_gauges()
        return pid

    def _p_import(self, h: int, payload: Dict[str, torch.Tensor]) -> None:
        """A whole payload's leaves as cache ``h``: this rank's heads."""
        with self._mode():
            heads = self._plan.put_cache(payload) if self._plan else payload
            self._kvs[h] = _KV({name: t.to(self.device).contiguous()
                                for name, t in heads.items()})

    def _p_export(self, h: int, pb: int
                  ) -> Optional[Dict[str, torch.Tensor]]:
        """Positions ``[0, pb)`` of batch-1 cache ``h`` as a host payload
        on the driver (every rank's heads gathered; None on a worker)."""
        kv = self._kvs[h]
        leaves = {name: t[:, :, :pb] for name, t in kv.leaves.items()}
        return self._to_driver(leaves, pb, 0)    # whole on every data rank

    def _to_driver(self, leaves: Optional[Dict[str, torch.Tensor]], pb: int,
                   src_data: int) -> Optional[Dict[str, torch.Tensor]]:
        """Batch-1 leaves of ``pb`` positions, as this rank holds them on
        ``data`` rank ``src_data``, whole on the driver's host."""
        if self._plan is not None:
            leaves = self._plan.gather_to_driver(
                leaves, cache_shapes(self._prefill_model, 1, pb), src_data,
                self.device)
        if leaves is None:
            return None
        return {name: _to_host(t) for name, t in leaves.items()}

    def _check_payload(self, cache: Dict[str, torch.Tensor],
                       positions: int) -> None:
        """A host payload from outside must hold this engine's cache leaves
        (``k, v``, or ``k, k_scale, v, v_scale`` with ``cache_int8``), each
        of its shape and dtype, holding at least ``positions`` positions
        on axis 2."""
        shapes = cache_shapes(self._prefill_model, 1)
        if set(cache) != set(shapes):
            raise ValueError(f"payload leaves {sorted(cache)} do not fit "
                             f"this engine's cache leaves {sorted(shapes)}")
        for name, (shape, dtype) in shapes.items():
            t = cache[name]
            fits = (t.dim() == len(shape) and t.dtype == dtype
                    and t.shape[:2] == shape[:2] and t.shape[3:] == shape[3:]
                    and positions <= t.shape[2] <= self.max_len)
            if not fits:
                want = [*shape[:2], f"{positions}..{self.max_len}",
                        *shape[3:]]
                raise ValueError(
                    f"payload {name} {tuple(t.shape)} {t.dtype} does not fit "
                    f"this engine's [{', '.join(map(str, want))}] {dtype} "
                    f"cache")

    def drop_prefix(self, prefix_id: int) -> bool:
        """Release a registered prefix's KV. The caller owns the invariant
        that no queued or in-flight request still references the id."""
        if self._draft is not None:
            self._draft.drop_prefix(prefix_id)
        if self._pool is not None:
            # refcounted: slots still aliasing these pages keep them live
            # until they retire; only the prefix's own reference drops here
            self._release_pages(self._prefix_pages.pop(prefix_id, None))
            self._update_page_gauges()
        with self._lock:
            entry = self._prefixes.pop(prefix_id, None)
        if entry is None:
            return False
        self._free(entry[0])
        return True

    def check_request(self, prompt, max_new_tokens: int,
                      prefix_id: Optional[int] = None) -> np.ndarray:
        """Validate a request against this engine's limits without
        enqueueing it; returns the coerced int32 prompt. ``submit`` enforces
        its invariants through this, and a gateway may call it at its own
        admission."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        plen = 0
        if prefix_id is not None:
            with self._lock:
                if prefix_id not in self._prefixes:
                    raise ValueError(f"unknown prefix_id {prefix_id}")
                plen = self._prefixes[prefix_id][1]
        if plen + prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix {plen} + prompt {prompt.size} + new "
                f"{max_new_tokens} exceeds the engine's max_len "
                f"{self.max_len}")
        if self._pool is not None:
            # a request that alone outsizes the pool would stall the
            # admission loop forever: reject it at submission, typed
            fresh = (self._pages_for_span(
                plen + int(prompt.size) + max_new_tokens)
                - plen // self.page_tokens)
            if fresh > self._pool.capacity:
                raise ValueError(
                    f"request needs {fresh} fresh KV pages; the pool "
                    f"holds {self._pool.capacity} (raise kv_pages or "
                    f"shrink the request)")
        return prompt

    def submit(self, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               prefix_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], Any]] = None) -> int:
        """Enqueue a request; returns its id. ``prompt`` is a 1-D token
        sequence (with ``prefix_id``: the tokens AFTER the registered
        prefix); admission happens on a later ``step()``. ``on_token``
        streams each emitted token as ``on_token(request_id, token)`` the
        moment the host sees it (per admission, per horizon)."""
        prompt = self.check_request(prompt, max_new_tokens, prefix_id)
        with self._lock:
            if self.queue_cap is not None:
                inflight = self._inflight_locked()
                if inflight >= self.queue_cap:
                    raise EngineOverloadedError(inflight, self.queue_cap)
            rid = self._next_id
            self._next_id += 1
            self._queue.append(_Pending(rid, prompt, max_new_tokens,
                                        eos_id, self._clock(),
                                        prefix_id, on_token))
            depth = len(self._queue)
        if self.metrics is not None:
            self.metrics.inc("requests_submitted")
            self.metrics.set_gauge("queue_depth", depth)
        return rid

    def _inflight_locked(self) -> int:
        return (len(self._queue) + len(self._kv_queue)
                + len(self._admitting)
                + sum(s is not None for s in self._slots)
                + (1 if self._prefilling is not None else 0))

    def submit_kv(self, handoff: KVHandoff, max_new_tokens: int,
                  eos_id: Optional[int] = None,
                  prefix_id: Optional[int] = None,
                  on_token: Optional[Callable[[int, int], Any]] = None
                  ) -> int:
        """Enqueue a request whose prefill already happened on another
        engine: ``handoff`` carries the KV, so admission splices it into a
        free slot and runs no prefill here. ``max_new_tokens`` is the
        request's total budget; the handoff's emitted tokens count against
        it (they seed the slot and are not fired through ``on_token`` again:
        the caller delivered them). A suffix-only handoff (``base > 0``)
        needs ``prefix_id`` naming a registered prefix of exactly ``base``
        positions. The caller verifies the checksum (``handoff.verify()``);
        this method trusts the payload's bytes."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if not handoff.emitted:
            raise ValueError("handoff carries no emitted tokens")
        if handoff.base > 0:
            if prefix_id is None:
                raise ValueError("suffix-only handoff needs a prefix_id")
            with self._lock:
                if prefix_id not in self._prefixes:
                    raise ValueError(f"unknown prefix_id {prefix_id}")
                plen = self._prefixes[prefix_id][1]
            if plen != handoff.base:
                raise ValueError(f"handoff base {handoff.base} != local "
                                 f"prefix length {plen}")
        remaining = max_new_tokens - len(handoff.emitted)
        if handoff.pos + max(remaining, 0) > self.max_len:
            raise ValueError(
                f"cached {handoff.pos} + remaining {remaining} exceeds "
                f"the engine's max_len {self.max_len}")
        self._check_payload(handoff.cache, handoff.pos)
        if self._pool is not None:
            fresh = (self._pages_for_span(handoff.pos + max(remaining, 0))
                     - handoff.base // self.page_tokens)
            if fresh > self._pool.capacity:
                raise ValueError(
                    f"handoff needs {fresh} fresh KV pages; the pool "
                    f"holds {self._pool.capacity}")
        with self._lock:
            if self.queue_cap is not None:
                inflight = self._inflight_locked()
                if inflight >= self.queue_cap:
                    raise EngineOverloadedError(inflight, self.queue_cap)
            rid = self._next_id
            self._next_id += 1
            self._kv_queue.append(_KVPending(
                rid, handoff, max_new_tokens, eos_id, prefix_id,
                self._clock(), on_token))
        if self.metrics is not None:
            self.metrics.inc("requests_submitted")
        return rid

    def export_kv(self, request_id: int) -> Optional[KVHandoff]:
        """A slot-resident request's accumulated cache (prefix, prompt and
        the tokens decoded so far) as a sealed host ``KVHandoff``: adopting
        it on a same-config engine through ``submit_kv`` continues the
        decode token for token. The request keeps running here; pair with
        ``abort()`` to migrate it. None when the id is not in a slot
        (queued, mid-prefill or finished). Call from the stepping thread
        only: the slot's rows must not be read while a step runs."""
        with self._lock:
            found = next(((i, s) for i, s in enumerate(self._slots)
                          if s is not None and s.request_id == request_id),
                         None)
            if found is None:
                return None
            i, s = found
            pos, emitted = s.pos, tuple(s.emitted)
        # trimmed to the position bucket of the live positions: the copy,
        # the checksum and every hop downstream scale with the request.
        # Pages and buckets share the PAGE_TOKENS granule, so the paged
        # gather ships exactly the bucket's pages.
        pb = _bucket_len(pos, self.max_len)
        table = (self._tables[i, :pb // self.page_tokens]
                 if self._pool is not None else None)
        row = self._run("export_slot", slot=i, pb=pb, table=table)
        self.stats["kv_exported"] += 1
        layout = self._export_layout(_cache_nbytes(row))
        return KVHandoff(cache=row, pos=pos, first_token=emitted[0],
                         emitted=emitted, layout=layout).seal()

    def _p_export_slot(self, slot: int, pb: int,
                       table: Optional[np.ndarray]
                       ) -> Optional[Dict[str, torch.Tensor]]:
        """Positions ``[0, pb)`` of slot ``slot`` (paged: through its block
        ``table``) as a host payload on the driver: the ``data`` rank that
        holds the slot gathers its heads."""
        plan = self._plan
        with self._mode():
            if self._pool is not None:
                idx = torch.from_numpy(table.astype(np.int64)).to(self.device)
                leaves = {name: pool[:, idx].flatten(1, 2)[:, None]
                          for name, pool in self._pool_cache.leaves.items()}
                return self._to_driver(leaves, pb, 0)
            row = plan.local_row(slot) if plan else slot
            leaves = (None if row is None else
                      {name: t[:, row:row + 1, :pb]
                       for name, t in self._cache.leaves.items()})
            return self._to_driver(leaves, pb,
                                   plan.owner(slot) if plan else 0)

    def start_prefill(self, prompt, prefix_id: Optional[int] = None
                      ) -> "PrefillJob":
        """Begin an incremental prefill that ends in a ``KVHandoff``
        instead of a slot admission: the prefill-pool half of
        disaggregated serving. See ``PrefillJob``."""
        prompt = self.check_request(prompt, 1, prefix_id)
        return PrefillJob(self, prompt, prefix_id)

    def _admit_kv_pending(self) -> None:
        """Adopt queued KV handoffs into free slots, before the regular
        queue: a handed-off request already paid its prefill (and its wait
        on the prefill pool), and its splice runs no prefill."""
        while True:
            with self._lock:
                if not self._kv_queue:
                    return
                free = [i for i in range(self.n_slots)
                        if self._slots[i] is None
                        and i != self._reserved_slot
                        and i not in self._admitting]
                if not free:
                    return
                req = self._kv_queue[0]
                pages: Optional[List[int]] = None
                fb = 0
                if self._pool is not None:
                    # eager reservation: the splice must never fail after
                    # the request leaves the queue. A short pool stalls the
                    # adoption (counted) until pages free up.
                    h = req.handoff
                    remaining = max(req.max_new_tokens - len(h.emitted), 0)
                    alias = (self._prefix_alias_blocks(req.prefix_id, h.base)
                             if h.base > 0 else [])
                    fb = len(alias)
                    fresh = self._alloc_pages(
                        self._pages_for_span(h.pos + remaining) - fb)
                    if fresh is None:
                        return
                    pages = self._alias_pages(alias) + fresh
                self._kv_queue.popleft()
                self._admitting.add(free[0])
            i = free[0]
            try:
                self._adopt_into_slot(i, req, pages, fb)
            except BaseException:
                self._release_pages(pages)
                raise
            finally:
                with self._lock:
                    self._admitting.discard(i)

    def _adopt_into_slot(self, i: int, req: _KVPending,
                         pages: Optional[List[int]] = None,
                         fb: int = 0) -> None:
        """Splice a handoff's KV into slot ``i`` and activate it. A
        suffix-only handoff lays its rows ``[base, pos)`` over the locally
        registered prefix's (the bytes the prefill engine attended: same
        parameters, same tokens, same calls). Paged: a batch-1 row is
        staged and only blocks ``[fb, nbp)`` are written; the leading
        ``fb`` entries of ``pages`` alias the prefix's full pages."""
        h = req.handoff
        base, pos = h.base, h.pos
        pids_row = None
        if self._pool is not None:
            nbp = self._pages_for_span(pos)
            pids_row = np.zeros(self._nb_total, np.int32)
            pids_row[fb:nbp] = pages[fb:nbp]
        self._run("adopt", slot=i, base=base, pos=pos,
                  prefix=(self._prefixes[req.prefix_id][0] if base > 0
                          else None),
                  pids_row=pids_row, payload=h.cache)
        if self._pool is not None:
            self._tables[i] = self._table_row(pages)
            self.stats["admit_copy_positions"] += ((nbp - fb)
                                                   * self.page_tokens)
            self._update_page_gauges()
        else:
            self.stats["admit_copy_positions"] += pos
        with self._lock:
            self._slots[i] = _Slot(req.request_id, pos, int(h.emitted[-1]),
                                   list(h.emitted), req.max_new_tokens,
                                   req.eos_id, req.submitted_at,
                                   req.on_token, pages=pages)
        # the handoff's tokens are not fired or counted again: the prefill
        # engine emitted them and the handoff's owner delivered them
        self.stats["admitted"] += 1
        self.stats["kv_adopted"] += 1
        if self.metrics is not None:
            self.metrics.set_gauge("queue_depth", len(self._queue))
        self._retire_if_done(i)

    def _p_adopt(self, slot: int, base: int, pos: int,
                 prefix: Optional[int], pids_row: Optional[np.ndarray],
                 payload: Dict[str, torch.Tensor]) -> None:
        """The splice: positions ``[base, pos)`` of the payload's heads
        over the prefix cache's ``[0, base)``, into the slot's row (dense,
        on the ``data`` rank that holds it) or into a staged row whose
        blocks ``pids_row`` names go to the pool (paged)."""
        heads = self._plan.put_cache(payload) if self._plan else payload
        with self._mode():
            if self._pool is not None:
                nbp = self._pages_for_span(pos)
                target, row = _zeros(_resized(self._shapes(1), 1,
                                              nbp * self.page_tokens),
                                     self.device), 0
            else:
                row = self._plan.local_row(slot) if self._plan else slot
                if row is None:
                    return
                target = self._cache
            pkv = self._kvs[prefix] if prefix is not None else None
            for name, dst in target.leaves.items():
                if pkv is not None:
                    dst[:, row, :base] = pkv.leaves[name][:, 0, :base]
                dst[:, row, base:pos] = heads[name][:, 0, base:pos]
        if self._pool is not None:
            self._write_pages(target, 0, pids_row)

    def _admit_pending(self) -> None:
        if self._prefilling is not None:
            self._advance_prefill()       # one chunk per engine step
        self._admit_kv_pending()
        with self._lock:
            # bound this pass to the arrivals present at entry: under
            # concurrent submitters an unbounded loop could admit and
            # retire forever (instant-eos floods) and starve decode
            budget = len(self._queue)
        while budget > 0:
            # selection runs under the lock (frontend threads append to the
            # queue concurrently); device work happens after release
            with self._lock:
                if not self._queue:
                    return
                free = [i for i in range(self.n_slots)
                        if self._slots[i] is None
                        and i != self._reserved_slot
                        and i not in self._admitting]
                if not free:
                    return
                req = self._queue[0]
                plen = (0 if req.prefix_id is None
                        else self._prefixes[req.prefix_id][1])
                chunked = (self.prefill_chunk
                           and req.prompt.size > self.prefill_chunk)
                if chunked and self._prefilling is not None:
                    return    # strict FIFO: one chunked prefill in flight
                if chunked or req.prefix_id is not None:
                    head_pages: Optional[List[int]] = None
                    fresh_from = 0
                    if self._pool is not None:
                        # eager reservation: pages for the whole span
                        # [0, plen+prompt+max_new) are claimed BEFORE the
                        # request leaves the queue, so admission can never
                        # half-fail. Full prefix pages alias (the fork
                        # block is always written fresh).
                        alias = self._prefix_alias_blocks(req.prefix_id,
                                                          plen)
                        fresh_from = len(alias)
                        end = (plen + int(req.prompt.size)
                               + req.max_new_tokens)
                        fresh = self._alloc_pages(
                            self._pages_for_span(end) - fresh_from)
                        if fresh is None:
                            return    # pool short: stall, retry next step
                        head_pages = self._alias_pages(alias) + fresh
                    self._queue.popleft()
                    if chunked:
                        # reserve under the lock: free_slots must never
                        # overcount while the chunked prefill is staged
                        self._reserved_slot = free[0]
                    else:
                        self._admitting.add(free[0])
                    group = [req]
                    group_pages = ([head_pages]
                                   if head_pages is not None else None)
                else:
                    # plain requests: batch the front FIFO run sharing this
                    # request's prompt bucket into ONE prefill
                    bucket = _bucket_len(int(req.prompt.size),
                                         self.max_len)
                    group = [req]
                    for nxt in itertools.islice(
                            self._queue, 1, self._ADMIT_BATCH_SIZES[0]):
                        if (len(group) >= min(len(free),
                                              self._ADMIT_BATCH_SIZES[0])
                                or nxt.prefix_id is not None
                                or (self.prefill_chunk
                                    and (nxt.prompt.size
                                         > self.prefill_chunk))
                                or _bucket_len(int(nxt.prompt.size),
                                               self.max_len) != bucket):
                            break
                        group.append(nxt)
                    b = max(s for s in self._ADMIT_BATCH_SIZES
                            if s <= min(len(group), len(free)))
                    group = group[:b]
                    group_pages = None
                    if self._pool is not None:
                        # eager per-request reservation bounds the batch
                        # by what the pool can hold
                        group_pages = []
                        for r in group:
                            fresh = self._alloc_pages(self._pages_for_span(
                                int(r.prompt.size) + r.max_new_tokens))
                            if fresh is None:
                                break
                            group_pages.append(fresh)
                        if not group_pages:
                            return    # head stalled on the pool
                        if len(group_pages) < len(group):
                            b = max(s for s in self._ADMIT_BATCH_SIZES
                                    if s <= len(group_pages))
                            for pl in group_pages[b:]:
                                self._release_pages(pl)
                            group = group[:b]
                            group_pages = group_pages[:b]
                    for _ in group:
                        self._queue.popleft()
                    self._admitting.update(free[:len(group)])
                depth = len(self._queue)
            budget -= len(group)
            if chunked:
                if self.metrics is not None:
                    self.metrics.set_gauge("queue_depth", depth)
                self._prefilling = _Prefilling(
                    req, self._private_cache(req.prefix_id), plen, plen,
                    plen + int(req.prompt.size), self._clock(),
                    pages=group_pages[0] if group_pages else None,
                    fresh_from=fresh_from if group_pages else 0)
                self._advance_prefill()
                continue
            unconsumed = list(group_pages) if group_pages else []
            kv = None
            try:
                dequeued_at = self._clock()
                if req.prefix_id is not None:
                    kv = self._private_cache(req.prefix_id)
                    first = self._append_prefill(kv, req.prompt, plen)
                    pages = unconsumed.pop(0) if unconsumed else None
                    self._finish_admission(free[0], req, kv, first,
                                           plen + int(req.prompt.size),
                                           dequeued_at, pages=pages,
                                           fresh_from=fresh_from)
                    continue
                b = len(group)
                lps = np.asarray([r.prompt.size for r in group], np.int32)
                padded = np.zeros((b, bucket), np.int32)
                for j, r in enumerate(group):
                    padded[j, :r.prompt.size] = r.prompt
                kv, firsts = self._prefill(padded, lps)
                firsts = firsts.cpu().numpy()
                for j, (r, i) in enumerate(zip(group, free)):
                    pages = unconsumed.pop(0) if unconsumed else None
                    self._finish_admission(i, r, kv, firsts[j],
                                           int(lps[j]), dequeued_at, row=j,
                                           pages=pages)
            finally:
                # a failing prefill must not leak reservations or pages
                # (success clears each slot in _finish_admission and drains
                # ``unconsumed`` as rows land)
                for pl in unconsumed:
                    self._release_pages(pl)
                self._free(kv)
                with self._lock:
                    self._admitting.difference_update(free)

    def _advance_prefill(self) -> None:
        """One chunk of the in-flight chunked prefill, appended to the
        request's private cache; on the last chunk, the first token is
        sampled and the request admitted into the reserved slot."""
        st = self._prefilling
        offset = st.done - st.base
        chunk = st.req.prompt[offset:offset + self.prefill_chunk]
        first = self._append_prefill(st.pre_cache, chunk, st.done)
        st.done += int(chunk.size)
        if st.done == st.total:
            i = self._reserved_slot
            self._prefilling = None
            # fill the slot first, then drop the reservation: the brief
            # filled+reserved overlap UNDERcounts free_slots (safe for
            # admission control); the reverse order would overcount
            try:
                self._finish_admission(i, st.req, st.pre_cache, first,
                                       st.total, st.dequeued_at,
                                       pages=st.pages,
                                       fresh_from=st.fresh_from)
            finally:
                self._free(st.pre_cache)
            with self._lock:
                self._reserved_slot = None

    def _finish_admission(self, i: int, req: _Pending, kv: int, first,
                          lp: int, dequeued_at: float, row: int = 0,
                          pages: Optional[List[int]] = None,
                          fresh_from: int = 0) -> None:
        """Copy row ``row`` of prefilled cache ``kv``'s first ``lp``
        positions into slot ``i`` and activate it; the first token (sampled
        by the prefill) is emitted here. Positions >= lp keep the slot's old
        bytes, never attended. Paged mode writes only the blocks past
        ``fresh_from`` (aliased prefix pages are already live)."""
        if self._pool is not None:
            wb = self._pages_for_span(lp)
            pids_row = np.zeros(self._nb_total, np.int32)
            pids_row[fresh_from:wb] = pages[fresh_from:wb]
            self._run("write_pages", h=kv, row=row, pids_by_block=pids_row)
            self._tables[i] = self._table_row(pages)
            self.stats["admit_copy_positions"] += ((wb - fresh_from)
                                                   * self.page_tokens)
            self._update_page_gauges()
        else:
            self._run("admit", slot=i, h=kv, row=row, lp=lp)
            self.stats["admit_copy_positions"] += lp
        first = int(first)   # host sync: the first token IS emitted now
        # seed the slot's draft row from the request's own tokens (False:
        # an imported prefix the draft never saw; the slot decodes plain)
        drafted = (self._draft is not None
                   and self._draft.seed(i, req.prompt, req.prefix_id))
        with self._lock:
            self._slots[i] = _Slot(req.request_id, lp, first, [first],
                                   req.max_new_tokens, req.eos_id,
                                   req.submitted_at, req.on_token,
                                   draft=drafted, pages=pages)
            self._admitting.discard(i)
        self._fire_on_token(self._slots[i], first)
        self.stats["admitted"] += 1
        self.stats["emitted"] += 1
        if self.metrics is not None:
            self.metrics.observe("queue_wait_seconds",
                                 dequeued_at - req.submitted_at)
            self.metrics.observe("time_to_first_token_seconds",
                                 self._clock() - req.submitted_at)
            self.metrics.inc("tokens_emitted")
            self.metrics.set_gauge("queue_depth", len(self._queue))
        self._retire_if_done(i)

    def _p_admit(self, slot: int, h: int, row: int, lp: int) -> None:
        """The dense splice, on the ``data`` rank that holds the slot."""
        local = self._plan.local_row(slot) if self._plan else slot
        if local is None:
            return
        with self._mode():
            for dst, src in self._cache.pairs(self._kvs[h]):
                dst[:, local, :lp] = src[:, row, :lp]

    def _fire_on_token(self, slot: _Slot, token: int) -> None:
        """Streaming callbacks run between device steps: a raising callback
        (a disconnected client) must not unwind the engine loop mid-horizon,
        or other slots' host state desyncs from the already-advanced device
        cache. Detach it, warn, keep serving."""
        if slot.on_token is None:
            return
        try:
            slot.on_token(slot.request_id, token)
        except Exception as e:  # noqa: BLE001 — isolate per-request faults
            slot.on_token = None
            count_detached_callback(
                self.metrics,
                f"on_token callback for request {slot.request_id} raised "
                f"{type(e).__name__}: {e}; streaming detached")

    def _retire_if_done(self, i: int) -> bool:
        slot = self._slots[i]
        done = (len(slot.emitted) >= slot.max_new_tokens
                or (slot.eos_id is not None
                    and slot.emitted[-1] == slot.eos_id))
        if done:
            tokens = np.asarray(slot.emitted, np.int32)
            with self._lock:
                self._finished[slot.request_id] = tokens
                self._slots[i] = None
            if self._pool is not None:
                self._release_pages(slot.pages)
                self._tables[i, :] = 0
                self._update_page_gauges()
            if self.metrics is not None:
                self.metrics.inc("requests_finished")
                self.metrics.observe("request_latency_seconds",
                                     self._clock() - slot.submitted_at)
            if self._on_retire is not None:
                try:
                    self._on_retire(slot.request_id, tokens)
                except Exception as e:  # noqa: BLE001 — isolate like on_token
                    self._on_retire = None
                    count_detached_callback(
                        self.metrics,
                        f"on_retire callback raised {type(e).__name__}: "
                        f"{e}; detached")
        return done

    def abort(self, request_id: int) -> Optional[np.ndarray]:
        """Abort a request wherever it lives (queued, mid-chunked-prefill or
        mid-decode) and free its capacity at once: the very next ``step()``
        runs without it and can admit a waiting request into the freed
        slot (its stale KV rows are never attended and are overwritten on
        reuse).

        Returns the tokens emitted so far (empty for a request that never
        reached a slot), or None when the id is unknown, already finished,
        or mid-admission this instant (retryable on the next step). Call
        from the stepping thread only."""
        with self._lock:
            for idx, p in enumerate(self._queue):
                if p.request_id == request_id:
                    del self._queue[idx]
                    if self.metrics is not None:
                        self.metrics.set_gauge("queue_depth",
                                               len(self._queue))
                    return np.zeros(0, np.int32)
            for idx, p in enumerate(self._kv_queue):
                if p.request_id == request_id:
                    del self._kv_queue[idx]
                    # the handoff's tokens were delivered by its owner:
                    # partial, like a mid-decode abort
                    return np.asarray(p.handoff.emitted, np.int32)
            st = self._prefilling
            if st is not None and st.req.request_id == request_id:
                # drop the private prefill cache and the slot reservation;
                # nothing reached the shared pool yet
                self._prefilling = None
                self._reserved_slot = None
                self._release_pages(st.pages)
                self._update_page_gauges()
                self._free(st.pre_cache)
                return np.zeros(0, np.int32)
            for i, s in enumerate(self._slots):
                if s is not None and s.request_id == request_id:
                    self._slots[i] = None
                    if self._pool is not None:
                        self._release_pages(s.pages)
                        self._tables[i, :] = 0
                        self._update_page_gauges()
                    return np.asarray(s.emitted, np.int32)
        return None

    def reset(self) -> List[int]:
        """Recover the engine after a crash (``EngineCrashError``): drop all
        host-side request state (slots, queue, chunked prefill, admission
        reservations), as a restarted decode worker would come up empty.
        Models, registered prefixes and the cache pool survive; finished
        results stay claimable. Returns the ids of every request dropped."""
        with self._lock:
            lost = [p.request_id for p in self._queue]
            lost += [p.request_id for p in self._kv_queue]
            if self._prefilling is not None:
                lost.append(self._prefilling.req.request_id)
            lost += [s.request_id for s in self._slots if s is not None]
            if self._pool is not None:
                # per-request pages go back to the pool; registered
                # prefixes keep theirs
                for s in self._slots:
                    if s is not None:
                        self._release_pages(s.pages)
                if self._prefilling is not None:
                    self._release_pages(self._prefilling.pages)
                self._tables[:, :] = 0
            staged = ([self._prefilling.pre_cache]
                      if self._prefilling is not None else [])
            self._slots = [None] * self.n_slots
            self._queue.clear()
            self._kv_queue.clear()
            self._prefilling = None
            self._reserved_slot = None
            self._admitting.clear()
        # the chunked prefill's private cache goes here and on the workers
        self._run("reset", handles=staged)
        self._update_page_gauges()
        if self.metrics is not None:
            self.metrics.set_gauge("queue_depth", 0)
            self.metrics.set_gauge("slots_active", 0)
        return sorted(lost)

    def _p_reset(self, handles: List[int]) -> None:
        """Drop device caches by handle (also a worker's deferred frees)."""
        for h in handles:
            self._kvs.pop(h, None)

    # ---- the engine loop ---------------------------------------------------
    def step(self) -> List[int]:
        """Admit queued requests, advance every active slot by one horizon
        (``step_horizon`` tokens, one copy to the host), and return the ids
        of the requests that finished. The ids are notifications: the
        payload goes to whoever calls ``result()`` first. A fault installed
        at ``chaos.SITE_SERVE_STEP`` fires first: ``EngineCrash`` raises
        ``EngineCrashError`` (``reset()`` recovers the engine),
        ``EngineStall`` returns ``[]`` having done nothing."""
        fault = chaos.fire(chaos.SITE_SERVE_STEP, steps=self.stats["steps"])
        if isinstance(fault, chaos.EngineCrash):
            self.stats["crashes"] += 1
            raise EngineCrashError("chaos: engine crashed mid-decode")
        if isinstance(fault, chaos.EngineStall):
            # a wedged device step: no admission, no tokens, no retirement
            return []
        # snapshot BEFORE admission: a request that retires during
        # admission itself (max_new_tokens=1, instant eos) must still be
        # reported by THIS step
        with self._lock:
            before = set(self._finished)
        self._admit_pending()
        active = [i for i, s in enumerate(self._slots) if s is not None]
        if active and self._use_spec_round(active):
            self._spec_round(active)
        elif active:
            out = self._decode(active)              # [horizon, n_slots]
            self.stats["steps"] += self.step_horizon
            emitted_now = sum(self._emit_tokens(i, out[:, i])
                              for i in active)
            if self.metrics is not None:
                self.metrics.inc("tokens_emitted", emitted_now)
        if self.metrics is not None:
            self.metrics.set_gauge("slots_active",
                                   sum(s is not None for s in self._slots))
        with self._lock:
            return sorted(set(self._finished) - before)

    def _decode(self, active: List[int]) -> np.ndarray:
        """``step_horizon`` decode steps over the whole slot pool; free
        slots pass the sentinel position. Paged mode gathers the view
        first and scatters the tail pages back after."""
        toks = np.zeros(self.n_slots, np.int32)
        pos = np.full(self.n_slots, self.max_len, np.int32)   # sentinel
        for i in active:
            toks[i] = self._slots[i].last_token
            pos[i] = self._slots[i].pos
        return self._run("decode", toks=toks, pos=pos, tables=(
            self._tables if self._pool is not None else None))

    def _step_cache(self, tables: Optional[np.ndarray]) -> List[KVCache]:
        """The caches a step reads: the dense pool (this rank's rows), or
        the paged view gathered through ``tables``."""
        if self._pool is not None:
            self._gather_view(tables)
            return self._view.layers()
        return self._cache.layers()

    def _rows(self) -> slice:
        return self._plan.rows if self._plan is not None else slice(None)

    def _p_decode(self, toks: np.ndarray, pos: np.ndarray,
                  tables: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """``step_horizon`` steps of this rank's rows; the tokens of every
        row ``[horizon, n_slots]`` on the driver's host."""
        dev = self.device
        rows = self._rows()
        with self._mode():
            cache = self._step_cache(tables)
            tok = torch.from_numpy(toks[rows]).to(dev)
            p = torch.from_numpy(pos[rows]).to(dev)
            out = []
            for _ in range(self.step_horizon):
                logits = self._step_model(tok[:, None], p[:, None], cache)
                tok = self._choose(logits[:, -1])
                p = p + 1
                out.append(tok)
            if self._pool is not None:
                self._scatter_tails(tables, pos, self.step_horizon)
            out = torch.stack(out)
            if self._plan is not None:
                out = self._plan.gather_rows(out.t().contiguous()).t()
            return None if self._worker else out.cpu().numpy()

    def _choose(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's rows' next tokens from their logits ``[rows, V]``
        (whole over ``model``). Greedy: the argmax, alike on every rank.
        Sampled on a mesh: the driver draws for every row from the logits
        gathered over ``data`` and broadcasts the tokens."""
        plan = self._plan
        if plan is None or self.sampling.is_greedy:
            return sample(logits, self._generator, self.sampling)
        full = plan.gather_rows(logits)
        if self._worker:
            tok = torch.empty(full.shape[0], dtype=torch.int32,
                              device=self.device)
        else:
            tok = sample(full, self._generator, self.sampling)
        broadcast_from_origin(tok, plan.mesh)
        return tok[self._rows()]

    def _emit_tokens(self, i: int, tokens) -> int:
        """Append host-side ``tokens`` to slot ``i`` in order: position,
        bookkeeping, streaming and retirement. Stops at retirement (surplus
        tokens of a horizon are discarded; greedy output is unchanged);
        returns the count emitted."""
        n = 0
        for tok in tokens:
            slot = self._slots[i]
            slot.pos += 1
            slot.last_token = int(tok)
            slot.emitted.append(slot.last_token)
            self.stats["emitted"] += 1
            n += 1
            self._fire_on_token(slot, slot.last_token)
            if self._retire_if_done(i):
                break
        return n

    # ---- speculative rounds ------------------------------------------------
    def _use_spec_round(self, active: List[int]) -> bool:
        """Whether this step runs a speculative round: a draft is attached,
        at least one active slot is drafted (an all-undrafted pool takes
        the plain step rather than a ``k+1``-wide verify that emits one
        token a slot), and the draft survives this round's
        ``chaos.SITE_SPEC_DRAFT``."""
        if self._draft is None:
            return False
        if not any(self._slots[i].draft for i in active):
            return False
        fault = chaos.fire(chaos.SITE_SPEC_DRAFT,
                           rounds=self.stats["spec_rounds"])
        if isinstance(fault, chaos.DraftCrash):
            self.degrade_draft()
            return False
        return True

    def degrade_draft(self) -> None:
        """Drop a dead draft model and keep serving: every in-flight request
        continues on the plain step from this very step, token for token
        (greedy: the draft only speeds decoding up). Counted and warned,
        never silent; a supervisor that sees a draft worker die calls it
        too."""
        self._draft = None
        self.stats["draft_crashes"] += 1
        if self.spec_metrics is not None:
            self.spec_metrics.inc("spec_draft_crashes")
        warnings.warn("speculative draft crashed; engine degraded to plain "
                      "decode (token-identical, nothing lost)", stacklevel=3)

    def _spec_round(self, active: List[int]) -> None:
        """One speculative round over the whole slot pool: the draft
        proposes ``k`` greedy tokens for each drafted slot, one batched
        forward of the step model verifies every slot's ``[last_token,
        d_1..d_k]`` chunk at its own positions, and each drafted slot emits
        its longest agreeing prefix plus the target's token after it (a
        correction, or a bonus when all ``k`` agree): 1 to ``k+1`` tokens,
        as plain greedy decode would emit them. An undrafted slot carries
        the sentinel past column 0 and emits its ordinary next token."""
        k = self._spec_k
        t0 = self._clock()
        toks = np.zeros(self.n_slots, np.int32)
        pos = np.full(self.n_slots, self.max_len, np.int32)   # sentinel
        for i in active:
            s = self._slots[i]
            toks[i] = s.last_token
            if s.draft:
                pos[i] = s.pos
        proposals = self._draft.propose(toks, pos)            # [k, n_slots]
        t1 = self._clock()
        chunk = np.zeros((self.n_slots, k + 1), np.int32)
        cpos = np.full((self.n_slots, k + 1), self.max_len, np.int32)
        for i in active:
            s = self._slots[i]
            chunk[i, 0] = s.last_token
            cpos[i, 0] = s.pos
            if s.draft:
                chunk[i, 1:] = proposals[:, i]
                cpos[i] = s.pos + np.arange(k + 1, dtype=np.int32)
        greedy = self._verify(chunk, cpos)                    # [n_slots, k+1]
        t2 = self._clock()
        self.stats["steps"] += 1
        rids = sorted(self._slots[i].request_id for i in active)
        emitted_now = proposed = accepted_n = rollbacks = 0
        for i in active:
            if self._slots[i].draft:
                j = 0
                while j < k and proposals[j, i] == greedy[i, j]:
                    j += 1
                out = [*proposals[:j, i], greedy[i, j]]
                proposed += k
                accepted_n += j
                rollbacks += j < k
            else:
                out = [greedy[i, 0]]
            emitted_now += self._emit_tokens(i, out)
        self.stats["spec_rounds"] += 1
        self.stats["spec_proposed"] += proposed
        self.stats["spec_accepted"] += accepted_n
        self.stats["spec_rollbacks"] += rollbacks
        self.stats["spec_draft_s"] += t1 - t0
        self.stats["spec_verify_s"] += t2 - t1
        if self.spec_metrics is not None and proposed:
            self.spec_metrics.inc("spec_tokens_proposed", proposed)
            if accepted_n:
                self.spec_metrics.inc("spec_tokens_accepted", accepted_n)
            if rollbacks:
                self.spec_metrics.inc("spec_rollbacks", rollbacks)
            self.spec_metrics.set_gauge(
                "spec_acceptance_rate",
                self.stats["spec_accepted"]
                / max(self.stats["spec_proposed"], 1))
        if self.metrics is not None:
            self.metrics.inc("tokens_emitted", emitted_now)
        if self._on_spec_round is not None:
            try:
                self._on_spec_round(rids, t1 - t0, t2 - t1, proposed,
                                    accepted_n)
            except Exception as e:  # noqa: BLE001 — isolate like on_retire
                self._on_spec_round = None
                count_detached_callback(
                    self.metrics,
                    f"on_spec_round callback raised {type(e).__name__}: "
                    f"{e}; detached")

    def _verify(self, chunk: np.ndarray, cpos: np.ndarray) -> np.ndarray:
        """One forward of the step model over every slot's chunk ``[n_slots,
        k+1]`` at positions ``cpos`` → the target's greedy token after each
        chunk prefix, ``[n_slots, k+1]`` on the host. Paged mode gathers the
        view first and scatters the tail pages back after, over a span of
        ``k+1``: rejected proposals land in the slot's own tail pages, never
        in a shared prefix page."""
        return self._run("verify", chunk=chunk, cpos=cpos, tables=(
            self._tables if self._pool is not None else None))

    def _p_verify(self, chunk: np.ndarray, cpos: np.ndarray,
                  tables: Optional[np.ndarray]) -> Optional[np.ndarray]:
        dev = self.device
        rows = self._rows()
        with self._mode():
            cache = self._step_cache(tables)
            greedy = _greedy(self._step_model(
                torch.from_numpy(chunk[rows]).to(dev),
                torch.from_numpy(cpos[rows]).to(dev), cache))
            if self._pool is not None:
                self._scatter_tails(tables, cpos[:, 0], chunk.shape[1])
            if self._plan is not None:
                greedy = self._plan.gather_rows(greedy)
            return None if self._worker else greedy.cpu().numpy()

    def run(self) -> Dict[int, np.ndarray]:
        """Drain the queue and every active slot; returns {id: tokens}."""
        while (self._queue or self._kv_queue
               or self._prefilling is not None
               or any(s is not None for s in self._slots)):
            self.step()
        out, self._finished = self._finished, {}
        return out

    def result(self, request_id: int) -> Optional[np.ndarray]:
        """The finished continuation of ``request_id`` (None while in
        flight); pops it from the engine. Thread-safe."""
        with self._lock:
            return self._finished.pop(request_id, None)

    @property
    def free_slots(self) -> int:
        with self._lock:
            free = sum(s is None for s in self._slots)
            return (free - len(self._admitting)
                    - (1 if self._reserved_slot is not None else 0))

    # ---- export accounting -------------------------------------------------
    def _export_layout(self, nbytes: int) -> CacheLayout:
        """The layout block every KV or prefix export carries, and the
        export's gathered device-to-host bytes counted (on ``stats`` and
        ``shard_metrics``)."""
        self.stats["export_gather_bytes"] += nbytes
        if self.shard_metrics is not None:
            self.shard_metrics.inc("export_gather_bytes", nbytes)
        return CacheLayout(mesh_axes=dict(self.mesh_axes),
                           gathered_bytes=nbytes)

    @property
    def param_bytes_per_chip(self) -> int:
        """Serving parameter bytes a chip holds: the whole tree without a
        mesh; this rank's blocks of the laid-out model on one."""
        if self._plan is None:
            return _cache_nbytes(self._params)
        return self._plan.bytes_per_chip(self._prefill_model.parameters())

    def _pool_shapes(self) -> CacheShapes:
        """The pool's leaves, whole (every kv head, every slot)."""
        shapes = cache_shapes(self._prefill_model, self.n_slots)
        if self._pool is not None:
            shapes = _resized(cache_shapes(self._prefill_model, 1),
                              self._pool.capacity + 1, self.page_tokens)
        return shapes

    @property
    def kv_bytes_per_chip(self) -> int:
        """Slot-pool (dense) or page-pool (paged) KV bytes a chip holds, an
        int8 cache's scales included: this rank's kv heads, and on
        ``data`` its slot rows (the paged pool is whole there); registered
        prefixes are not counted."""
        pool = self._pool_cache if self._pool is not None else self._cache
        return _cache_nbytes(pool.leaves)

    def shard_report(self) -> Dict[str, Any]:
        """The shard accounting as one dict (the reference's keys): mesh
        axes, chip count, and per-chip against total parameter and KV-pool
        bytes."""
        return {
            "mesh_axes": dict(self.mesh_axes),
            "n_chips": self.n_chips,
            "param_bytes_per_chip": self.param_bytes_per_chip,
            "param_bytes_total": _cache_nbytes(self._params),
            "kv_bytes_per_chip": self.kv_bytes_per_chip,
            "kv_bytes_total": sum(
                int(np.prod(shape)) * torch.empty((), dtype=dtype)
                .element_size()
                for shape, dtype in self._pool_shapes().values()),
        }


class PrefillJob:
    """Incremental prefill that ends in a ``KVHandoff`` instead of a slot
    admission: the prefill-pool half of disaggregated serving.

    ``advance()`` runs one chunk a call (``engine.prefill_chunk`` positions
    when chunking is on, else the whole prompt) through the engine's own
    ``_prefill`` and ``_append_prefill``, the calls a monolithic engine of
    the same config makes to admit the same request (same buckets, same
    chunk boundaries), so decode from the handed-off KV equals monolithic
    decode. The job never touches the slot pool; one job at a time per
    engine is the caller's discipline. With ``prefix_id`` the job prefills
    only the suffix over the registered prefix's cache."""

    def __init__(self, engine: ContinuousBatchingEngine, prompt: np.ndarray,
                 prefix_id: Optional[int]) -> None:
        self._engine = engine
        self.prompt = prompt
        self.prefix_id = prefix_id
        base = 0
        if prefix_id is not None:
            with engine._lock:
                base = engine._prefixes[prefix_id][1]
        self.base = base
        self.done = base                   # positions cached so far
        self.total = base + int(prompt.size)
        self.first_token: Optional[int] = None
        self._kv: Optional[int] = None      # the engine's cache handle

    def _release_with_job(self) -> None:
        # the job's cache lives as long as the job
        weakref.finalize(self, self._engine._free, self._kv)

    @property
    def finished(self) -> bool:
        return self.first_token is not None

    @property
    def remaining(self) -> int:
        return self.total - self.done

    def advance(self) -> bool:
        """Prefill one chunk; True once the whole prompt is cached
        (``first_token`` is then the prefill's sampled token)."""
        if self.finished:
            return True
        eng = self._engine
        chunked = (eng.prefill_chunk
                   and self.prompt.size > eng.prefill_chunk)
        if not chunked and self.base == 0:
            # whole prompt, no prefix: the monolithic cold admission
            lp = int(self.prompt.size)
            padded = np.zeros((1, _bucket_len(lp, eng.max_len)), np.int32)
            padded[0, :lp] = self.prompt
            self._kv, first = eng._prefill(padded, np.asarray([lp], np.int32))
            self._release_with_job()
            self.done = self.total
        else:
            if self._kv is None:
                self._kv = eng._private_cache(self.prefix_id)
                self._release_with_job()
            offset = self.done - self.base
            chunk = (self.prompt[offset:offset + eng.prefill_chunk]
                     if chunked else self.prompt[offset:])
            first = eng._append_prefill(self._kv, chunk, self.done)
            self.done += int(chunk.size)
        if self.done == self.total:
            self.first_token = int(first[0])
            eng.stats["emitted"] += 1
        return self.finished

    def handoff(self, *, suffix_only: bool = False,
                prefix_hash: Optional[str] = None) -> KVHandoff:
        """The finished prefill as a sealed host ``KVHandoff``.
        ``suffix_only`` (with a prefix-seeded job) zeroes the shared
        prefix's rows: the adopting engine supplies them from its own
        registered copy of ``prefix_hash``, so only suffix bytes travel."""
        if not self.finished:
            raise RuntimeError("prefill is not finished")
        host = self._engine._run("export", h=self._kv, pb=_bucket_len(
            self.total, self._engine.max_len))
        base = 0
        if suffix_only and self.base > 0:
            base = self.base
            for leaf in host.values():
                _zero_below(leaf, base)
        layout = self._engine._export_layout(_cache_nbytes(host))
        return KVHandoff(cache=host, pos=self.total,
                         first_token=self.first_token,
                         emitted=(self.first_token,), base=base,
                         prefix_hash=prefix_hash, layout=layout).seal()
