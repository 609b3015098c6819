"""DisaggFleet: prefill and decode as separately-scaled pools with KV handoff.

A monolithic replica (`serve/fleet.ServingFleet`) runs prefill and decode
on the same engine: a long prompt's prefill program executes between
decode steps, so every co-resident request's inter-token latency (TPOT)
spikes whenever a prefill lands — and the two workloads scale on
different signals (prefill is queue-bound and compute-heavy; decode is
memory-bandwidth-bound and latency-critical). This module splits them:

* **Prefill pool** — replicas that ONLY prefill: each runs one
  ``PrefillJob`` (`models/serving.py`) at a time, chunk per fleet step,
  mirroring exactly the admission path a monolithic engine with the same
  config would take (same programs, same bucketing, same chunk
  boundaries). The finished job's KV leaves the replica as a sealed,
  checksummed ``KVHandoff``.
* **Handoff queue** — a bounded, deadline-aware FIFO between the pools.
  Full queue = backpressure onto the prefill pool (the finished handoff
  stages on its replica, which takes no new job until it drains —
  never an unbounded host-RAM buffer). The transfer is a chaos site
  (``SITE_KV_HANDOFF``): a ``HandoffLoss`` vanishes the payload, a
  ``HandoffCorrupt`` flips its bytes. Recovery is typed and bounded —
  the request re-runs its prefill under the ``ReplayPolicy`` budget
  (loss), or is REJECTED by the adopting replica's checksum and then
  replayed (corruption) — never decoded into silently-wrong tokens, and
  never silently dropped (`chaos/scenarios.disagg_handoff_chaos` +
  `tests/test_serve_disagg.py` pin this).
* **Decode pool** — replicas that ONLY decode: admission is
  ``engine.submit_kv`` — a cache splice, zero prefill FLOPs. Handoffs
  dispatch by **KV locality**: a suffix-only handoff prefers a replica
  where its shared prefix is already device-resident
  (`kvstore.FleetPrefixStore.resident_on`), falling back to
  least-outstanding-tokens.
* **Fleet prefix store** (`serve/kvstore.py`) — ``register_prefix``
  promoted to a fleet concern: content-hash identity, per-replica
  residency, a host-RAM overflow tier with byte-budget LRU. The prefill
  pool pays each shared prefix's prefill ONCE fleet-wide; decode
  replicas adopt it as a host→device copy. Suffix-only handoffs then
  move only suffix KV bytes across the link.

Request lifecycle (states in `serve/lifecycle.RequestState`)::

    queued ──► prefilling ──► handoff ──► decoding ──► done
      ▲             │            │           │
      │             └────┬───────┴───────────┴──► cancelled /
      │ (replay: lost or │                        deadline_exceeded
      │  corrupt handoff)│
      └──────────────────┘──► retry_exhausted (budget spent)

Scaling: each pool exposes a scrape view (``pool("prefill")`` /
``pool("decode")``) duck-typed for `autoscale/signals.FleetScraper`, so
the `controller/fleetautoscaler.FleetAutoscaler` runs one decision loop
per pool — queue-wait p95 is the natural SLO for the prefill pool
(requests waiting for a prefill slot), TPOT p95 for the decode pool
(decode cadence) — and executes through ``scale_pool``.

Threading model matches the fleet's: ONE driver thread calls ``step()``
/ ``run()`` / ``drain()``; frontend threads call ``submit()`` /
``cancel()`` / ``result()`` / ``state()``.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.autoscale.signals import (
    FleetScraper,
    format_observation_line,
)
from tpu_on_k8s_torch.metrics import (
    ServingMetrics,
    count_detached_callback,
)
from tpu_on_k8s_torch.models.serving import EngineCrashError
from tpu_on_k8s_torch.obs.trace import STATUS_ERROR, ensure as ensure_tracer
from tpu_on_k8s_torch.serve.admission import (
    REASON_DRAINING,
    REASON_QUEUE_FULL,
    REASON_UNAVAILABLE,
    Rejected,
)
from tpu_on_k8s_torch.serve.gateway import ReplayPolicy
from tpu_on_k8s_torch.serve.health import ReplicaState
from tpu_on_k8s_torch.serve.kvstore import PAGE_TOKENS, FleetPrefixStore
from tpu_on_k8s_torch.serve.lifecycle import (
    LIVE_STATES,
    RequestResult,
    RequestState,
)

POOL_PREFILL = "prefill"
POOL_DECODE = "decode"


class PoolReplica:
    """One engine in one pool. Prefill replicas carry at most one active
    ``PrefillJob`` plus at most one ``staged`` handoff awaiting queue
    room (the backpressure seat); decode replicas carry slot-resident
    requests tracked fleet-side. Duck-typed for
    `autoscale/signals.FleetScraper` (``state`` / ``engine`` /
    ``metrics`` / ``outstanding`` / ``routable``)."""

    def __init__(self, name: str, pool: str, engine,
                 metrics: Optional[ServingMetrics]) -> None:
        self.name = name
        self.pool = pool
        self.engine = engine
        self.metrics = metrics
        self.state = ReplicaState.READY
        self.outstanding = 0        # in-flight token cost (balance signal)
        self.routed = 0
        self.job = None             # prefill: the active PrefillJob's rid
        self.staged = None          # prefill: rid whose handoff awaits room

    @property
    def routable(self) -> bool:
        return self.state is ReplicaState.READY

    @property
    def busy(self) -> bool:
        return self.job is not None or self.staged is not None


class DisaggPool:
    """Scrape view of one pool — what ``FleetScraper.scrape`` (and the
    per-pool autoscaler loop above it) reads. ``queue_depth`` is the
    work waiting to ENTER this pool: fleet-pending requests for the
    prefill pool, queued+staged handoffs for the decode pool."""

    def __init__(self, fleet: "DisaggFleet", name: str) -> None:
        self._fleet = fleet
        self.name = name

    @property
    def replicas(self) -> Dict[str, PoolReplica]:
        # snapshot under the fleet lock: the autoscaler thread's
        # scale_pool inserts into the live dict (same hazard
        # _pool_replicas guards on the driver side)
        with self._fleet._lock:
            return {n: r for n, r in self._fleet.replicas.items()
                    if r.pool == self.name}

    @property
    def queue_depth(self) -> int:
        return self._fleet.pool_queue_depth(self.name)


@dataclasses.dataclass
class _DisaggRequest:
    """Fleet-side record across both pools — survives a lost/corrupt
    handoff (the prefill pool's work product dies; this does not)."""

    rid: int
    prompt: np.ndarray
    suffix: np.ndarray                 # prompt minus any matched prefix
    prefix_hash: Optional[str]
    max_new_tokens: int
    eos_id: Optional[int]
    deadline: Optional[float]          # absolute fleet-clock time
    on_token: Optional[Callable[[int, int], None]]
    cost: int
    submitted_at: float
    state: RequestState = RequestState.QUEUED
    prefill_replica: Optional[str] = None
    decode_replica: Optional[str] = None
    engine_rid: Optional[int] = None
    replays: int = 0
    tokens: Optional[np.ndarray] = None
    cancel_requested: bool = False
    pinned: bool = False               # holds a store pin on prefix_hash
    queue_wait_observed: bool = False
    ttft_observed: bool = False        # TTFT is observed once per REQUEST
    first_token_at: Optional[float] = None
    decode_t0: Optional[float] = None  # first DECODE-pool token time
    last_token_at: Optional[float] = None
    n_decode_tokens: int = 0
    # tracing (`tpu_on_k8s_torch/obs/trace.py`): the root span plus the open
    # lifecycle child — queue → prefill → handoff → decode, exactly the
    # four TTFT critical-path segments `tools/trace_report.py` sums
    span: object = None
    phase_span: object = None


@dataclasses.dataclass
class _Handoff:
    rid: int
    payload: object                    # models.serving.KVHandoff
    enqueued_at: float


def _flip_first_leaf(cache) -> bool:
    """Corrupt one byte of the first tensor leaf (depth-first, sorted
    keys) — the in-process shape of a truncated copy/DMA error a
    ``HandoffCorrupt`` fault models. Writes a flipped COPY back into the
    tree (the exported leaves may be shared with the sender). Returns
    True once flipped."""
    if not isinstance(cache, dict):
        return False
    for k in sorted(cache):
        child = cache[k]
        if isinstance(child, dict):
            if _flip_first_leaf(child):
                return True
            continue
        if child.numel() == 0:
            continue
        arr = child.clone(memory_format=torch.contiguous_format)
        arr.reshape(-1).view(torch.uint8)[0] ^= 0xFF
        cache[k] = arr
        return True
    return False


class DisaggFleet:
    """See module doc. ``engine_factory(replica_name)`` builds one engine
    per replica — both pools use the same config (KV handoff requires
    it: the adopting engine splices bytes the prefill engine's programs
    produced)."""

    def __init__(self, engine_factory: Callable[[str], object],
                 prefill_replicas: int = 1, decode_replicas: int = 1, *,
                 store: Optional[FleetPrefixStore] = None,
                 replay: Optional[ReplayPolicy] = None,
                 handoff_capacity: int = 16,
                 prefix_bucket_len: int = PAGE_TOKENS,
                 auto_register_prefixes: bool = True,
                 max_auto_prefixes: int = 64,
                 max_queue_depth: Optional[int] = None,
                 replica_metrics: bool = True,
                 metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 tracer=None) -> None:
        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError("each pool needs >= 1 replica, got "
                             f"prefill={prefill_replicas} "
                             f"decode={decode_replicas}")
        if handoff_capacity < 1:
            raise ValueError(f"handoff_capacity must be >= 1, got "
                             f"{handoff_capacity}")
        self._factory = engine_factory
        self._replay = replay or ReplayPolicy()
        self._clock = clock
        self._tracer = ensure_tracer(tracer)
        self.metrics = metrics              # optional FleetMetrics
        self._replica_metrics = replica_metrics
        self.handoff_capacity = handoff_capacity
        self.prefix_bucket_len = prefix_bucket_len
        self._auto_prefix = auto_register_prefixes
        self._max_auto_prefixes = max_auto_prefixes
        self.max_queue_depth = max_queue_depth
        self.store = store if store is not None else FleetPrefixStore(
            metrics=metrics, clock=clock)
        self.replicas: Dict[str, PoolReplica] = {}
        self._ordinals = {POOL_PREFILL: 0, POOL_DECODE: 0}
        self.desired = {POOL_PREFILL: prefill_replicas,
                        POOL_DECODE: decode_replicas}
        self._requests: Dict[int, _DisaggRequest] = {}
        self._by_engine: Dict[tuple, int] = {}   # (replica, engine rid) → rid
        self._pending: List[int] = []            # rids awaiting a prefill seat
        self._handoffs: Deque[_Handoff] = deque()
        self._jobs: Dict[int, object] = {}       # rid → PrefillJob
        self._staged: Dict[int, _Handoff] = {}   # rid → backpressured handoff
        self._newly_terminal: List[int] = []
        # flight-recorder dump reasons noted under the fleet lock,
        # written (file I/O) outside it at the end of step()
        self._deferred_dumps: List[str] = []
        self._next_rid = 0
        self._accepting = True
        self._scaledown: set = set()
        #: stable, wall-clock-free record of handoff/replay/scale events —
        #: the byte-comparable artifact `make disagg-soak` replays
        self.event_log: List[str] = []
        self.stats = {"steps": 0, "routed": 0, "prefills_started": 0,
                      "handoffs_enqueued": 0, "handoffs_adopted": 0,
                      "handoffs_lost": 0, "handoffs_corrupt": 0,
                      "replayed": 0, "retry_exhausted": 0,
                      "engine_crashes": 0, "scale_ups": 0, "scale_downs": 0,
                      # adoptions whose handoff came from an UNLIKE mesh
                      # (the payload's CacheLayout vs the adopting
                      # engine's axes): the splice reshards on import —
                      # exact either way, counted so a cross-mesh pool
                      # pairing is visible on the stats, and the bytes
                      # the export gathers for it are visible on the
                      # prefill engines' export_gather_bytes
                      "handoffs_cross_mesh": 0}
        self._lock = threading.Lock()
        for _ in range(prefill_replicas):
            self._add_replica(POOL_PREFILL)
        for _ in range(decode_replicas):
            self._add_replica(POOL_DECODE)
        probe = next(iter(self.replicas.values())).engine
        self.max_len = probe.max_len

    # ---------------------------------------------------------- replica mgmt
    def _add_replica(self, pool: str) -> PoolReplica:
        name = f"{pool}-{self._ordinals[pool]}"
        self._ordinals[pool] += 1
        engine = self._factory(name)
        rep = PoolReplica(name, pool, engine,
                          ServingMetrics() if self._replica_metrics
                          else None)
        self.replicas[name] = rep
        return rep

    def pool(self, name: str) -> DisaggPool:
        if name not in (POOL_PREFILL, POOL_DECODE):
            raise ValueError(f"unknown pool {name!r}")
        return DisaggPool(self, name)

    def _pool_replicas(self, pool: str, *, ready: bool = False
                       ) -> List[PoolReplica]:
        """Thread-safe snapshot: ``scale_pool`` (the autoscaler's
        thread) inserts into ``self.replicas`` under the lock, so the
        driver thread must not iterate the live dict."""
        with self._lock:
            return self._pool_replicas_locked(pool, ready=ready)

    def _pool_replicas_locked(self, pool: str, *, ready: bool = False
                              ) -> List[PoolReplica]:
        reps = [r for r in self.replicas.values() if r.pool == pool
                and r.state in (ReplicaState.READY, ReplicaState.DRAINING)]
        if ready:
            reps = [r for r in reps if r.routable]
        return sorted(reps, key=lambda r: r.name)

    def pool_queue_depth(self, pool: str) -> int:
        with self._lock:
            if pool == POOL_PREFILL:
                return len(self._pending)
            return len(self._handoffs) + len(self._staged)

    @staticmethod
    def _ordinal(name: str) -> int:
        try:
            return int(name.rsplit("-", 1)[-1])
        except ValueError:
            return -1

    def scale_pool(self, pool: str, n: int) -> int:
        """Resize one pool (the execution half of that pool's autoscaler
        loop). Scale-up adds fresh replicas; scale-down marks the
        highest-ordinal replicas DRAINING — a draining prefill replica
        takes no new job, a draining decode replica takes no new
        handoff; both finish what they hold and are reaped by ``step()``
        when empty (zero silent loss), holding a ready floor of ``n``.
        Returns replicas added (+) or marked draining (-)."""
        if pool not in (POOL_PREFILL, POOL_DECODE):
            raise ValueError(f"unknown pool {pool!r}")
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        with self._lock:
            self.desired[pool] = n
            live = self._pool_replicas_locked(pool)
            ready = [r for r in live if r.state is ReplicaState.READY]
            cur = len(ready)
            if n > cur:
                need = n - cur
                # reclaim still-draining victims first (warm engines)
                for rep in sorted((r for r in live
                                   if r.state is ReplicaState.DRAINING),
                                  key=lambda r: self._ordinal(r.name)):
                    if need <= 0:
                        break
                    rep.state = ReplicaState.READY
                    self._scaledown.discard(rep.name)
                    need -= 1
                for _ in range(need):
                    self._add_replica(pool)
                self.stats["scale_ups"] += 1
                self.event_log.append(f"scale pool={pool} {cur}->{n}")
                return n - cur
            if n == cur:
                return 0
            victims = []
            for rep in sorted(ready, key=lambda r: -self._ordinal(r.name)):
                if len(victims) >= cur - n:
                    break
                victims.append(rep)
            for rep in victims:
                rep.state = ReplicaState.DRAINING
                self._scaledown.add(rep.name)
            if victims:
                self.stats["scale_downs"] += 1
                self.event_log.append(f"scale pool={pool} {cur}->{n}")
            return -len(victims)

    def _reap_scaledown_locked(self) -> None:
        for name in sorted(self._scaledown):
            rep = self.replicas.get(name)
            if rep is None or rep.state is not ReplicaState.DRAINING:
                self._scaledown.discard(name)
                continue
            if rep.pool == POOL_PREFILL:
                idle = not rep.busy
            else:
                idle = not any(r == rep.name for r, _ in self._by_engine)
            if idle:
                rep.state = ReplicaState.STOPPED
                # release the engine (params + KV pool); the store drops
                # this replica's residency so later ensures re-place the
                # prefix on a living engine
                rep.engine = None
                self.store.forget_replica(rep.name)
                self._scaledown.discard(name)

    # ---------------------------------------------------------- frontend API
    def register_prefix(self, tokens) -> str:
        """Make a shared prefix fleet-known (content-addressed, no device
        work yet — `kvstore.FleetPrefixStore.register`)."""
        return self.store.register(tokens)

    def submit(self, prompt, max_new_tokens: int, *,
               tenant: str = "default", priority: int = 0,
               deadline_s: Optional[float] = None,
               eos_id: Optional[int] = None,
               on_token: Optional[Callable[[int, int], None]] = None
               ) -> Union[int, Rejected]:
        """Accept one request into the disaggregated lifecycle; returns
        the fleet request id or a typed ``Rejected``. The prompt's
        longest store-registered prefix (auto-registered
        ``prefix_bucket_len``-token head on first sight) splits it into
        (shared prefix, suffix) — only the suffix is prefilled, on the
        prefill pool."""
        del tenant, priority   # accepted for fleet-API parity
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        if prompt.size + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt {prompt.size} + new {max_new_tokens} exceeds "
                f"the engine's max_len {self.max_len}")
        with self._lock:
            if not self._accepting:
                return Rejected(REASON_DRAINING, "fleet is draining")
            if not self._pool_replicas_locked(POOL_PREFILL, ready=True) \
                    or not self._pool_replicas_locked(POOL_DECODE,
                                                     ready=True):
                return Rejected(REASON_UNAVAILABLE,
                                "a pool has no ready replica",
                                retry_after_hint=1.0)
            if self.max_queue_depth is not None \
                    and len(self._pending) >= self.max_queue_depth:
                return Rejected(REASON_QUEUE_FULL,
                                f"fleet queue at {len(self._pending)}",
                                retry_after_hint=1.0)
            # only ACCEPTED requests may register: store entries are
            # never removed, so a burst of rejected submissions must not
            # consume the auto-registration cap
            blen = self.prefix_bucket_len
            if self._auto_prefix and prompt.size > blen \
                    and blen <= self.max_len - 2 \
                    and len(self.store) < self._max_auto_prefixes:
                # capped (the disagg twin of ServingFleet's
                # max_prefixes_per_replica guard): treating every unique
                # head as a shared prefix would buy a dedicated prefill
                # + KV export/import per single-use prompt. Past the
                # cap, unmatched prompts serve cold; register() is
                # idempotent so already-known heads still match below.
                self.store.register(prompt[:blen])
            m = self.store.match(prompt)
            if m is not None:
                h, plen = m
                suffix = prompt[plen:]
            else:
                h, suffix = None, prompt
            rid = self._next_rid
            self._next_rid += 1
            now = self._clock()
            self._requests[rid] = _DisaggRequest(
                rid=rid, prompt=prompt, suffix=suffix, prefix_hash=h,
                max_new_tokens=max_new_tokens, eos_id=eos_id,
                deadline=(now + deadline_s if deadline_s is not None
                          else None),
                on_token=on_token,
                cost=int(prompt.size) + max_new_tokens,
                submitted_at=now)
            req = self._requests[rid]
            req.span = self._tracer.start(
                "request", rid=rid, prompt_tokens=int(prompt.size),
                suffix_tokens=int(suffix.size),
                max_new_tokens=max_new_tokens,
                prefix_warm=h is not None)
            req.phase_span = self._tracer.start("queue", parent=req.span,
                                                attempt=0)
            self._pending.append(rid)
            self.stats["routed"] += 1
        return rid

    def cancel(self, request_id: int) -> bool:
        with self._lock:
            req = self._requests.get(request_id)
            if req is None or req.state not in LIVE_STATES:
                return False
            req.cancel_requested = True
        return True

    def result(self, request_id: int) -> Optional[RequestResult]:
        with self._lock:
            req = self._requests.get(request_id)
            if req is None or req.state in LIVE_STATES:
                return None
            del self._requests[request_id]
            tokens = (req.tokens if req.tokens is not None
                      else np.zeros(0, np.int32))
            return RequestResult(request_id, req.state, tokens)

    def state(self, request_id: int) -> Optional[RequestState]:
        with self._lock:
            req = self._requests.get(request_id)
            return None if req is None else req.state

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending) + len(self._handoffs) \
                + len(self._staged)

    @property
    def has_live_requests(self) -> bool:
        with self._lock:
            return any(r.state in LIVE_STATES
                       for r in self._requests.values())

    # ------------------------------------------------------------- lifecycle
    def _finalize_locked(self, req: _DisaggRequest, state: RequestState,
                         tokens=None) -> None:
        if req.state not in LIVE_STATES:
            return
        req.state = state
        if tokens is not None:
            req.tokens = np.asarray(tokens, np.int32)
        if req.pinned and req.prefix_hash is not None:
            self.store.unpin(req.prefix_hash)
            req.pinned = False
        if req.phase_span is not None:
            req.phase_span.finish(state.value)
            req.phase_span = None
        if req.span is not None:
            req.span.finish(state.value)
        self._newly_terminal.append(req.rid)

    def _replay_or_exhaust_locked(self, req: _DisaggRequest,
                                  now: float) -> None:
        """A handoff was lost or rejected: the request's KV is gone but
        the request is not — re-run the prefill under the replay budget
        (typed ``RETRY_EXHAUSTED`` past it; greedy decode makes the
        replayed output token-identical)."""
        if req.pinned and req.prefix_hash is not None:
            self.store.unpin(req.prefix_hash)
            req.pinned = False
        if req.phase_span is not None:
            # whatever phase held the KV when it died — the error end
            # keeps the attempt's wall time on the timeline
            req.phase_span.finish(STATUS_ERROR)
            req.phase_span = None
        if req.cancel_requested:
            self._finalize_locked(req, RequestState.CANCELLED)
            return
        if req.deadline is not None and now >= req.deadline:
            self._finalize_locked(req, RequestState.DEADLINE_EXCEEDED)
            return
        if req.replays >= self._replay.max_replays:
            self.stats["retry_exhausted"] += 1
            self.event_log.append(f"exhausted rid={req.rid}")
            self._finalize_locked(req, RequestState.RETRY_EXHAUSTED)
            # defer the flight dump: this runs under the fleet lock, and
            # recorder file I/O must not block every submit()/step()
            self._deferred_dumps.append("retry_exhausted")
            return
        req.replays += 1
        req.state = RequestState.QUEUED
        req.prefill_replica = None
        req.first_token_at = None
        req.decode_t0 = None
        req.n_decode_tokens = 0
        if req.span is not None:
            req.span.event("replay", n=req.replays)
        req.phase_span = self._tracer.start("queue", parent=req.span,
                                            attempt=req.replays)
        self.stats["replayed"] += 1
        if self.metrics is not None:
            self.metrics.inc("requests_replayed")
        self.event_log.append(f"replay rid={req.rid} n={req.replays}")
        self._pending.append(req.rid)

    def _reap_locked(self, now: float) -> None:
        """Cancels and deadline expiries, wherever the request lives.
        Driver thread only (decode aborts touch slot state)."""
        for rid in list(self._pending):
            req = self._requests[rid]
            if req.cancel_requested or (req.deadline is not None
                                        and now >= req.deadline):
                self._pending.remove(rid)
                self._finalize_locked(
                    req, RequestState.CANCELLED if req.cancel_requested
                    else RequestState.DEADLINE_EXCEEDED)
        for rid in list(self._jobs):
            req = self._requests[rid]
            if req.cancel_requested or (req.deadline is not None
                                        and now >= req.deadline):
                del self._jobs[rid]
                rep = self.replicas[req.prefill_replica]
                rep.job = None
                rep.outstanding -= req.cost
                self._finalize_locked(
                    req, RequestState.CANCELLED if req.cancel_requested
                    else RequestState.DEADLINE_EXCEEDED)
        for rid in list(self._staged):
            req = self._requests[rid]
            if req.cancel_requested or (req.deadline is not None
                                        and now >= req.deadline):
                del self._staged[rid]
                rep = self.replicas[req.prefill_replica]
                rep.staged = None
                rep.outstanding -= req.cost
                self._finalize_locked(
                    req, RequestState.CANCELLED if req.cancel_requested
                    else RequestState.DEADLINE_EXCEEDED)
        for ho in list(self._handoffs):
            req = self._requests[ho.rid]
            if req.cancel_requested or (req.deadline is not None
                                        and now >= req.deadline):
                self._handoffs.remove(ho)
                self._finalize_locked(
                    req, RequestState.CANCELLED if req.cancel_requested
                    else RequestState.DEADLINE_EXCEEDED)
        for (rname, erid), rid in list(self._by_engine.items()):
            req = self._requests[rid]
            if req.state not in LIVE_STATES:
                continue
            if req.cancel_requested or (req.deadline is not None
                                        and now >= req.deadline):
                rep = self.replicas[rname]
                partial = rep.engine.abort(erid)
                if partial is None:
                    continue
                del self._by_engine[(rname, erid)]
                rep.outstanding -= req.cost
                self._finalize_locked(
                    req, RequestState.CANCELLED if req.cancel_requested
                    else RequestState.DEADLINE_EXCEEDED, partial)

    # --------------------------------------------------------- prefill phase
    def _assign_prefills_locked(self, now: float) -> List[int]:
        """Seat pending requests on free, READY prefill replicas (lowest
        rid first — replays re-enter with their original id, so a
        crash-delayed request keeps its place). Returns the rids seated;
        the device work (prefix ensure + job creation) runs after the
        lock drops."""
        seated = []
        free = [r for r in self._pool_replicas_locked(POOL_PREFILL,
                                                       ready=True)
                if not r.busy]
        self._pending.sort()
        while free and self._pending:
            rid = self._pending.pop(0)
            req = self._requests[rid]
            rep = min(free, key=lambda r: (r.outstanding, r.name))
            free.remove(rep)
            req.state = RequestState.PREFILLING
            req.prefill_replica = rep.name
            if req.phase_span is not None:
                req.phase_span.finish()
                req.phase_span = self._tracer.start(
                    "prefill", parent=req.span, replica=rep.name,
                    attempt=req.replays)
            rep.job = rid
            rep.routed += 1
            rep.outstanding += req.cost
            if rep.metrics is not None and not req.queue_wait_observed:
                req.queue_wait_observed = True
                rep.metrics.observe("queue_wait_seconds",
                                    now - req.submitted_at)
            seated.append(rid)
            self.stats["prefills_started"] += 1
        return seated

    def _start_job(self, rid: int) -> None:
        """Create the PrefillJob for a just-seated request (device work:
        the prefix ensure may prefill or import KV)."""
        req = self._requests[rid]
        rep = self.replicas[req.prefill_replica]
        pid = None
        if req.prefix_hash is not None:
            pid = self.store.ensure(rep.name, rep.engine, req.prefix_hash)
        self._jobs[rid] = rep.engine.start_prefill(req.suffix, pid)

    def _advance_prefills(self, now: float) -> None:
        """One chunk per busy prefill replica per step (mirroring the
        monolithic engine's one-chunk-per-step cadence), then move
        finished jobs toward the handoff queue."""
        for rep in self._pool_replicas(POOL_PREFILL):
            rid = rep.job
            if rid is None:
                continue
            job = self._jobs.get(rid)
            if job is None:
                continue
            if not job.advance():
                continue
            del self._jobs[rid]
            with self._lock:
                req = self._requests[rid]
                rep.job = None
                if req.state is not RequestState.PREFILLING:
                    rep.outstanding -= req.cost
                    continue               # cancelled while prefilling
                req.first_token_at = now
                # once per REQUEST, not per attempt: a replayed prefill
                # measures from the original submitted_at, and
                # double-counting the largest sample would skew ttft_p95
                # toward spurious pool scale-ups. The span event shares
                # the flag — the trace's first_token anchor is the
                # client's first token, not a replay's re-emission.
                first = not req.ttft_observed
                req.ttft_observed = True
                if first and req.span is not None:
                    req.span.event("first_token")
                if req.phase_span is not None:
                    req.phase_span.finish()
                    req.phase_span = None
                if rep.metrics is not None:
                    if first:
                        rep.metrics.observe(
                            "time_to_first_token_seconds",
                            now - req.submitted_at,
                            exemplar=(req.span.trace_id or None)
                            if req.span is not None else None)
                    rep.metrics.inc("tokens_emitted")
            self._fire_token(req, job.first_token)
            payload = job.handoff(
                suffix_only=req.prefix_hash is not None,
                prefix_hash=req.prefix_hash)
            done = (len(payload.emitted) >= req.max_new_tokens
                    or (req.eos_id is not None
                        and payload.first_token == req.eos_id))
            # the injector runs OUTSIDE the fleet lock: an injected
            # fault's trigger/event bookkeeping must never execute (or
            # raise) while holding it. Same call cadence — once per
            # non-done prefill completion — so seeded schedules land on
            # the same requests as before.
            fault = (None if done else
                     chaos.fire(chaos.SITE_KV_HANDOFF, rid=rid,
                                replica=rep.name))
            with self._lock:
                if done:
                    # the prefill's own sampled token already satisfied
                    # the request: no decode phase, no handoff
                    rep.outstanding -= req.cost
                    self._finalize_locked(req, RequestState.DONE,
                                          payload.emitted)
                    continue
                if isinstance(fault, chaos.HandoffLoss):
                    rep.outstanding -= req.cost
                    self.stats["handoffs_lost"] += 1
                    if self.metrics is not None:
                        self.metrics.inc("handoffs_lost")
                    self.event_log.append(f"handoff_lost rid={rid}")
                    if req.span is not None:
                        req.span.event("chaos", fault=fault.kind)
                    self._replay_or_exhaust_locked(req, now)
                    continue
                if isinstance(fault, chaos.HandoffCorrupt):
                    # flipped bytes in transfer: the payload still
                    # travels — the adopting replica's checksum is the
                    # defense under test
                    _flip_first_leaf(payload.cache)
                    self.event_log.append(f"handoff_corrupt rid={rid}")
                    if req.span is not None:
                        req.span.event("chaos", fault=fault.kind)
                if req.prefix_hash is not None and not req.pinned:
                    self.store.pin(req.prefix_hash)
                    req.pinned = True
                req.phase_span = self._tracer.start(
                    "handoff", parent=req.span, attempt=req.replays)
                ho = _Handoff(rid, payload, now)
                if len(self._handoffs) >= self.handoff_capacity:
                    # bounded queue: stage on the replica (which takes no
                    # new job until this drains) — backpressure, not an
                    # unbounded buffer
                    rep.staged = rid
                    self._staged[rid] = ho
                    req.state = RequestState.HANDOFF
                    req.phase_span.set(staged=True)
                    continue
                rep.outstanding -= req.cost
                self._enqueue_handoff_locked(ho, req)

    def _enqueue_handoff_locked(self, ho: _Handoff,
                                req: _DisaggRequest) -> None:
        self._handoffs.append(ho)
        req.state = RequestState.HANDOFF
        self.stats["handoffs_enqueued"] += 1
        if self.metrics is not None:
            self.metrics.inc("handoffs_enqueued")
        self.event_log.append(
            f"handoff_enqueued rid={ho.rid} depth={len(self._handoffs)}")

    def _drain_staged_locked(self) -> None:
        """Move backpressured handoffs into freed queue room (rid order —
        the oldest staged work first)."""
        for rid in sorted(self._staged):
            if len(self._handoffs) >= self.handoff_capacity:
                return
            ho = self._staged.pop(rid)
            req = self._requests[rid]
            rep = self.replicas[req.prefill_replica]
            rep.staged = None
            rep.outstanding -= req.cost
            if req.state is not RequestState.HANDOFF:
                continue
            self._enqueue_handoff_locked(ho, req)

    # ---------------------------------------------------------- decode phase
    def _dispatch_handoffs(self, now: float) -> None:
        """FIFO over the handoff queue: verify the transfer checksum,
        pick the decode replica by KV locality (prefix residency first,
        then least outstanding), ensure the prefix resident there (a
        host→device promote in the common case — zero prefill FLOPs on
        the decode pool), and splice via ``submit_kv``."""
        budgets: Dict[str, int] = {}    # slots not yet claimed this pass
        while True:
            with self._lock:
                if not self._handoffs:
                    return
                ready = []
                for r in self._pool_replicas_locked(POOL_DECODE,
                                                    ready=True):
                    if r.name not in budgets:
                        # free_slots does not count the engine's own
                        # kv-pending queue, so claim slots HERE — without
                        # the budget one pass could pile every handoff
                        # onto a single replica
                        budgets[r.name] = r.engine.free_slots
                    if budgets[r.name] > 0:
                        ready.append(r)
                if not ready:
                    return
                ho = self._handoffs.popleft()
                req = self._requests[ho.rid]
                if req.state is not RequestState.HANDOFF:
                    continue
                if not ho.payload.verify():
                    self.stats["handoffs_corrupt"] += 1
                    if self.metrics is not None:
                        self.metrics.inc("handoffs_corrupt")
                    self.event_log.append(
                        f"handoff_rejected rid={ho.rid} checksum")
                    if req.span is not None:
                        req.span.event("handoff_rejected",
                                       reason="checksum")
                    self._replay_or_exhaust_locked(req, now)
                    continue
                if req.prefix_hash is not None:
                    resident = set(self.store.resident_on(req.prefix_hash))
                    local = [r for r in ready if r.name in resident]
                    pool = local or ready
                else:
                    pool = ready
                rep = min(pool, key=lambda r: (r.outstanding, r.name))
                budgets[rep.name] -= 1
            # device work outside the lock: prefix promote + cache splice
            try:
                pid = None
                if req.prefix_hash is not None:
                    pid = self.store.ensure(rep.name, rep.engine,
                                            req.prefix_hash)
                erid = rep.engine.submit_kv(
                    ho.payload, req.max_new_tokens, eos_id=req.eos_id,
                    prefix_id=pid if ho.payload.base > 0 else None,
                    on_token=self._wrap_on_token(req))
            # analyze: allow[silent-loss] handoff is re-queued at head below — deferral IS the handling, nothing terminal here
            except Exception as e:  # noqa: BLE001 — engine refusal/crash
                # the popped handoff must NOT be stranded (it lives in no
                # scanned container — the request could never reach a
                # terminal state): put it back at the queue head and end
                # the pass. Transient refusals (EngineOverloadedError
                # from a queue-capped engine — free_slots can't see the
                # engine's own kv-pending queue) clear as slots drain;
                # a stalled replica's requests exit via the deadline reap
                # which scans self._handoffs.
                with self._lock:
                    self._handoffs.appendleft(ho)
                    self.event_log.append(
                        f"adopt_deferred rid={req.rid} "
                        f"replica={rep.name} {type(e).__name__}")
                    if req.span is not None:
                        req.span.event("adopt_deferred", replica=rep.name,
                                       error=type(e).__name__)
                return
            with self._lock:
                req.state = RequestState.DECODING
                req.decode_replica = rep.name
                req.engine_rid = erid
                if req.phase_span is not None:
                    req.phase_span.finish()
                    req.phase_span = self._tracer.start(
                        "decode", parent=req.span, replica=rep.name,
                        attempt=req.replays)
                rep.routed += 1
                rep.outstanding += req.cost
                self._by_engine[(rep.name, erid)] = req.rid
                self.stats["handoffs_adopted"] += 1
                src = (dict(ho.payload.layout.mesh_axes)
                       if ho.payload.layout is not None else {})
                if src != dict(getattr(rep.engine, "mesh_axes", {}) or {}):
                    # unlike meshes: reshard-on-import did real layout
                    # work (not in the event log — the count is new, the
                    # prior seeded soaks' logs must stay byte-identical)
                    self.stats["handoffs_cross_mesh"] += 1
                if self.metrics is not None:
                    self.metrics.inc("handoffs_adopted")
                    self.metrics.observe("handoff_wait_seconds",
                                         now - ho.enqueued_at)
                self.event_log.append(
                    f"adopt rid={req.rid} replica={rep.name}")

    def _wrap_on_token(self, req: _DisaggRequest):
        def hook(_erid: int, token: int) -> None:
            now = self._clock()
            with self._lock:
                if req.decode_t0 is None:
                    req.decode_t0 = now
                    if req.phase_span is not None:
                        # the decode pool's first emission: with the
                        # first_token (prefill) event, this bounds the
                        # handoff's full latency contribution
                        req.phase_span.event("first_decode_token")
                req.last_token_at = now
                req.n_decode_tokens += 1
            rep = (self.replicas.get(req.decode_replica)
                   if req.decode_replica else None)
            if rep is not None and rep.metrics is not None:
                rep.metrics.inc("tokens_emitted")
            self._fire_token(req, token)
        return hook

    def _fire_token(self, req: _DisaggRequest, token: int) -> None:
        if req.on_token is None:
            return
        try:
            req.on_token(req.rid, int(token))
        except Exception as e:  # noqa: BLE001 — isolate per-request faults
            req.on_token = None
            count_detached_callback(
                self.metrics,
                f"on_token callback for request {req.rid} raised "
                f"{type(e).__name__}: {e}; streaming detached")

    def _step_decode(self, now: float) -> None:
        for rep in self._pool_replicas(POOL_DECODE):
            if rep.engine is None:
                continue
            try:
                finished = rep.engine.step()
            except EngineCrashError:
                dropped = rep.engine.reset()
                self.stats["engine_crashes"] += 1
                with self._lock:
                    for erid in dropped:
                        rid = self._by_engine.pop((rep.name, erid), None)
                        if rid is None:
                            continue
                        req = self._requests[rid]
                        rep.outstanding -= req.cost
                        self.event_log.append(f"decode_crash rid={rid}")
                        if req.span is not None:
                            req.span.event("engine_crash",
                                           replica=rep.name)
                        self._replay_or_exhaust_locked(req, now)
                self._tracer.crash_dump("engine_crash")
                continue
            for erid in finished:
                tokens = rep.engine.result(erid)
                with self._lock:
                    rid = self._by_engine.pop((rep.name, erid), None)
                    if rid is None:
                        continue
                    req = self._requests[rid]
                    rep.outstanding -= req.cost
                    if rep.metrics is not None:
                        rep.metrics.inc("requests_finished")
                        if req.n_decode_tokens >= 2 \
                                and req.decode_t0 is not None:
                            # decode-phase cadence: time per token across
                            # the DECODE pool's own emissions (the first
                            # token is the prefill pool's; the handoff
                            # wait belongs to TTFT, not TPOT)
                            rep.metrics.observe(
                                "time_per_output_token_seconds",
                                (req.last_token_at - req.decode_t0)
                                / (req.n_decode_tokens - 1),
                                exemplar=(req.span.trace_id or None)
                                if req.span is not None else None)
                    self._finalize_locked(req, RequestState.DONE, tokens)

    # --------------------------------------------------------------- driver
    def step(self) -> List[int]:
        """One fleet iteration: reap cancels/deadlines, seat prefills,
        advance each prefill replica one chunk, move finished KV through
        the (chaos-injectable) handoff queue, splice into decode slots
        by KV locality, advance every decode engine one step. Returns
        fleet ids newly terminal."""
        now = self._clock()
        with self._lock:
            self._reap_locked(now)
            self._reap_scaledown_locked()
            seated = self._assign_prefills_locked(now)
        for rid in seated:
            self._start_job(rid)
        self._advance_prefills(now)
        with self._lock:
            self._drain_staged_locked()
        self._dispatch_handoffs(now)
        self._step_decode(now)
        with self._lock:
            self._drain_staged_locked()
            self.stats["steps"] += 1
            out, self._newly_terminal = self._newly_terminal, []
            dumps, self._deferred_dumps = self._deferred_dumps, []
            self._refresh_gauges_locked()
        # one dump per distinct reason per step, outside the lock (a
        # burst of exhaustions shares one ring snapshot anyway)
        for reason in dict.fromkeys(dumps):
            self._tracer.crash_dump(reason)
        return out

    def _refresh_gauges_locked(self) -> None:
        if self.metrics is None:
            return
        self.metrics.set_gauge("handoff_queue_depth",
                               len(self._handoffs) + len(self._staged))
        for pool in (POOL_PREFILL, POOL_DECODE):
            reps = self._pool_replicas_locked(pool)
            self.metrics.set_gauge(
                "pool_replicas_ready",
                sum(r.routable for r in reps), pool=pool)
            self.metrics.set_gauge(
                "pool_queue_depth",
                len(self._pending) if pool == POOL_PREFILL
                else len(self._handoffs) + len(self._staged), pool=pool)
            self.metrics.set_gauge(
                "pool_inflight_tokens",
                sum(r.outstanding for r in reps), pool=pool)
            self.metrics.set_gauge(
                "pool_slots",
                sum(getattr(r.engine, "n_slots", 0) for r in reps
                    if r.engine is not None), pool=pool)
        self.metrics.set_gauge("prefix_store_overflow_bytes",
                               self.store.stats["overflow_bytes"])
        for name, key in (("prefix_store_hits", "hits"),
                          ("prefix_store_misses", "misses"),
                          ("prefix_store_promotes", "promotes"),
                          ("prefix_store_evictions", "evictions"),
                          ("prefix_store_demotes", "demotes")):
            want = self.store.stats[key]
            have = self.metrics.counters.get((name, ""), 0)
            if want > have:
                self.metrics.inc(name, want - have)

    def run(self) -> Dict[int, RequestResult]:
        """Step until every accepted request is terminal; claim and
        return all unclaimed results."""
        while self.has_live_requests:
            self.step()
        return self._claim_all()

    def stop_accepting(self) -> None:
        with self._lock:
            self._accepting = False

    def drain(self, timeout_s: Optional[float] = None
              ) -> Dict[int, RequestResult]:
        """Graceful shutdown: stop accepting, finish in-flight work in
        both pools and the handoff queue, cancel stragglers past
        ``timeout_s`` (typed, partial tokens kept)."""
        self.stop_accepting()
        deadline = (self._clock() + timeout_s if timeout_s is not None
                    else None)
        while self.has_live_requests:
            if deadline is not None and self._clock() >= deadline:
                with self._lock:
                    for req in self._requests.values():
                        if req.state in LIVE_STATES:
                            req.cancel_requested = True
            self.step()
        return self._claim_all()

    def _claim_all(self) -> Dict[int, RequestResult]:
        with self._lock:
            done = [rid for rid, r in self._requests.items()
                    if r.state not in LIVE_STATES]
            out = {}
            for rid in done:
                req = self._requests.pop(rid)
                tokens = (req.tokens if req.tokens is not None
                          else np.zeros(0, np.int32))
                out[rid] = RequestResult(rid, req.state, tokens)
            return out

    # --------------------------------------------------------- observability
    def pool_observation_line(self, pool: str) -> str:
        """One extended observation line for ONE pool (same format the
        monolithic fleet emits, same delta-window semantics) — what a
        pod in that pool would print for the log-scraping autoscaler
        plane. The in-process plane scrapes ``pool(name)`` directly."""
        scrapers = getattr(self, "_obs_scrapers", None)
        if scrapers is None:
            scrapers = self._obs_scrapers = {}
        if pool not in scrapers:
            scrapers[pool] = FleetScraper()
        s = scrapers[pool].scrape(self.pool(pool))
        return format_observation_line(s, epoch=0,
                                       batch=self.stats["steps"])
