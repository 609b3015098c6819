"""Fleet router: prefix-affinity consistent hashing + bounded load.

The front door of a multi-replica serving fleet. Three concerns, applied
in order per request:

1. **Version split** (canary / rollout weights) — traffic divides across
   model *versions* by configured weight using the coordinator's own
   smooth-WRR core (`coordinator/policy.SmoothWRR`): deterministic, no
   sampling noise, and a 10% canary gets *exactly* every 10th request,
   not 10% in expectation. Versions with no ready replica are excluded
   (their weight redistributes).
2. **Prefix affinity** — requests whose prompts share the same
   ``prefix_bucket_len``-token prefix hash to the same replica on a
   consistent-hash ring (virtual nodes, so adding/removing a replica
   remaps only ~1/N of the key space). The engine's prefix cache
   (`models/serving.register_prefix`) is per replica and device-resident:
   landing a repeated prefix on the replica that already holds its KV
   turns the shared-prefix prefill into a cache hit instead of
   recomputing it cold — the single biggest TTFT lever for
   system-prompt-heavy traffic.
3. **Bounded load** — affinity yields when it would overload: if the
   affinity replica's outstanding decode tokens exceed the least-loaded
   candidate's by more than ``spill_tokens``, the request spills to the
   **least-outstanding-tokens** replica instead ("consistent hashing
   with bounded loads"). Outstanding tokens (prompt + max_new of every
   live request) rather than request count, because a 4-token and a
   2048-token request are not the same unit of work.

``mode="random"`` replaces 2–3 with a seeded uniform pick — the control
arm the prefix-affinity acceptance test compares against.

**Model multiplexing** (`route_model`) stacks a fourth concern UNDER the
three above when replicas host several models behind a ``ModelPool``
(`serve/modelpool.py`): the affinity key is salted with the model id, so
each model's traffic coheres onto its own ring point — batching a
model's requests on few replicas is what lets the pool's swap scheduler
amortize one swap-in across a whole lane instead of paying it per
request. Candidate replicas are first filtered to those whose pool
already holds the model **resident** (`set_resident`, fed from
``ModelPool.resident_models``): a resident landing is a params pointer
swap at worst and a no-op at best, while a non-resident landing pays a
cold weight load plus an eviction elsewhere. Only when no ready replica
holds the model resident does routing fall back to the full ready set —
somebody has to take the cold swap, and the ring decides whom
deterministically.

The router holds no request state; the fleet feeds it the ready set and
per-replica outstanding tokens each call, so it is trivially correct
under replica churn (ejection, rollout surge/drain).
"""
from __future__ import annotations

import bisect
import hashlib
import random
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from tpu_on_k8s_torch.coordinator.policy import SmoothWRR
from tpu_on_k8s_torch.serve.kvstore import PAGE_TOKENS


def _hash64(data: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(data, digest_size=8).digest(),
                          "big")


class Router:
    """Pure routing policy (no request state). Not thread-safe on its
    own; the fleet serializes access under its lock, exactly as the
    gateway does with its scheduler."""

    def __init__(self, prefix_bucket_len: int = PAGE_TOKENS, *,
                 virtual_nodes: int = 64, spill_tokens: int = 1024,
                 mode: str = "affinity", seed: int = 0) -> None:
        if prefix_bucket_len < 1:
            raise ValueError(f"prefix_bucket_len must be >= 1, got "
                             f"{prefix_bucket_len}")
        if virtual_nodes < 1:
            raise ValueError(f"virtual_nodes must be >= 1, got "
                             f"{virtual_nodes}")
        if spill_tokens < 0:
            raise ValueError(f"spill_tokens must be >= 0, got "
                             f"{spill_tokens}")
        if mode not in ("affinity", "random"):
            raise ValueError(f"mode must be 'affinity' or 'random', got "
                             f"{mode!r}")
        self.prefix_bucket_len = prefix_bucket_len
        self.virtual_nodes = virtual_nodes
        self.spill_tokens = spill_tokens
        self.mode = mode
        self._rng = random.Random(seed)
        self._replicas: Dict[str, str] = {}        # name → version
        self._ring: List[Tuple[int, str]] = []     # (point, name), sorted
        self._weights: Dict[str, float] = {}       # version → weight
        #: name → chip count: a mesh-sharded replica spans several chips
        #: and absorbs proportionally more outstanding tokens, so the
        #: bounded-load comparison runs on tokens PER CHIP. Default 1
        #: everywhere keeps single-chip fleets bit-for-bit unchanged.
        self._capacity: Dict[str, float] = {}
        self._wrr = SmoothWRR()
        #: registered shared-prefix contents, keyed by length: the
        #: affinity key prefers these over the raw head bucket
        self._prefix_keys: Dict[int, set] = {}
        #: replica → models its pool holds resident (`set_resident`);
        #: absent = single-model replica, eligible for every model
        self._resident: Dict[str, frozenset] = {}

    # ------------------------------------------------------------- topology
    def add_replica(self, name: str, version: str) -> None:
        if name in self._replicas:
            raise ValueError(f"replica {name!r} already registered")
        self._replicas[name] = version
        for v in range(self.virtual_nodes):
            point = _hash64(f"{name}#{v}".encode())
            bisect.insort(self._ring, (point, name))
        self._weights.setdefault(version, 1.0)

    def set_capacity(self, name: str, chips: int) -> None:
        """Declare ``name``'s chip count (a mesh-sharded replica's mesh
        size). Load balancing then compares outstanding tokens per chip,
        so during a reshard rollout a 4-chip replica legitimately holds
        4× a 1-chip replica's tokens before the ring spills."""
        if chips < 1:
            raise ValueError(f"chips must be >= 1, got {chips}")
        self._capacity[name] = float(chips)

    def capacity_of(self, name: str) -> float:
        """``name``'s declared chip count (1.0 when never declared) —
        the capacity weight the cost accountant
        (`tpu_on_k8s/obs/account.ServingAccountant`) attributes
        chip-seconds with, read from the same source the bounded-load
        comparison uses."""
        return self._capacity.get(name, 1.0)

    def _load(self, name: str, outstanding: Mapping[str, int]) -> float:
        return outstanding.get(name, 0) / self._capacity.get(name, 1.0)

    def set_resident(self, name: str, models: Iterable[str]) -> None:
        """Declare which models ``name``'s pool currently holds resident
        (`ModelPool.resident_models`). The fleet refreshes this after
        every pool step — residency drifts as pools evict — and
        ``route_model`` prefers resident replicas so a request rarely
        pays a cold weight load."""
        self._resident[name] = frozenset(models)

    def resident_of(self, name: str) -> frozenset:
        """Models declared resident on ``name`` (empty when never
        declared — which ``route_model`` reads as 'hosts anything')."""
        return self._resident.get(name, frozenset())

    def remove_replica(self, name: str) -> None:
        self._capacity.pop(name, None)
        self._resident.pop(name, None)
        if self._replicas.pop(name, None) is None:
            return
        self._ring = [(p, n) for p, n in self._ring if n != name]

    def set_weights(self, weights: Mapping[str, float]) -> None:
        """Traffic share per version (relative; normalized at pick time).
        Zero/negative-weight versions receive nothing."""
        self._weights = {v: float(w) for v, w in weights.items()}

    @property
    def weights(self) -> Dict[str, float]:
        return dict(self._weights)

    def version_of(self, name: str) -> Optional[str]:
        return self._replicas.get(name)

    # -------------------------------------------------------------- routing
    def note_prefix(self, tokens) -> int:
        """Teach the router a REGISTERED prefix's content, so the
        affinity key for any prompt starting with it becomes the
        prefix's own content hash rather than the raw
        ``prefix_bucket_len``-token head. Without this, two prompts
        sharing a registered prefix SHORTER than the bucket hash to
        different ring points (their heads differ past the prefix) and
        land on different replicas — missing the warm cache the prefix
        was registered to provide. Returns the key it will produce."""
        head = np.asarray(tokens, np.int32).reshape(-1)
        if head.size == 0:
            raise ValueError("empty prefix")
        key = _hash64(head.tobytes())
        self._prefix_keys.setdefault(int(head.size), set()).add(key)
        return key

    def match_prefix(self, prompt) -> Optional[Tuple[int, int]]:
        """``(key, length)`` of the LONGEST noted prefix the prompt
        starts with, or None. The length matters as much as the key: a
        fleet must split warm submissions at the MATCHED prefix's
        boundary, not the raw bucket — two prompts sharing a noted
        prefix may differ anywhere past it."""
        head = np.asarray(prompt, np.int32).reshape(-1)
        for length in sorted(self._prefix_keys, reverse=True):
            if head.size < length:
                continue
            key = _hash64(head[:length].tobytes())
            if key in self._prefix_keys[length]:
                return key, length
        return None

    def bucket_key(self, prompt) -> int:
        """Stable affinity key: the content hash of the LONGEST noted
        prefix the prompt starts with (`note_prefix`), falling back to
        the hash of the prompt's first ``prefix_bucket_len`` tokens (the
        whole prompt when shorter) — the unit the engine's prefix cache
        is warmed at. A noted prefix of exactly ``prefix_bucket_len``
        tokens produces the identical key the raw head would, so noting
        the fleet's auto-registered buckets changes nothing."""
        m = self.match_prefix(prompt)
        if m is not None:
            return m[0]
        return self.head_key(prompt)

    def head_key(self, prompt) -> int:
        """The raw-head fallback of ``bucket_key`` — for callers that
        already ran ``match_prefix`` themselves and know it missed
        (``bucket_key`` would repeat the whole scan)."""
        head = np.asarray(prompt, np.int32).reshape(-1)
        return _hash64(head[:self.prefix_bucket_len].tobytes())

    def affinity(self, prompt) -> Tuple[Optional[Tuple[int, int]], int]:
        """One noted-prefix scan yielding BOTH routing inputs:
        ``(match_prefix result, bucket key)``. The fleet's submit and
        re-dispatch paths pass the key into ``route`` and the match
        into their prefix plan, so each request pays the scan once."""
        m = self.match_prefix(prompt)
        return m, (m[0] if m is not None else self.head_key(prompt))

    def route(self, prompt, ready: Sequence[str],
              outstanding: Mapping[str, int],
              exclude: Iterable[str] = (),
              key: Optional[int] = None) -> Optional[str]:
        """Pick a replica for ``prompt`` among ``ready`` (minus
        ``exclude``), or None when no candidate exists. ``outstanding``
        maps replica → in-flight token cost (missing = 0). ``key`` is a
        precomputed ``bucket_key(prompt)`` — callers that already ran
        the noted-prefix scan pass it so routing doesn't repeat it."""
        banned = set(exclude)
        candidates = [r for r in ready if r not in banned]
        if not candidates:
            return None
        by_version: Dict[str, List[str]] = {}
        for r in candidates:
            by_version.setdefault(self._replicas.get(r, ""), []).append(r)
        live_weights = {v: w for v, w in self._weights.items()
                        if w > 0 and v in by_version}
        if live_weights:
            pool = by_version[self._wrr.pick(live_weights)]
        else:
            # no weighted version has a ready replica (all weights stale
            # after churn): serve from whatever is up rather than 503
            pool = candidates
        if self.mode == "random":
            return pool[self._rng.randrange(len(pool))]
        # per-chip load: outstanding tokens normalized by replica chip
        # count (``set_capacity``); all-1 capacities reduce to the raw
        # token comparison bit-for-bit
        least = min(pool, key=lambda r: (self._load(r, outstanding), r))
        aff = self._ring_lookup(
            self.bucket_key(prompt) if key is None else key, pool)
        if aff is None:
            return least
        if (self._load(aff, outstanding)
                > self._load(least, outstanding) + self.spill_tokens):
            return least                      # bounded load: spill
        return aff

    # --------------------------------------------------- model multiplexing
    def model_key(self, model: str, key: int) -> int:
        """Salt a prefix-affinity ``key`` with the model id. Two models'
        identical prompts must NOT share a ring point: the prefix KV
        under model A's params is useless (and unsafe) for model B, and
        keeping each model's traffic on its own point is what batches a
        lane for the pool's swap scheduler."""
        return _hash64(model.encode() + key.to_bytes(8, "big"))

    def route_model(self, model: str, prompt, ready: Sequence[str],
                    outstanding: Mapping[str, int],
                    exclude: Iterable[str] = (),
                    key: Optional[int] = None) -> Optional[str]:
        """``route`` for a multi-model fleet: prefer ready replicas whose
        pool holds ``model`` resident (a warm landing), fall back to the
        whole ready set when none does (someone must take the cold
        swap). Replicas with no declared residency count as hosting
        everything — a single-model fleet behaves exactly as ``route``
        with a model-salted key. ``key`` is a precomputed
        ``bucket_key(prompt)`` (UNsalted; salting happens here)."""
        banned = set(exclude)
        candidates = [r for r in ready if r not in banned]
        warm = [r for r in candidates
                if (res := self._resident.get(r)) is None or model in res]
        pool = warm or candidates
        raw = self.bucket_key(prompt) if key is None else key
        return self.route(prompt, pool, outstanding,
                          key=self.model_key(model, raw))

    def _ring_lookup(self, key: int, candidates: Sequence[str]
                     ) -> Optional[str]:
        """First ring point at/after ``key`` owned by a candidate
        (wrapping). O(ring) worst case when few candidates remain —
        fine at fleet scale."""
        if not self._ring:
            return None
        want = set(candidates)
        n = len(self._ring)
        start = bisect.bisect_left(self._ring, (key, ""))
        for i in range(n):
            _, name = self._ring[(start + i) % n]
            if name in want:
                return name
        return None
