"""FleetPrefixStore: one shared prefix/KV tier for a whole serving fleet.

`models/serving.register_prefix` is per-engine and device-resident: every
replica that meets a shared system prompt pays its own prefill and its
own HBM. At fleet scale that multiplies the single biggest shared cost in
prefix-heavy traffic by the replica count — and the router's consistent
hash only *reduces* the multiplier, it cannot make the work happen once.

This store promotes prefix registration to a fleet-level concern:

* **Content addressing** — a prefix is its token content's blake2b hash,
  so two replicas (or two requests) naming the same bytes name the same
  entry; registration is idempotent and per-replica engine prefix ids
  become residency bookkeeping, not identity.
* **Per-replica residency** — ``ensure(replica, engine, h)`` answers
  "make this prefix usable on that engine" three ways, in cost order:
  already registered there (**hit**, free); present in the host-RAM
  overflow tier (**promote**: a host→device copy via
  ``engine.import_prefix`` — bandwidth, not FLOPs); nowhere (**miss**:
  one real prefill via ``engine.register_prefix``, exported into the
  overflow tier so the fleet never computes it again). The miss counter
  IS the fleet-wide prefix-prefill recomputation count the disagg
  acceptance test compares against the monolithic fleet.
* **Host-RAM overflow tier** — byte-budgeted LRU over host copies.
  Eviction drops the host bytes (token content survives, so a later miss
  can recompute) and NEVER touches an entry with live pins — a pinned
  prefix backs in-flight decode work (a handoff mid-queue, a request
  mid-adopt) and evicting it could force a recompute mid-request or, for
  a suffix-only handoff, strand the transfer entirely.
* **Device demotion** — engines hold at most
  ``max_device_prefixes`` registered prefixes; registering past the cap
  demotes the replica's least-recently-ensured unpinned prefix
  (``engine.drop_prefix`` — the host copy lives on, so demotion costs a
  future promote, never a recompute).

Determinism: recency is a monotone operation counter, never wall time —
the injectable ``clock`` only stamps metadata — so the same operation
sequence produces the same evictions/promotions/demotions bit-for-bit
(the property `tests/test_torch_serve_disagg.py` pins against the
reference's store).

Payloads are the engine's ``export_prefix`` dicts of host torch tensors
(often bf16, which numpy cannot hold): page chunks are sliced, copied and
concatenated with torch and counted as ``numel() * element_size()``. Token
arrays and content hashes stay numpy int32, so a prefix's address equals
the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# pages and position buckets are one granule by construction
from tpu_on_k8s_torch.models.decode import PAGE_TOKENS
from tpu_on_k8s_torch.models.layouts import CacheLayout


def prefix_hash(tokens) -> str:
    """Content address of a prefix: blake2b over its int32 token bytes."""
    arr = np.asarray(tokens, np.int32).reshape(-1)
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()


class _RadixNode:
    """One node of the compressed token trie over registered prefixes.
    ``edge`` is the token run on the incoming edge; ``hash`` is set iff a
    registered prefix ends exactly here (insertion splits edges, so every
    registered end IS a node boundary). Entries are never removed — like
    the old length index, the tree only grows — so no delete path."""

    __slots__ = ("edge", "children", "hash")

    def __init__(self, edge: np.ndarray) -> None:
        self.edge = edge
        self.children: Dict[int, "_RadixNode"] = {}
        self.hash: Optional[str] = None


def _radix_insert(root: _RadixNode, toks: np.ndarray, h: str) -> None:
    node, i = root, 0
    while True:
        if i == len(toks):
            node.hash = h
            return
        child = node.children.get(int(toks[i]))
        if child is None:
            leaf = _RadixNode(toks[i:].copy())
            leaf.hash = h
            node.children[int(toks[i])] = leaf
            return
        edge = child.edge
        m = min(len(edge), len(toks) - i)
        d = 0
        while d < m and edge[d] == toks[i + d]:
            d += 1
        if d == len(edge):
            node, i = child, i + d
            continue
        # diverged mid-edge: split the edge at the fork point
        mid = _RadixNode(edge[:d].copy())
        child.edge = edge[d:].copy()
        mid.children = {int(child.edge[0]): child}
        node.children[int(edge[0])] = mid
        node, i = mid, i + d


def _radix_ancestors(root: _RadixNode,
                     toks: np.ndarray) -> List[Tuple[int, str]]:
    """Every registered prefix ``toks`` starts with, as ``(length, hash)``
    ascending — one walk yields match() AND the promote path's
    longest-resident-ancestor query."""
    node, i = root, 0
    out: List[Tuple[int, str]] = []
    while True:
        if node.hash is not None:
            out.append((i, node.hash))
        if i >= len(toks):
            return out
        child = node.children.get(int(toks[i]))
        if child is None:
            return out
        m = len(child.edge)
        if i + m > len(toks) or not np.array_equal(
                child.edge, toks[i:i + m]):
            return out
        node, i = child, i + m


@dataclasses.dataclass
class _HostRecord:
    """One entry's overflow-tier copy, page-deduplicated: ``chunk_keys``
    name the shared full-page chunks (axis 2 spans of every positional
    leaf, content-addressed in the store's chunk table), ``tail`` is the
    entry's private remainder — the partial fork page plus bucket padding
    (padding bytes are prefill garbage, distinct per export, so only FULL
    pages inside the true length ever dedupe) and every non-positional
    leaf whole. ``paged_flags`` marks which sorted-order leaves were
    split; ``tail_nbytes`` is what eviction frees unconditionally (chunk
    bytes free only when their refcount drains)."""

    chunk_keys: List[Tuple]
    tail: Any
    paged_flags: List[bool]
    tail_nbytes: int


@dataclasses.dataclass
class _Entry:
    """One fleet-known prefix. ``host`` is the overflow-tier copy (None =
    evicted/never exported); ``residency`` maps replica name → that
    engine's prefix id; ``last_used`` orders the LRU (monotone op
    counter); ``pins`` counts in-flight decode references."""

    tokens: np.ndarray
    length: int
    host: Optional[_HostRecord] = None
    host_nbytes: int = 0
    residency: Dict[str, int] = dataclasses.field(default_factory=dict)
    replica_used: Dict[str, int] = dataclasses.field(default_factory=dict)
    pins: int = 0
    last_used: int = 0
    registered_at: float = 0.0
    #: source layout of the host copy (`models/layouts.CacheLayout`):
    #: the exporting engine's mesh axes — exports gather to the full
    #: logical array, so ANY engine can promote this copy; a promote
    #: onto a different mesh reshards on import (counted)
    layout: Optional[CacheLayout] = None


class FleetPrefixStore:
    """See module doc. Thread-safe bookkeeping under one lock; device
    work (register/import/drop) runs outside it — callers serialize per
    engine exactly as the fleets already serialize replica access."""

    def __init__(self, *, overflow_budget_bytes: int = 256 << 20,
                 max_device_prefixes: int = 16, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 page_tokens: int = PAGE_TOKENS) -> None:
        if overflow_budget_bytes < 0:
            raise ValueError(f"overflow_budget_bytes must be >= 0, got "
                             f"{overflow_budget_bytes}")
        if max_device_prefixes < 1:
            raise ValueError(f"max_device_prefixes must be >= 1, got "
                             f"{max_device_prefixes}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got "
                             f"{page_tokens}")
        self.overflow_budget_bytes = overflow_budget_bytes
        self.max_device_prefixes = max_device_prefixes
        #: host-tier chunk granule — defaults to the engine page size so
        #: store chunks and engine pages are the same spans
        self.page_tokens = page_tokens
        self.metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        #: compressed token trie over every registered prefix — ``match``
        #: runs on every fleet submit, so it must not scan all entries
        #: per call, and the promote path reuses the same walk to find
        #: the longest already-resident ancestor (entries are never
        #: removed; eviction only drops host bytes)
        self._radix = _RadixNode(np.zeros(0, np.int32))
        #: chunk key → [refcount, nbytes, leaf-slices (sorted order)] —
        #: the shared-page tier: one full page of KV is stored ONCE
        #: however many registered prefixes contain it
        self._chunks: Dict[Tuple, List] = {}
        self._op = 0                       # monotone recency counter
        self.stats = {"hits": 0, "promotes": 0, "misses": 0,
                      "evictions": 0, "demotes": 0, "overflow_bytes": 0,
                      "pinned_eviction_skips": 0,
                      # promotes onto a mesh unlike the exporter's (the
                      # host copy is gathered, the import reshards)
                      "cross_mesh_promotes": 0,
                      # page-chunk dedup: chunks stored vs re-referenced,
                      # and the bytes sharing avoided storing twice
                      "page_chunks_stored": 0, "page_chunk_reuses": 0,
                      "dedup_bytes_saved": 0,
                      # promotes that ALIASED a resident ancestor's pages
                      # on a paged engine instead of re-copying them
                      "base_aliased_promotes": 0}

    # ------------------------------------------------------------ registry
    def register(self, tokens) -> str:
        """Make a prefix fleet-known (idempotent; no device work — the
        first ``ensure`` pays the one fleet-wide prefill). Returns its
        content hash."""
        arr = np.asarray(tokens, np.int32).reshape(-1)
        if arr.size == 0:
            raise ValueError("empty prefix")
        h = prefix_hash(arr)
        with self._lock:
            if h not in self._entries:
                self._entries[h] = _Entry(tokens=arr, length=int(arr.size),
                                          registered_at=self._clock())
                _radix_insert(self._radix, arr, h)
        return h

    def known(self, h: str) -> bool:
        with self._lock:
            return h in self._entries

    def __len__(self) -> int:
        """Registered-prefix count (entries are never removed — eviction
        only drops host bytes), so fleets can cap auto-registration."""
        with self._lock:
            return len(self._entries)

    def length_of(self, h: str) -> int:
        with self._lock:
            return self._entries[h].length

    def tokens_of(self, h: str) -> np.ndarray:
        with self._lock:
            return self._entries[h].tokens

    def match(self, prompt) -> Optional[Tuple[str, int]]:
        """Longest registered prefix that ``prompt`` starts with, as
        ``(hash, length)`` — the content-aware affinity key
        `serve/router.py`'s bucket fix mirrors. None when nothing
        matches or the prompt IS the prefix (no suffix to serve). One
        radix walk, O(matched tokens) — no per-length hashing."""
        arr = np.asarray(prompt, np.int32).reshape(-1)
        with self._lock:
            for ln, h in reversed(_radix_ancestors(self._radix, arr)):
                if ln < arr.size:
                    return h, ln
        return None

    def resident_on(self, h: str) -> List[str]:
        """Replica names where ``h`` is device-registered (the KV-locality
        signal the disagg decode router prefers)."""
        with self._lock:
            e = self._entries.get(h)
            return sorted(e.residency) if e is not None else []

    def resident_id(self, replica: str, h: str) -> Optional[int]:
        with self._lock:
            e = self._entries.get(h)
            return None if e is None else e.residency.get(replica)

    # ------------------------------------------------------------- pinning
    def pin(self, h: str) -> None:
        """Mark ``h`` as backing in-flight decode work: the overflow tier
        must not evict it until every pin is released."""
        with self._lock:
            self._entries[h].pins += 1

    def unpin(self, h: str) -> None:
        with self._lock:
            e = self._entries.get(h)
            if e is not None and e.pins > 0:
                e.pins -= 1

    # ------------------------------------------------------------- ensure
    def ensure(self, replica: str, engine, h: str) -> int:
        """Make prefix ``h`` usable on ``replica``'s ``engine``; returns
        that engine's prefix id. Hit < promote < miss (see module doc).
        A miss exports the freshly computed KV into the overflow tier
        (evicting LRU unpinned entries past the byte budget) so the rest
        of the fleet promotes instead of recomputing."""
        with self._lock:
            e = self._entries[h]
            self._op += 1
            e.last_used = self._op
            pid = e.residency.get(replica)
            if pid is not None:
                e.replica_used[replica] = self._op
                self.stats["hits"] += 1
                self._inc("prefix_store_hits")
                return pid
            # capture everything the device work needs NOW: the dict and
            # the entry are mutated under the lock by concurrent ensure/
            # evict calls — re-reading them lock-free below would race.
            # Materialization (chunk concatenation) is host memory work,
            # so it stays under the lock like every chunk-table access;
            # only device work runs outside.
            host = (self._materialize_locked(e.host)
                    if e.host is not None else None)
            length = e.length
            tokens = e.tokens
            base_pid, base_len = None, 0
            if host is not None and getattr(engine, "supports_page_alias",
                                            False):
                # paged engines alias a resident ancestor's full pages
                # instead of re-copying them: find the LONGEST registered
                # prefix of these tokens already on this replica — one
                # radix walk, the same one match() takes
                for ln, ah in reversed(
                        _radix_ancestors(self._radix, tokens)):
                    if ln >= length:
                        continue          # the entry itself
                    apid = self._entries[ah].residency.get(replica)
                    if apid is not None:
                        base_pid, base_len = apid, ln
                        break
        engine_axes = dict(getattr(engine, "mesh_axes", {}) or {})
        if host is not None:
            if base_pid is not None:
                pid = engine.import_prefix(host, length, base_pid=base_pid,
                                           base_len=base_len)
            else:
                pid = engine.import_prefix(host, length)
            with self._lock:
                e.residency[replica] = pid
                e.replica_used[replica] = self._op
                self.stats["promotes"] += 1
                if base_pid is not None:
                    self.stats["base_aliased_promotes"] += 1
                if (e.layout is not None
                        and dict(e.layout.mesh_axes) != engine_axes):
                    # the host copy is the gathered full array, so a
                    # promote onto an UNLIKE mesh is just an import that
                    # reshards — exact, but worth counting: it is the
                    # fleet-prefix-reuse-across-meshes path working
                    self.stats["cross_mesh_promotes"] += 1
                self._inc("prefix_store_promotes")
        else:
            pid = engine.register_prefix(tokens)
            cache, lp = engine.export_prefix(pid)
            with self._lock:
                e.residency[replica] = pid
                e.replica_used[replica] = self._op
                # re-check: a concurrent miss on another replica may have
                # landed a host copy first — newest write wins, bytes
                # charged once
                if e.host is None:
                    self._store_host_locked(e, cache, engine_axes)
                self.stats["misses"] += 1
                self._inc("prefix_store_misses")
                self._evict_over_budget_locked()
        self._demote_over_cap(replica, engine, keep=h)
        self._gauges()
        return pid

    def forget_replica(self, replica: str) -> None:
        """Drop ``replica``'s residency everywhere (ejection/scale-down —
        its engine died with its registrations)."""
        with self._lock:
            for e in self._entries.values():
                e.residency.pop(replica, None)
                e.replica_used.pop(replica, None)

    # ------------------------------------------------------------ eviction
    def _evict_over_budget_locked(self) -> None:
        """Drop LRU unpinned host copies until the byte budget holds.
        Pinned entries are skipped — never evicted — and counted, so a
        budget wedged open by pins is visible."""
        if self.stats["overflow_bytes"] <= self.overflow_budget_bytes:
            return
        victims = sorted((e for e in self._entries.values()
                          if e.host is not None),
                         key=lambda e: e.last_used)
        for e in victims:
            if self.stats["overflow_bytes"] <= self.overflow_budget_bytes:
                return
            if e.pins > 0:
                self.stats["pinned_eviction_skips"] += 1
                continue
            self._drop_host_locked(e)
            self.stats["evictions"] += 1
            self._inc("prefix_store_evictions")

    def _demote_over_cap(self, replica: str, engine, *, keep: str) -> None:
        """Hold ``replica`` at ``max_device_prefixes`` registrations:
        demote its least-recently-ensured unpinned prefix (never the one
        just ensured). Device HBM is the scarce tier; the host copy makes
        demotion a future promote, not a recompute."""
        while True:
            with self._lock:
                resident = [(e.replica_used.get(replica, 0), h, e)
                            for h, e in self._entries.items()
                            if replica in e.residency]
                if len(resident) <= self.max_device_prefixes:
                    return
                resident.sort()
                victim = next(((h, e) for _, h, e in resident
                               if h != keep and e.pins == 0), None)
                if victim is None:
                    return             # everything else is pinned: hold
                h, e = victim
                pid = e.residency.pop(replica)
                e.replica_used.pop(replica, None)
                self.stats["demotes"] += 1
                self._inc("prefix_store_demotes")
            engine.drop_prefix(pid)

    # ------------------------------------------------- host page-chunk tier
    def _store_host_locked(self, e: _Entry, cache: Any,
                           engine_axes: Dict[str, int]) -> None:
        """Land an exported host copy, deduplicating full KV pages: a
        page's bytes depend only on the tokens at and before it (causal
        attention) and the export layout, so the chunk key is the content
        hash of the tokens THROUGH that page plus the span and layout.
        Only full pages inside the true length dedupe — positions past
        ``e.length`` are prefill bucket padding, garbage that differs per
        export. Leaves without a position axis (1-D stub blobs, scalars)
        stay whole in the private tail, so non-KV payloads behave exactly
        as the undeduplicated store did."""
        page = self.page_tokens
        leaves = _tree_leaves(cache)
        flags = [getattr(leaf, "ndim", 0) >= 3
                 and leaf.shape[2] >= e.length for leaf in leaves]
        total = sum(_nbytes(leaf) for leaf in leaves)
        nfull = e.length // page if any(flags) else 0
        sig = ",".join(f"{a}={s}" for a, s in sorted(engine_axes.items()))
        keys: List[Tuple] = []
        new_bytes = 0
        for j in range(nfull):
            s, t = j * page, (j + 1) * page
            key = (prefix_hash(e.tokens[:t]), s, sig)
            c = self._chunks.get(key)
            if c is not None:
                c[0] += 1
                self.stats["page_chunk_reuses"] += 1
                self.stats["dedup_bytes_saved"] += c[1]
            else:
                data = [_copy(leaf[:, :, s:t])
                        for leaf, fl in zip(leaves, flags) if fl]
                nb = sum(_nbytes(d) for d in data)
                self._chunks[key] = [1, nb, data]
                self.stats["page_chunks_stored"] += 1
                new_bytes += nb
            keys.append(key)
        cut = nfull * page

        def trim(leaf, fl):
            if fl and cut:
                return _copy(leaf[:, :, cut:])
            return leaf

        tail = _tree_map_flagged(cache, trim, iter(flags))
        tail_nbytes = sum(_nbytes(leaf) for leaf in _tree_leaves(tail))
        e.host = _HostRecord(keys, tail, flags, tail_nbytes)
        e.host_nbytes = new_bytes + tail_nbytes
        e.layout = CacheLayout(mesh_axes=dict(engine_axes),
                               gathered_bytes=total)
        self.stats["overflow_bytes"] += new_bytes + tail_nbytes

    def _materialize_locked(self, rec: _HostRecord) -> Any:
        """Reassemble the full host copy: shared chunks then the private
        tail, concatenated on the position axis. Chunks referenced by a
        live record can never be missing — eviction only drops a chunk
        when its LAST referencing record is dropped."""
        chunk_leaf_lists = [self._chunks[k][2] for k in rec.chunk_keys]
        pi = [0]

        def join(leaf, fl):
            if not fl or not chunk_leaf_lists:
                return leaf
            parts = [cl[pi[0]] for cl in chunk_leaf_lists]
            pi[0] += 1
            parts.append(leaf)
            return torch.cat(parts, dim=2)

        return _tree_map_flagged(rec.tail, join, iter(rec.paged_flags))

    def _drop_host_locked(self, e: _Entry) -> None:
        """Free an entry's host copy: tail bytes unconditionally, chunk
        bytes only when the refcount drains (a sibling prefix may still
        hold the page)."""
        rec = e.host
        freed = rec.tail_nbytes
        for k in rec.chunk_keys:
            c = self._chunks[k]
            c[0] -= 1
            if c[0] == 0:
                freed += c[1]
                del self._chunks[k]
        self.stats["overflow_bytes"] -= freed
        e.host = None
        e.host_nbytes = 0
        e.layout = None

    # ---------------------------------------------------------- observability
    def _inc(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.inc(name)

    def _gauges(self) -> None:
        if self.metrics is not None:
            with self._lock:      # stats mutate under the lock; callers
                val = self.stats["overflow_bytes"]   # run outside it
            self.metrics.set_gauge("prefix_store_overflow_bytes", val)

    @property
    def overflow_bytes(self) -> int:
        with self._lock:
            return self.stats["overflow_bytes"]

    def snapshot(self) -> Dict[str, Dict]:
        """Stable per-entry view for tests/debugging."""
        with self._lock:
            return {h: {"length": e.length, "pins": e.pins,
                        "in_overflow": e.host is not None,
                        "residency": sorted(e.residency),
                        "layout": (e.layout.signature()
                                   if e.layout is not None else None)}
                    for h, e in sorted(self._entries.items())}


def _nbytes(leaf: torch.Tensor) -> int:
    return leaf.numel() * leaf.element_size()


def _copy(view: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of a payload slice, never a view: a stored chunk
    must not keep the whole exported payload alive."""
    return view.clone(memory_format=torch.contiguous_format)


def _tree_leaves(tree: Any) -> List[Any]:
    """Leaves of a nested-dict payload in sorted key order."""
    if isinstance(tree, dict):
        out: List[Any] = []
        for k in sorted(tree):
            out.extend(_tree_leaves(tree[k]))
        return out
    return [tree]


def _tree_map_flagged(tree: Any, fn: Callable[[Any, bool], Any],
                      flags) -> Any:
    """Structure-preserving map over a nested-dict pytree, consuming one
    flag per leaf in the same sorted order ``_tree_leaves`` walks."""
    if isinstance(tree, dict):
        return {k: _tree_map_flagged(tree[k], fn, flags)
                for k in sorted(tree)}
    return fn(tree, next(flags))
