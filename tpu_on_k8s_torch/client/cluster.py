"""In-memory cluster: the API-server semantics the controllers depend on.

Implements the k8s behaviors the reference leans on implicitly (SURVEY §1 L0):

* optimistic concurrency — writes bump ``resourceVersion``; stale writes raise
  ``ConflictError`` (the reference scatters conflict-tolerant status updates,
  e.g. controllers/common/job.go:331-340 — our controllers must face the same
  failure mode to be honest);
* finalizers — delete stamps ``deletionTimestamp`` and the object lingers until
  its finalizer list drains (the preempt-protector protocol, SURVEY §3.3);
* ownerReference cascade GC — deleting an owner deletes its dependents (how job
  deletion cleans up pods/services in the reference);
* label selection and namespaces;
* watch events for controller wiring.

Thread-safe: one re-entrant lock around the store; watch callbacks fire outside
mutation where possible but may re-enter the API.
"""
from __future__ import annotations

import itertools
import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple

from tpu_on_k8s_torch.api.core import Event, ObjectMeta, ObjectReference, utcnow
from tpu_on_k8s_torch.utils import serde


class ApiError(Exception):
    pass


class NotFoundError(ApiError):
    pass


class AlreadyExistsError(ApiError):
    pass


class ConflictError(ApiError):
    """resourceVersion mismatch — caller must re-read and retry."""


class ConflictRetriesExhausted(ConflictError):
    """A bounded read-modify-write loop saw nothing but 409s for its whole
    attempt budget — sustained contention (or an injected chaos schedule),
    not the ordinary losing-one-race case. Subclasses ``ConflictError`` so
    callers that treat any conflict as retryable-later keep working; callers
    that want to alert on livelock can catch this specifically."""


def run_conflict_retries(attempts: int, attempt: Callable[[], Any],
                         describe: str, metrics: Any = None) -> Any:
    """THE bounded conflict-retry loop — shared by every read-modify-write
    path (in-memory and REST ``update_with_retry``, REST finalizer
    ``patch_meta``) so the retry contract lives in one place. ``attempt``
    performs one full read-mutate-write; each retried ``ConflictError``
    feeds the ``conflict_retries`` counter on ``metrics`` (when wired);
    exhaustion raises the typed ``ConflictRetriesExhausted``."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    last: Optional[Exception] = None
    for _ in range(attempts):
        try:
            return attempt()
        except ConflictError as e:
            last = e
            if metrics is not None:
                metrics.inc("conflict_retries")
    raise ConflictRetriesExhausted(
        f"{describe} still conflicted after {attempts} attempts: "
        f"{last}") from last


class ExpiredError(ApiError):
    """Requested watch resourceVersion fell off the history window (the
    apiserver's 410 Gone) — the client must re-list and re-watch."""


@dataclass
class WatchEvent:
    type: str  # "ADDED" | "MODIFIED" | "DELETED"
    kind: str
    obj: Any
    old_obj: Any = None


Key = Tuple[str, str, str]  # (kind, namespace, name)


def match_labels(labels: Dict[str, str], selector: Dict[str, str]) -> bool:
    return all(labels.get(k) == v for k, v in selector.items())


class InMemoryCluster:
    """API-server stand-in. Objects are any dataclass with ``kind``/``metadata``;
    all reads return deep copies (mutating a returned object never mutates the
    store — exactly the informer-cache discipline the reference's controllers
    must respect)."""

    #: how many trailing watch events stay replayable for ?resourceVersion=N
    #: reconnects before the server answers 410 Gone.
    WATCH_HISTORY = 4096

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._store: Dict[Key, Any] = {}
        self._rv_counter = 0
        self._uid = itertools.count(1)
        self._watchers: List[Callable[[WatchEvent], None]] = []
        self._ordered_watchers: List[Callable[[WatchEvent], None]] = []
        self._history: Deque[Tuple[int, WatchEvent]] = deque(
            maxlen=self.WATCH_HISTORY)
        self._pod_logs: Dict[Tuple[str, str], List[str]] = {}

    # ---- watch ----------------------------------------------------------------
    def watch(self, callback: Callable[[WatchEvent], None],
              kinds: Optional[Iterable[str]] = None) -> None:
        """Register a live-event callback. ``kinds`` narrows delivery to the
        named kinds (the REST backend additionally narrows which informer
        streams it runs; here it is a dispatch filter)."""
        if kinds is not None:
            wanted = frozenset(kinds)
            original = callback

            def callback(event, _cb=original, _kinds=wanted):
                if event.kind in _kinds:
                    _cb(event)

        with self._lock:
            # registration races the mutation-side fanout (any writer
            # thread iterates this list): publish the append under the
            # same lock so a new watcher either sees an event or doesn't
            # — never a torn list
            self._watchers.append(callback)

    def subscribe_ordered(self, callback: Callable[[WatchEvent], None]) -> None:
        """Register a callback invoked INSIDE the mutation lock, in strict
        resourceVersion order (the apiserver's watch hub needs this: rv
        assignment and publication must be atomic or concurrent writers can
        publish out of order and a monotonic stream filter drops events).
        Callbacks must be fast and must not call back into the cluster."""
        with self._lock:
            self._ordered_watchers.append(callback)

    def _record(self, event: WatchEvent) -> None:
        """Publish under the mutation lock (caller holds ``self._lock``):
        history append + ordered fanout happen atomically with the rv
        assignment, so history and hub queues are rv-sorted."""
        self._history.append((event.obj.metadata.resource_version, event))
        for cb in list(self._ordered_watchers):
            cb(event)

    def _emit(self, event: WatchEvent) -> None:
        """Plain-callback fanout: snapshot the registry under the lock,
        call OUTSIDE it (callbacks may re-enter the API — the in-process
        controller wiring)."""
        with self._lock:
            cbs = list(self._watchers)
        for cb in cbs:
            cb(event)

    @property
    def current_rv(self) -> int:
        """The cluster-wide revision (what a conformant list's
        ``metadata.resourceVersion`` reports — etcd-revision semantics)."""
        with self._lock:
            return self._rv_counter

    def events_since(self, rv: int) -> List[WatchEvent]:
        """Replay buffered watch events with revision > rv, for
        ``?watch=true&resourceVersion=N``. Raises ExpiredError (→ 410 Gone)
        when rv is older than the history window."""
        with self._lock:
            if rv > self._rv_counter:
                # A future revision is unservable (etcd semantics) — happens
                # when the server restarted with fresh storage; the client
                # must re-list rather than wait for revisions that will
                # arrive with unrelated numbering.
                raise ExpiredError(
                    f"resourceVersion {rv} is ahead of the server "
                    f"({self._rv_counter})")
            if rv == self._rv_counter:
                return []
            if not self._history or self._history[0][0] > rv + 1:
                raise ExpiredError(
                    f"resourceVersion {rv} is too old "
                    f"(history starts at "
                    f"{self._history[0][0] if self._history else 'empty'})")
            return [e for r, e in self._history if r > rv]

    # ---- helpers --------------------------------------------------------------
    def _next_rv(self) -> int:
        with self._lock:
            self._rv_counter += 1
            return self._rv_counter

    @staticmethod
    def _key_of(obj: Any) -> Key:
        return (obj.kind, obj.metadata.namespace, obj.metadata.name)

    def record_event(self, obj: Any, etype: str, reason: str, message: str) -> None:
        """k8s Event recorder (reference record.EventRecorder): stores a real
        core/v1 Event object, named `{involved}.{seq}` like kubelet/clients do."""
        now = utcnow()
        ev = Event(
            metadata=ObjectMeta(
                name=f"{obj.metadata.name}.{next(self._uid):x}",
                namespace=obj.metadata.namespace or "default"),
            involved_object=ObjectReference(
                api_version=getattr(obj, "api_version", ""), kind=obj.kind,
                namespace=obj.metadata.namespace, name=obj.metadata.name,
                uid=obj.metadata.uid),
            type=etype, reason=reason, message=message,
            first_timestamp=now, last_timestamp=now)
        self.create(ev)

    @property
    def events(self) -> List[Tuple[str, str, str, str]]:
        """Stored Events as (namespace/name, type, reason, message) tuples in
        arrival order — the assertion surface tests use."""
        with self._lock:
            evs = [o for (k, _, _), o in self._store.items() if k == "Event"]
        evs.sort(key=lambda e: e.metadata.resource_version)
        return [(f"{e.involved_object.namespace}/{e.involved_object.name}",
                 e.type, e.reason, e.message) for e in evs]

    # ---- pod logs -------------------------------------------------------------
    def append_pod_log(self, namespace: str, name: str, line: str) -> None:
        """Kubelet-side log write (what a training process's stdout becomes)."""
        with self._lock:
            self._pod_logs.setdefault((namespace, name), []).append(line)

    def read_pod_log(self, namespace: str, name: str, *, tail: int = 0) -> List[str]:
        """pods/log subresource analog (the torchelastic metric observer reads
        one tail line this way — reference observation.go:40-106)."""
        with self._lock:
            lines = list(self._pod_logs.get((namespace, name), []))
        return lines[-tail:] if tail > 0 else lines

    # ---- CRUD -----------------------------------------------------------------
    def create(self, obj: Any) -> Any:
        with self._lock:
            key = self._key_of(obj)
            if key in self._store:
                raise AlreadyExistsError(f"{key} already exists")
            stored = serde.deep_copy(obj)
            meta = stored.metadata
            meta.uid = meta.uid or f"uid-{next(self._uid)}"
            meta.creation_timestamp = meta.creation_timestamp or utcnow()
            meta.resource_version = self._next_rv()
            meta.generation = max(meta.generation, 1)
            self._store[key] = stored
            out = serde.deep_copy(stored)
            event = WatchEvent("ADDED", obj.kind, out)
            self._record(event)
        self._emit(event)
        return out

    def get(self, cls: type, namespace: str, name: str) -> Any:
        kind = cls.__dataclass_fields__["kind"].default  # type: ignore[attr-defined]
        with self._lock:
            obj = self._store.get((kind, namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            return serde.deep_copy(obj)

    def try_get(self, cls: type, namespace: str, name: str) -> Optional[Any]:
        try:
            return self.get(cls, namespace, name)
        except NotFoundError:
            return None

    def list(
        self,
        cls: type,
        namespace: Optional[str] = None,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> List[Any]:
        kind = cls.__dataclass_fields__["kind"].default  # type: ignore[attr-defined]
        with self._lock:
            out = []
            for (k, ns, _), obj in self._store.items():
                if k != kind:
                    continue
                if namespace is not None and ns != namespace:
                    continue
                if label_selector and not match_labels(obj.metadata.labels, label_selector):
                    continue
                out.append(serde.deep_copy(obj))
            return out

    def update(self, obj: Any, *, subresource: str = "") -> Any:
        """Full-object update with optimistic concurrency. ``subresource="status"``
        mimics the status subresource: only status (and annotations/labels for
        protocol updates) are taken from the caller's object; spec is kept.
        Spec changes bump ``metadata.generation`` (k8s semantics the elastic
        generation protocol depends on, SURVEY §3.3)."""
        with self._lock:
            key = self._key_of(obj)
            current = self._store.get(key)
            if current is None:
                raise NotFoundError(f"{key} not found")
            if obj.metadata.resource_version != current.metadata.resource_version:
                raise ConflictError(
                    f"{key}: resourceVersion {obj.metadata.resource_version} "
                    f"!= {current.metadata.resource_version}"
                )
            old = serde.deep_copy(current)
            stored = serde.deep_copy(obj)
            if subresource == "status":
                stored.spec = current.spec
                stored.metadata.generation = current.metadata.generation
            else:
                old_spec = serde.to_dict(current.spec, drop_none=False) if hasattr(current, "spec") else None
                new_spec = serde.to_dict(stored.spec, drop_none=False) if hasattr(stored, "spec") else None
                if old_spec != new_spec:
                    stored.metadata.generation = current.metadata.generation + 1
                else:
                    stored.metadata.generation = current.metadata.generation
            # Immutable server-side fields.
            stored.metadata.uid = current.metadata.uid
            stored.metadata.creation_timestamp = current.metadata.creation_timestamp
            stored.metadata.deletion_timestamp = current.metadata.deletion_timestamp
            stored.metadata.resource_version = self._next_rv()
            self._store[key] = stored
            out = serde.deep_copy(stored)
            event = WatchEvent("MODIFIED", obj.kind, out, old)
            self._record(event)
        self._emit(event)
        # A finalizer drain on a deleting object may complete the delete.
        if out.metadata.deletion_timestamp is not None and not out.metadata.finalizers:
            self._finalize_delete(self._key_of(out))
        return out

    def patch_meta(
        self,
        cls: type,
        namespace: str,
        name: str,
        *,
        labels: Optional[Dict[str, Optional[str]]] = None,
        annotations: Optional[Dict[str, Optional[str]]] = None,
        add_finalizers: Iterable[str] = (),
        remove_finalizers: Iterable[str] = (),
    ) -> Any:
        """Strategic-merge-style metadata patch (reference pkg/utils/patch). A
        value of None deletes the key. Patches never conflict — they re-read
        inside the lock (mirroring server-side patch semantics)."""
        kind = cls.__dataclass_fields__["kind"].default  # type: ignore[attr-defined]
        with self._lock:
            current = self._store.get((kind, namespace, name))
            if current is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            old = serde.deep_copy(current)
            for src, dst in ((labels, current.metadata.labels),
                             (annotations, current.metadata.annotations)):
                if src:
                    for k, v in src.items():
                        if v is None:
                            dst.pop(k, None)
                        else:
                            dst[k] = v
            for f in add_finalizers:
                if f not in current.metadata.finalizers:
                    current.metadata.finalizers.append(f)
            for f in remove_finalizers:
                if f in current.metadata.finalizers:
                    current.metadata.finalizers.remove(f)
            current.metadata.resource_version = self._next_rv()
            out = serde.deep_copy(current)
            event = WatchEvent("MODIFIED", kind, out, old)
            self._record(event)
        self._emit(event)
        if out.metadata.deletion_timestamp is not None and not out.metadata.finalizers:
            self._finalize_delete((kind, namespace, name))
        return out

    def merge_patch(self, cls: type, namespace: str, name: str,
                    patch: Dict[str, Any]) -> Any:
        """RFC 7386 JSON merge-patch — what a conformant apiserver executes
        for ``Content-Type: application/merge-patch+json`` (the verb
        RestCluster emits; reference builds the analogous merge payloads in
        pkg/utils/patch/patch.go:66-96). ``metadata.resourceVersion`` in the
        patch is an optimistic-concurrency precondition (409 on mismatch);
        null values delete keys; lists are replaced wholesale."""
        kind = cls.__dataclass_fields__["kind"].default  # type: ignore[attr-defined]

        def merge(target: Any, delta: Any) -> Any:
            if not isinstance(delta, dict) or not isinstance(target, dict):
                return delta
            out = dict(target)
            for k, v in delta.items():
                if v is None:
                    out.pop(k, None)
                elif isinstance(v, dict) and isinstance(out.get(k), dict):
                    out[k] = merge(out[k], v)
                else:
                    out[k] = v
            return out

        with self._lock:
            current = self._store.get((kind, namespace, name))
            if current is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            pre_rv = (patch.get("metadata") or {}).get("resourceVersion")
            if pre_rv is not None and int(pre_rv) != current.metadata.resource_version:
                raise ConflictError(
                    f"{kind} {namespace}/{name}: patch precondition "
                    f"resourceVersion {pre_rv} != "
                    f"{current.metadata.resource_version}")
            old = serde.deep_copy(current)
            merged = merge(serde.to_dict(current, drop_none=False, wire=True),
                           patch)
            stored = serde.from_dict(cls, merged)
            # Server-side immutable fields win over whatever the patch said.
            stored.metadata.uid = current.metadata.uid
            stored.metadata.creation_timestamp = current.metadata.creation_timestamp
            stored.metadata.deletion_timestamp = current.metadata.deletion_timestamp
            stored.metadata.namespace = current.metadata.namespace
            stored.metadata.name = current.metadata.name
            if hasattr(current, "spec"):
                old_spec = serde.to_dict(current.spec, drop_none=False)
                new_spec = serde.to_dict(stored.spec, drop_none=False)
                stored.metadata.generation = (
                    current.metadata.generation + (old_spec != new_spec))
            stored.metadata.resource_version = self._next_rv()
            self._store[(kind, namespace, name)] = stored
            out = serde.deep_copy(stored)
            event = WatchEvent("MODIFIED", kind, out, old)
            self._record(event)
        self._emit(event)
        if out.metadata.deletion_timestamp is not None and not out.metadata.finalizers:
            self._finalize_delete((kind, namespace, name))
        return out

    def delete(self, cls: type, namespace: str, name: str) -> None:
        """Graceful delete: with finalizers present, only stamps
        deletionTimestamp (the object becomes a "victim" in the preemption
        protocol); otherwise removes and cascades to ownerRef dependents."""
        kind = cls.__dataclass_fields__["kind"].default  # type: ignore[attr-defined]
        key = (kind, namespace, name)
        with self._lock:
            current = self._store.get(key)
            if current is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            if current.metadata.finalizers:
                if current.metadata.deletion_timestamp is None:
                    current.metadata.deletion_timestamp = utcnow()
                    current.metadata.resource_version = self._next_rv()
                    out = serde.deep_copy(current)
                    event = WatchEvent("MODIFIED", kind, out)
                    self._record(event)
                else:
                    return  # already deleting
            else:
                out = None
        if out is not None:
            self._emit(event)
            return
        self._finalize_delete(key)

    def _finalize_delete(self, key: Key) -> None:
        with self._lock:
            obj = self._store.pop(key, None)
            if obj is None:
                return
            if key[0] == "Pod":
                # A recreated pod must NOT inherit its dead predecessor's log
                # stream (real pods/log is per-container-instance).
                self._pod_logs.pop((key[1], key[2]), None)
            # The deletion itself is a revision (etcd semantics): the DELETED
            # event carries a fresh rv so watch replay stays dense/ordered.
            obj.metadata.resource_version = self._next_rv()
            uid = obj.metadata.uid
            dependents = [
                (k, o) for k, o in self._store.items()
                if any(ref.uid == uid for ref in o.metadata.owner_references)
            ]
            event = WatchEvent("DELETED", key[0], serde.deep_copy(obj))
            self._record(event)
        self._emit(event)
        for (dkind, dns, dname), dobj in dependents:
            # Cascade GC (background propagation): finalizers still honored.
            try:
                self.delete(type(dobj), dns, dname)
            except NotFoundError:
                pass

    # ---- conveniences ---------------------------------------------------------
    def update_with_retry(self, cls: type, namespace: str, name: str,
                          mutate: Callable[[Any], None], *, subresource: str = "",
                          attempts: int = 5) -> Any:
        """Read-mutate-write with conflict retry — the centralized analog of the
        reference's scattered RetryOnConflict blocks (SURVEY §7 hard parts).
        Bounded: sustained 409s past ``attempts`` raise the typed
        ``ConflictRetriesExhausted`` (same contract as ``RestCluster``)."""
        def attempt() -> Any:
            obj = self.get(cls, namespace, name)
            mutate(obj)
            return self.update(obj, subresource=subresource)

        return run_conflict_retries(attempts, attempt,
                                    f"update of {namespace}/{name}",
                                    getattr(self, "metrics", None))
