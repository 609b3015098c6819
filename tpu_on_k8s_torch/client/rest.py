"""RestCluster: the typed REST client — same surface as InMemoryCluster.

The analog of the reference's generated typed clientset
(client/clientset/versioned/clientset.go) plus the informer
layer (client/informers/externalversions/factory.go): every InMemoryCluster
method (create/get/list/update/patch_meta/delete/watch/status-subresource/
pod-log/events) is implemented by speaking conformant Kubernetes REST —
camelCase JSON, real resource scoping, RFC 7386 merge-patch with
resourceVersion preconditions for metadata/finalizer changes (the patch
dialect a real apiserver accepts for CRDs; the reference builds the same
payloads via pkg/utils/patch/patch.go:66-96), and core/v1 Event objects.
Controllers are backend-agnostic: the operator swaps this in for
``InMemoryCluster`` with no controller changes.

Watch design (the real informer contract, reference main.go:77-83):
one list-then-watch loop per registered kind. Each loop LISTs the collection
(capturing the list's ``metadata.resourceVersion``), delivers every item as a
synthetic ADDED event (initial sync / re-list replay — level-triggered
consumers treat duplicates as no-ops), then opens
``?watch=true&resourceVersion=N&allowWatchBookmarks=true`` and follows the
stream. A dropped stream reconnects from the last observed revision with
backoff; ``410 Gone``/``Expired`` ERROR frames trigger a full re-list.
BOOKMARK frames are consumed when present but never required.
`watch(callback)` blocks until every kind's initial list has been delivered,
so no pre-existing object is missed. Errors map from typed Status bodies:
404→NotFoundError, 409 AlreadyExists/Conflict→the matching exception — the
same failure modes the controllers face in-memory.
"""
from __future__ import annotations

import json
import random
import ssl
import threading
import time
import uuid
from http.client import HTTPConnection, HTTPSConnection
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple
from urllib.parse import quote, urlparse

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.api.core import Event, ObjectReference, utcnow
from tpu_on_k8s_torch.client import resources
from tpu_on_k8s_torch.client.cluster import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    ExpiredError,
    NotFoundError,
    WatchEvent,
    run_conflict_retries,
)
from tpu_on_k8s_torch.utils import serde
from tpu_on_k8s_torch.utils.logging import get_logger

_log = get_logger("restclient")


def _raise_for_status(code: int, body: bytes) -> None:
    try:
        status = json.loads(body or b"{}")
    except json.JSONDecodeError:
        status = {}
    reason = status.get("reason", "")
    message = status.get("message", body.decode(errors="replace"))
    if code == 404 or reason == "NotFound":
        raise NotFoundError(message)
    if reason == "AlreadyExists":
        raise AlreadyExistsError(message)
    if code == 409 or reason == "Conflict":
        raise ConflictError(message)
    if code == 410 or reason == "Expired":
        raise ExpiredError(message)
    raise ApiError(f"HTTP {code}: {message}")


def _wire(obj: Any) -> Dict[str, Any]:
    return serde.to_dict(obj, drop_none=False, wire=True)


class RestCluster:
    """k8s REST client with the InMemoryCluster surface (duck-typed)."""

    #: reconnect backoff bounds for dropped watch streams
    WATCH_BACKOFF_INITIAL = 0.2
    WATCH_BACKOFF_MAX = 5.0

    def __init__(self, base_url: str, timeout: float = 10.0,
                 token_path: Optional[str] = None,
                 ca_path: Optional[str] = None,
                 token: Optional[str] = None,
                 client_cert_path: Optional[str] = None,
                 client_key_path: Optional[str] = None) -> None:
        """``token_path`` (re-read per request — SA tokens rotate) or inline
        ``token`` for bearer auth; ``client_cert_path``/``client_key_path``
        for mTLS client-certificate auth (the kubeconfig
        ``client-certificate``/``client-key`` user entries,
        reference pkg/utils/kubeconfig/kubeconfig.go:33-56)."""
        parsed = urlparse(base_url)
        if parsed.scheme not in ("http", "https", ""):
            raise ValueError(f"unsupported scheme {parsed.scheme!r}")
        self.tls = parsed.scheme == "https"
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or (443 if self.tls else 80)
        self.timeout = timeout
        self._token_path = token_path  # re-read per request: SA tokens rotate
        self._token = token
        self._ssl_ctx: Optional[ssl.SSLContext] = None
        if self.tls:
            self._ssl_ctx = (ssl.create_default_context(cafile=ca_path)
                             if ca_path else ssl.create_default_context())
            if client_cert_path:
                self._ssl_ctx.load_cert_chain(client_cert_path,
                                              client_key_path)
        self._local = threading.local()
        #: optional JobMetrics sink (conflict-retry counter); the operator
        #: wires its own instance in, library callers may leave None
        self.metrics = None
        # Decorrelated-jitter state for watch reconnects. Entropy-seeded by
        # default (each process jitters differently — that is the point);
        # tests needing determinism reseed ``_backoff_rng`` directly.
        self._backoff_rng = random.Random()
        self._watch_lock = threading.Lock()
        self._watch_callbacks: List[Callable[[WatchEvent], None]] = []
        self._watch_threads: List[threading.Thread] = []
        self._watch_running: set = set()  # kinds with a live informer loop
        self._watch_stop = threading.Event()
        # informer cache: kind → {(ns, name): obj}. Source of truth for
        # synthetic DELETED on re-list and for initial-sync replay to
        # callbacks registered after the loops started.
        self._known: Dict[str, Dict[Tuple[str, str], Any]] = {}

    # ------------------------------------------------------------------ plumbing
    def _new_conn(self, timeout: Optional[float]) -> HTTPConnection:
        if self.tls:
            return HTTPSConnection(self.host, self.port, timeout=timeout,
                                   context=self._ssl_ctx)
        return HTTPConnection(self.host, self.port, timeout=timeout)

    def _conn(self) -> HTTPConnection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = self._new_conn(self.timeout)
            self._local.conn = conn
        return conn

    def _headers(self, content_type: Optional[str]) -> Dict[str, str]:
        headers = {"Content-Type": content_type} if content_type else {}
        # client-go precedence: an inline token wins over tokenFile (the
        # file is not even read then); with only a tokenFile it is re-read
        # per request (SA tokens rotate), and an unreadable file degrades
        # to no auth — the server's 401 is the actionable signal.
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        elif self._token_path:
            try:
                with open(self._token_path) as f:
                    file_token = f.read().strip()
            except OSError:
                file_token = None
            if file_token:
                headers["Authorization"] = f"Bearer {file_token}"
        return headers

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 content_type: str = "application/json") -> Any:
        payload = json.dumps(body).encode() if body is not None else None
        headers = self._headers(content_type if payload is not None else None)
        for attempt in (0, 1):  # one retry on a stale keep-alive connection
            fault = chaos.fire(chaos.SITE_REST_REQUEST, method=method,
                               path=path, attempt=attempt)
            if fault is not None:
                exc = fault.to_exception()
                if isinstance(exc, OSError) and not isinstance(exc, ApiError):
                    # connection-level fault: takes the real stale-connection
                    # path (drop the conn, retry once) — a single injected
                    # reset is absorbed exactly like a real keep-alive reset
                    self._local.conn = None
                    if attempt:
                        raise exc
                    continue
                raise exc  # HTTP-level fault (5xx/409): surfaces typed
            conn = self._conn()
            try:
                conn.request(method, path, body=payload, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                break
            except (ConnectionError, OSError):
                self._local.conn = None
                if attempt:
                    raise
        if resp.status >= 400:
            _raise_for_status(resp.status, data)
        ctype = resp.headers.get("Content-Type", "")
        if ctype.startswith("text/plain"):
            return data.decode()
        return json.loads(data or b"{}")

    # --------------------------------------------------------------------- CRUD
    def create(self, obj: Any) -> Any:
        rt = resources.by_class(type(obj))
        ns = obj.metadata.namespace or "default"
        data = self._request("POST", rt.collection_path(ns), _wire(obj))
        return serde.from_dict(rt.cls, data)

    def get(self, cls: type, namespace: str, name: str) -> Any:
        rt = resources.by_class(cls)
        data = self._request("GET", rt.item_path(namespace, quote(name)))
        return serde.from_dict(rt.cls, data)

    def try_get(self, cls: type, namespace: str, name: str) -> Optional[Any]:
        try:
            return self.get(cls, namespace, name)
        except NotFoundError:
            return None

    def list(self, cls: type, namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None) -> List[Any]:
        items, _ = self._list_with_rv(resources.by_class(cls), namespace,
                                      label_selector)
        return items

    def _list_with_rv(self, rt: resources.ResourceType,
                      namespace: Optional[str] = None,
                      label_selector: Optional[Dict[str, str]] = None,
                      ) -> Tuple[List[Any], int]:
        """List + the collection's ``metadata.resourceVersion`` — the revision
        a subsequent watch resumes from (list-then-watch, no event gap)."""
        path = (rt.collection_path(namespace)
                if namespace is not None and rt.namespaced
                else rt.all_namespaces_path())
        if label_selector:
            sel = ",".join(f"{k}={v}" for k, v in label_selector.items())
            path += f"?labelSelector={quote(sel)}"
        data = self._request("GET", path)
        rv = int(data.get("metadata", {}).get("resourceVersion", 0) or 0)
        return ([serde.from_dict(rt.cls, item)
                 for item in data.get("items", [])], rv)

    def update(self, obj: Any, *, subresource: str = "") -> Any:
        rt = resources.by_class(type(obj))
        path = rt.item_path(obj.metadata.namespace, quote(obj.metadata.name))
        if subresource:
            path += f"/{subresource}"
        data = self._request("PUT", path, _wire(obj))
        return serde.from_dict(rt.cls, data)

    def patch_meta(self, cls: type, namespace: str, name: str, *,
                   labels: Optional[Dict[str, Optional[str]]] = None,
                   annotations: Optional[Dict[str, Optional[str]]] = None,
                   add_finalizers: Iterable[str] = (),
                   remove_finalizers: Iterable[str] = ()) -> Any:
        """Metadata patch via standard JSON merge-patch (RFC 7386).

        Labels/annotations merge directly (null deletes a key). Finalizers
        are a list — merge-patch replaces lists wholesale — so finalizer
        edits do read-modify-write with a ``metadata.resourceVersion``
        precondition and retry on conflict, exactly how conformant
        controllers edit finalizers on CRDs.
        """
        rt = resources.by_class(cls)
        add_f, remove_f = list(add_finalizers), list(remove_finalizers)
        meta: Dict[str, Any] = {}
        if labels:
            meta["labels"] = labels
        if annotations:
            meta["annotations"] = annotations
        if not add_f and not remove_f:
            data = self._request(
                "PATCH", rt.item_path(namespace, quote(name)),
                {"metadata": meta},
                content_type="application/merge-patch+json")
            return serde.from_dict(rt.cls, data)
        def attempt() -> Any:
            cur = self.get(cls, namespace, name)
            fins = [f for f in cur.metadata.finalizers if f not in remove_f]
            fins += [f for f in add_f if f not in fins]
            patch_meta = dict(meta)
            patch_meta["finalizers"] = fins
            # opaque string on the wire, like every k8s resourceVersion
            patch_meta["resourceVersion"] = str(cur.metadata.resource_version)
            data = self._request(
                "PATCH", rt.item_path(namespace, quote(name)),
                {"metadata": patch_meta},
                content_type="application/merge-patch+json")
            return serde.from_dict(rt.cls, data)

        return run_conflict_retries(5, attempt,
                                    f"metadata patch of {namespace}/{name}",
                                    self.metrics)

    def delete(self, cls: type, namespace: str, name: str) -> None:
        rt = resources.by_class(cls)
        self._request("DELETE", rt.item_path(namespace, quote(name)))

    def update_with_retry(self, cls: type, namespace: str, name: str,
                          mutate: Callable[[Any], None], *,
                          subresource: str = "", attempts: int = 5) -> Any:
        """Read-mutate-write, BOUNDED: past ``attempts`` sustained 409s it
        raises the typed ``ConflictRetriesExhausted`` (a ``ConflictError``
        subclass, so existing handlers keep working) instead of spinning —
        under a chaos schedule injecting permanent conflicts an unbounded
        loop is a livelock. Every retried conflict feeds the
        ``conflict_retries`` counter when ``self.metrics`` is wired."""
        def attempt() -> Any:
            obj = self.get(cls, namespace, name)
            mutate(obj)
            return self.update(obj, subresource=subresource)

        return run_conflict_retries(attempts, attempt,
                                    f"update of {namespace}/{name}",
                                    self.metrics)

    # ----------------------------------------------------------- events & logs
    def record_event(self, obj: Any, etype: str, reason: str,
                     message: str) -> None:
        """POST a real core/v1 Event (what record.EventRecorder emits)."""
        ns = obj.metadata.namespace or "default"
        now = utcnow()
        ev = Event(
            involved_object=ObjectReference(
                api_version=getattr(obj, "api_version", ""), kind=obj.kind,
                namespace=ns, name=obj.metadata.name, uid=obj.metadata.uid),
            type=etype, reason=reason, message=message,
            first_timestamp=now, last_timestamp=now)
        ev.metadata.namespace = ns
        # monotonic_ns is process-local (manager and scheduler can collide)
        # and may be coarse — salt with randomness and retry the residual race
        for attempt in range(3):
            ev.metadata.name = (f"{obj.metadata.name}."
                                f"{time.monotonic_ns():x}."
                                f"{uuid.uuid4().hex[:6]}")
            try:
                self.create(ev)
                return
            except AlreadyExistsError:
                if attempt == 2:  # never drop an event silently
                    raise

    def list_events(self, namespace: Optional[str] = None) -> List[tuple]:
        """Events as tuples; ``namespace=None`` spans all namespaces (the
        InMemoryCluster.events parity surface is cluster-wide)."""
        evs = self.list(Event, namespace)
        evs.sort(key=lambda e: e.metadata.resource_version)
        return [(f"{e.involved_object.namespace}/{e.involved_object.name}",
                 e.type, e.reason, e.message) for e in evs]

    @property
    def events(self) -> List[tuple]:
        """Parity with InMemoryCluster.events for assertions/tests."""
        return self.list_events()

    def read_pod_log(self, namespace: str, name: str, *,
                     tail: int = 0) -> List[str]:
        path = f"/api/v1/namespaces/{namespace}/pods/{quote(name)}/log"
        if tail:
            path += f"?tailLines={tail}"
        text = self._request("GET", path)
        return text.split("\n") if text else []

    # -------------------------------------------------------------------- watch
    def watch(self, callback: Callable[[WatchEvent], None],
              kinds: Optional[Iterable[str]] = None) -> None:
        """Register a callback and ensure a list-then-watch informer loop is
        running for each requested kind (all registered kinds when ``kinds``
        is None) — a node-scoped actor that only cares about one kind (the
        CRR node agent) runs ONE stream, not one per resource type. BLOCKS
        until every newly started loop has delivered its initial list. If
        loops for the requested kinds already run, the informer cache is
        replayed to the new callback as synthetic ADDED events (informer
        AddEventHandler semantics), so every controller — not just the
        first — observes pre-existing objects. Callbacks receive events for
        every kind any registration requested; filter by ``event.kind``."""
        wanted = [rt for rt in resources.all_types()
                  if kinds is None or rt.kind in set(kinds)]
        with self._watch_lock:
            snapshot = [obj for cache in self._known.values()
                        for obj in cache.values()]
            already_running = bool(self._watch_running)
            self._watch_callbacks.append(callback)
            ready: List[threading.Event] = []
            for rt in wanted:
                if rt.kind in self._watch_running:
                    continue
                self._watch_running.add(rt.kind)
                ev = threading.Event()
                ready.append(ev)
                t = threading.Thread(target=self._watch_loop,
                                     args=(rt, ev), daemon=True,
                                     name=f"watch-{rt.plural}")
                t.start()
                self._watch_threads.append(t)
        if already_running:
            # Replay the informer cache to the newcomer, outside the lock
            # (callbacks may re-enter the client). A concurrent live event
            # may duplicate — level-triggered consumers treat duplicates as
            # no-ops.
            for obj in snapshot:
                try:
                    callback(WatchEvent("ADDED", obj.kind, obj))
                except Exception:
                    if self.metrics is not None:
                        self.metrics.error()
                    _log.exception("watch callback failed on sync replay")
        for ev in ready:
            if not ev.wait(timeout=30):
                raise ApiError("watch stream failed to establish")

    def _dispatch(self, event: WatchEvent) -> None:
        key = (event.obj.metadata.namespace, event.obj.metadata.name)
        with self._watch_lock:
            cache = self._known.setdefault(event.kind, {})
            if event.type == "DELETED":
                cache.pop(key, None)
            else:
                cache[key] = event.obj
            callbacks = list(self._watch_callbacks)
        for cb in callbacks:
            try:
                cb(event)
            except Exception:
                if self.metrics is not None:
                    self.metrics.error()
                _log.exception("watch callback failed",
                               extra={"kv": {"kind": event.kind}})

    def _sync(self, rt: resources.ResourceType) -> int:
        """Initial list (or re-list): deliver every current object as ADDED,
        synthesize DELETED for cached objects that vanished during the outage
        (the informer's DeletedFinalStateUnknown replay — without it a job
        deleted while the stream was down would leak controller bookkeeping
        forever), and return the list revision."""
        items, rv = self._list_with_rv(rt)
        listed = {(o.metadata.namespace, o.metadata.name) for o in items}
        with self._watch_lock:
            gone = [obj for key, obj in self._known.get(rt.kind, {}).items()
                    if key not in listed]
        for obj in gone:
            self._dispatch(WatchEvent("DELETED", rt.kind, obj))
        for obj in items:
            self._dispatch(WatchEvent("ADDED", rt.kind, obj))
        return rv

    def _next_backoff(self, prev: float) -> float:
        """Decorrelated-jitter reconnect backoff (AWS architecture blog's
        "decorrelated jitter"): ``uniform(initial, 3*prev)`` capped at the
        max. Plain exponential backoff resynchronizes every watcher that an
        API-server blip disconnected at the same instant — they all retry
        in lockstep at t+0.2, t+0.6, ... and the thundering herd re-kills
        the server; jitter spreads the herd across the whole window."""
        return min(self.WATCH_BACKOFF_MAX,
                   self._backoff_rng.uniform(self.WATCH_BACKOFF_INITIAL,
                                             prev * 3.0))

    def _watch_loop(self, rt: resources.ResourceType,
                    ready: threading.Event) -> None:
        """List-then-watch with resume and recovery (informer semantics):
        dropped stream → reconnect from the last seen revision with
        decorrelated-jitter backoff; 410 Expired → full re-list. Never goes
        silently deaf."""
        rv: Optional[int] = None
        backoff = self.WATCH_BACKOFF_INITIAL
        while not self._watch_stop.is_set():
            conn = None
            try:
                if rv is None:
                    rv = self._sync(rt)
                    ready.set()
                fault = chaos.fire(chaos.SITE_REST_WATCH_CONNECT,
                                   kind=rt.kind)
                if fault is not None:
                    raise fault.to_exception()
                conn = self._new_conn(None)  # no timeout: long-lived stream
                path = (rt.all_namespaces_path()
                        + f"?watch=true&resourceVersion={rv}"
                        + "&allowWatchBookmarks=true")
                conn.request("GET", path, headers=self._headers(None))
                resp = conn.getresponse()
                if resp.status == 410:
                    _log.warning("watch expired; re-listing",
                                 extra={"kv": {"kind": rt.kind, "rv": rv}})
                    rv = None
                    continue
                if resp.status >= 400:
                    _raise_for_status(resp.status, resp.read())
                while not self._watch_stop.is_set():
                    line = resp.readline()
                    if not line:
                        break  # server closed the stream → reconnect from rv
                    line = line.strip()
                    if not line:
                        continue
                    msg = json.loads(line)
                    mtype = msg.get("type")
                    if mtype == "BOOKMARK":
                        # optional: only advances the resume revision
                        raw = (msg.get("object", {}).get("metadata", {})
                               .get("resourceVersion"))
                        if raw is not None:
                            rv = int(raw)
                        continue
                    if mtype == "ERROR":
                        code = msg.get("object", {}).get("code")
                        if code == 410:
                            rv = None  # window lost → re-list
                        break
                    obj = serde.from_dict(rt.cls, msg["object"])
                    rv = obj.metadata.resource_version
                    self._dispatch(WatchEvent(mtype, rt.kind, obj))
                    backoff = self.WATCH_BACKOFF_INITIAL
                    if chaos.fire(chaos.SITE_REST_WATCH_EVENT,
                                  kind=rt.kind) is not None:
                        break  # injected mid-stream drop → reconnect from rv
                # Clean close: back off too — a server that closes streams on
                # arrival (overflow, shutdown races) must not induce a hot
                # list/watch spin; delivered events above reset the backoff.
                self._watch_stop.wait(backoff)
                backoff = self._next_backoff(backoff)
            except (ConnectionError, OSError, ApiError,
                    json.JSONDecodeError) as exc:
                if self._watch_stop.is_set():
                    break
                _log.warning(
                    "watch stream died; reconnecting",
                    extra={"kv": {"kind": rt.kind, "rv": rv,
                                  "error": repr(exc),
                                  "backoff_s": round(backoff, 2)}})
                self._watch_stop.wait(backoff)
                backoff = self._next_backoff(backoff)
            finally:
                if conn is not None:
                    conn.close()

    def close(self) -> None:
        self._watch_stop.set()
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
