"""HTTP API server: Kubernetes REST semantics over the in-memory registry.

The envtest analog the reference's Makefile models (Makefile:106-109 spins a
real etcd+kube-apiserver for `go test`): a threaded HTTP server exposing the
API-machinery surface the controllers depend on —

* group/version/namespace REST routing (`/api/v1/...`, `/apis/{g}/{v}/...`)
  with real scoping (PersistentVolume / PriorityClass are cluster-scoped) and
  typed Status errors (NotFound / AlreadyExists / Conflict / Expired);
* camelCase wire JSON (``serde.to_dict(wire=True)``), snake_case storage;
* optimistic concurrency via resourceVersion on PUT (409 Conflict);
* the status subresource (`PUT .../{name}/status`);
* RFC 7386 JSON merge-patch (`Content-Type: application/merge-patch+json`)
  with resourceVersion preconditions — the same payloads the reference builds
  via pkg/utils/patch/patch.go:66-96, but in the patch dialect a conformant
  apiserver accepts for CRDs (strategic merge is built-ins-only in real k8s);
* graceful delete: finalizers pin the object with deletionTimestamp, drain
  completes the delete, ownerReference cascade GC follows;
* list responses carry ``metadata.resourceVersion`` (the global revision) so
  clients can list-then-watch without an event gap;
* streaming watch (`?watch=true`, chunked JSON lines, k8s wire format
  `{"type": ..., "object": ...}`) supporting ``resourceVersion=N`` resume
  from a bounded history window, ``410 Expired`` ERROR events when the
  window is exceeded (client must re-list), and optional BOOKMARK frames
  (``allowWatchBookmarks=true``) carrying the current revision;
* core/v1 Event objects through the ordinary CRUD routes;
* pods/log subresource (GET with `tailLines`).

Deliberate divergences from a conformant kube-apiserver (each is a test seam
or a scope cut, not a semantic the controllers depend on):

| Divergence | Why |
|---|---|
| `POST .../pods/{name}/log` injects a log line | kubelet stand-in: tests feed the stream the autoscaler's observer reads |
| label selectors support `k=v` equality only | the only form the controllers emit |
| no apiVersion conversion/validation webhooks | single-version API surface |
| client-cert authn is verify-only | TLS + Bearer tokens (the GKE ServiceAccount path) and optional mTLS via ``client_ca_path`` (CERT_REQUIRED against a CA, exercised by test_tls_over_rest.py); no username extraction from the cert subject — there is no RBAC layer to feed it to |

Storage delegates to `InMemoryCluster` — the same finalizer/cascade/conflict
logic the controllers were developed against — so this file is purely the
wire protocol. `RestCluster` (client/rest.py) is the typed client speaking
this protocol; reference analog: client/clientset/versioned/clientset.go.
"""
from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.client import resources
from tpu_on_k8s_torch.client.cluster import (
    AlreadyExistsError,
    ConflictError,
    ExpiredError,
    InMemoryCluster,
    NotFoundError,
    WatchEvent,
)
from tpu_on_k8s_torch.utils import serde
from tpu_on_k8s_torch.utils.logging import get_logger
from urllib.parse import parse_qs, urlparse

_log = get_logger("apiserver")


def _status_body(code: int, reason: str, message: str) -> bytes:
    return json.dumps(_status_dict(code, reason, message)).encode()


def _status_dict(code: int, reason: str, message: str) -> Dict[str, Any]:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "reason": reason, "message": message, "code": code}


def encode_obj(obj: Any) -> Dict[str, Any]:
    return serde.to_dict(obj, drop_none=False, wire=True)


def decode_obj(rt: resources.ResourceType, data: Dict[str, Any]) -> Any:
    return serde.from_dict(rt.cls, data)


def parse_label_selector(raw: str) -> Optional[Dict[str, str]]:
    """`a=b,c=d` — the equality subset the controllers use."""
    if not raw:
        return None
    out: Dict[str, str] = {}
    for part in raw.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k] = v
    return out


class _Sub:
    """One watch subscriber: a bounded queue plus an overflow latch. A stalled
    consumer overflows, the stream closes, and the client re-lists — the
    honest semantics for an envtest analog (a real apiserver drops laggards
    the same way)."""

    MAXSIZE = 1024

    def __init__(self, kind: str) -> None:
        self.kind = kind
        self.q: "queue.Queue" = queue.Queue(maxsize=self.MAXSIZE)
        self.overflowed = threading.Event()


class _WatchHub:
    """Fans cluster watch events out to per-connection bounded queues."""

    _CLOSE = object()

    def __init__(self, cluster: InMemoryCluster) -> None:
        self._lock = threading.Lock()
        self._subs: List[_Sub] = []
        # Ordered subscription: fanout happens atomically with rv assignment,
        # so per-stream queues are rv-sorted and the monotonic stream filter
        # never drops a reordered event.
        cluster.subscribe_ordered(self._on_event)

    def _on_event(self, event: WatchEvent) -> None:
        with self._lock:
            subs = list(self._subs)
        for sub in subs:
            if sub.kind != event.kind:
                continue
            try:
                sub.q.put_nowait(event)
            except queue.Full:
                sub.overflowed.set()
                self.unsubscribe(sub)

    def subscribe(self, kind: str) -> _Sub:
        sub = _Sub(kind)
        with self._lock:
            self._subs.append(sub)
        return sub

    def unsubscribe(self, sub: _Sub) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def close(self) -> None:
        with self._lock:
            subs = list(self._subs)
            self._subs = []
        for sub in subs:
            try:
                sub.q.put_nowait(self._CLOSE)
            except queue.Full:
                sub.overflowed.set()


class _Route:
    """Parsed request path."""

    def __init__(self, rt: resources.ResourceType, namespace: Optional[str],
                 name: Optional[str], subresource: Optional[str]):
        self.rt = rt
        self.namespace = namespace
        self.name = name
        self.subresource = subresource

    @property
    def store_namespace(self) -> str:
        """Namespace key for storage: cluster-scoped kinds live under ""."""
        if not self.rt.namespaced:
            return ""
        return self.namespace if self.namespace is not None else ""


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "tpu-on-k8s-apiserver"

    # set by ApiServer via type(); silence the type checker
    cluster: InMemoryCluster
    hub: _WatchHub
    stopping: threading.Event
    require_token: Optional[str] = None

    def log_message(self, fmt, *args):  # route through the framework logger
        _log.debug("%s %s", self.address_string(), fmt % args)

    def _authorized(self) -> bool:
        """Bearer-token check (what a real apiserver's authn layer does for
        ServiceAccount tokens). Enforced only when the server was started
        with a required token — the TLS tests pin the client's auth path."""
        if self.require_token is None:
            return True
        header = self.headers.get("Authorization", "")
        if header == f"Bearer {self.require_token}":
            return True
        self._send_json(401, _status_body(401, "Unauthorized",
                                          "bearer token missing or invalid"))
        return False

    def _chaos_fault(self) -> bool:
        """Server-side fault injection (``apiserver.request``): answer a
        typed failure or kill the connection before the verb runs. Returns
        True when a fault consumed the request."""
        fault = chaos.fire(chaos.SITE_APISERVER_REQUEST,
                           method=self.command, path=self.path)
        if fault is None:
            return False
        if isinstance(fault, chaos.HttpError):
            self._send_json(fault.code, _status_body(
                fault.code, "InternalError", "chaos injected server error"))
            return True
        if isinstance(fault, chaos.Conflict):
            self._send_json(409, _status_body(
                409, "Conflict", "chaos injected write conflict"))
            return True
        # TimeoutFault / ConnectionResetFault / WatchDrop: the request never
        # gets an answer — close the socket so the client sees a reset (the
        # observable shape of both a timeout-then-close LB and a crashed
        # apiserver replica)
        self.close_connection = True
        try:
            self.connection.close()
        except OSError:
            pass
        return True

    # ------------------------------------------------------------------ routing
    def _parse(self) -> Tuple[Optional[_Route], Dict[str, List[str]]]:
        parsed = urlparse(self.path)
        qs = parse_qs(parsed.query)
        parts = [p for p in parsed.path.split("/") if p]
        # /api/v1/... vs /apis/{group}/{version}/...
        if len(parts) >= 2 and parts[0] == "api" and parts[1] == "v1":
            group, rest = "", parts[2:]
        elif len(parts) >= 3 and parts[0] == "apis":
            group, rest = parts[1], parts[3:]
        else:
            return None, qs
        namespace: Optional[str] = None
        if len(rest) >= 2 and rest[0] == "namespaces":
            namespace, rest = rest[1], rest[2:]
        if not rest:
            return None, qs
        plural, rest = rest[0], rest[1:]
        rt = resources.by_route(group, plural)
        if rt is None:
            return None, qs
        name = rest[0] if rest else None
        sub = rest[1] if len(rest) > 1 else None
        return _Route(rt, namespace, name, sub), qs

    # ---------------------------------------------------------------- responses
    def _send_json(self, code: int, payload: Any) -> None:
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_status(self, exc: Exception) -> None:
        if isinstance(exc, NotFoundError):
            self._send_json(404, _status_body(404, "NotFound", str(exc)))
        elif isinstance(exc, AlreadyExistsError):
            self._send_json(409, _status_body(409, "AlreadyExists", str(exc)))
        elif isinstance(exc, ConflictError):
            self._send_json(409, _status_body(409, "Conflict", str(exc)))
        elif isinstance(exc, ExpiredError):
            self._send_json(410, _status_body(410, "Expired", str(exc)))
        else:
            _log.exception("apiserver internal error")
            self._send_json(500, _status_body(500, "InternalError", str(exc)))

    def _read_body(self) -> Dict[str, Any]:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw or b"{}")

    # ------------------------------------------------------------------- verbs
    def do_GET(self) -> None:
        if not self._authorized():
            return
        if self._chaos_fault():
            return
        route, qs = self._parse()
        if route is None:
            self._send_json(404, _status_body(404, "NotFound", self.path))
            return
        try:
            if route.name is None:
                if qs.get("watch", ["false"])[0] == "true":
                    self._stream_watch(route, qs)
                    return
                selector = parse_label_selector(
                    qs.get("labelSelector", [""])[0])
                # Revision first, list second: an event landing in between is
                # replayed by a watch from this revision — duplicates are safe
                # for level-triggered consumers; gaps are not.
                rv = self.cluster.current_rv
                ns = (route.store_namespace if (route.namespace is not None
                                                or not route.rt.namespaced)
                      else None)
                items = self.cluster.list(route.rt.cls, ns, selector)
                self._send_json(200, {
                    "kind": f"{route.rt.kind}List",
                    "apiVersion": (f"{route.rt.group}/{route.rt.version}"
                                   if route.rt.group else route.rt.version),
                    "metadata": {"resourceVersion": str(rv)},
                    "items": [encode_obj(o) for o in items]})
                return
            if route.subresource == "log":
                tail = int(qs.get("tailLines", ["0"])[0])
                lines = self.cluster.read_pod_log(route.store_namespace,
                                                  route.name, tail=tail)
                body = ("\n".join(lines)).encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            obj = self.cluster.get(route.rt.cls, route.store_namespace,
                                   route.name)
            self._send_json(200, encode_obj(obj))
        # analyze: allow[silent-loss] exc becomes a typed HTTP Status response (_send_error_status)
        except Exception as exc:  # noqa: BLE001 — mapped to Status codes
            self._send_error_status(exc)

    def do_POST(self) -> None:
        if not self._authorized():
            return
        if self._chaos_fault():
            return
        route, _ = self._parse()
        if route is None:
            self._send_json(404, _status_body(404, "NotFound", self.path))
            return
        try:
            body = self._read_body()
            if route.subresource == "log":
                # kubelet-side log injection (divergence table: test seam)
                self.cluster.append_pod_log(route.store_namespace, route.name,
                                            body.get("line", ""))
                self._send_json(200, {"status": "ok"})
                return
            obj = decode_obj(route.rt, body)
            if route.rt.namespaced:
                obj.metadata.namespace = (route.namespace
                                          or obj.metadata.namespace)
            else:
                obj.metadata.namespace = ""
            created = self.cluster.create(obj)
            self._send_json(201, encode_obj(created))
        # analyze: allow[silent-loss] exc becomes a typed HTTP Status response (_send_error_status)
        except Exception as exc:  # noqa: BLE001
            self._send_error_status(exc)

    def do_PUT(self) -> None:
        if not self._authorized():
            return
        if self._chaos_fault():
            return
        route, _ = self._parse()
        if route is None or route.name is None:
            self._send_json(404, _status_body(404, "NotFound", self.path))
            return
        try:
            obj = decode_obj(route.rt, self._read_body())
            if not route.rt.namespaced:
                obj.metadata.namespace = ""
            sub = "status" if route.subresource == "status" else ""
            updated = self.cluster.update(obj, subresource=sub)
            self._send_json(200, encode_obj(updated))
        # analyze: allow[silent-loss] exc becomes a typed HTTP Status response (_send_error_status)
        except Exception as exc:  # noqa: BLE001
            self._send_error_status(exc)

    def do_PATCH(self) -> None:
        if not self._authorized():
            return
        if self._chaos_fault():
            return
        route, _ = self._parse()
        if route is None or route.name is None:
            self._send_json(404, _status_body(404, "NotFound", self.path))
            return
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype not in ("application/merge-patch+json",
                        "application/json", ""):
            self._send_json(415, _status_body(
                415, "UnsupportedMediaType",
                f"patch content type {ctype!r} not supported "
                f"(use application/merge-patch+json)"))
            return
        try:
            patched = self.cluster.merge_patch(
                route.rt.cls, route.store_namespace, route.name,
                self._read_body())
            self._send_json(200, encode_obj(patched))
        # analyze: allow[silent-loss] exc becomes a typed HTTP Status response (_send_error_status)
        except Exception as exc:  # noqa: BLE001
            self._send_error_status(exc)

    def do_DELETE(self) -> None:
        if not self._authorized():
            return
        if self._chaos_fault():
            return
        route, _ = self._parse()
        if route is None or route.name is None:
            self._send_json(404, _status_body(404, "NotFound", self.path))
            return
        try:
            self.cluster.delete(route.rt.cls, route.store_namespace,
                                route.name)
            self._send_json(200, {"kind": "Status", "status": "Success"})
        # analyze: allow[silent-loss] exc becomes a typed HTTP Status response (_send_error_status)
        except Exception as exc:  # noqa: BLE001
            self._send_error_status(exc)

    # -------------------------------------------------------------------- watch
    def _write_chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _watch_frame(self, etype: str, payload: Dict[str, Any]) -> bytes:
        return json.dumps({"type": etype, "object": payload}).encode() + b"\n"

    def _bookmark(self, route: _Route, rv: int) -> bytes:
        api_version = (f"{route.rt.group}/{route.rt.version}"
                       if route.rt.group else route.rt.version)
        return self._watch_frame("BOOKMARK", {
            "kind": route.rt.kind, "apiVersion": api_version,
            "metadata": {"resourceVersion": str(rv)}})

    def _stream_watch(self, route: _Route, qs: Dict[str, List[str]]) -> None:
        since: Optional[int] = None
        raw_rv = qs.get("resourceVersion", [""])[0]
        if raw_rv:
            since = int(raw_rv)
        bookmarks = qs.get("allowWatchBookmarks", ["false"])[0] == "true"

        sub = self.hub.subscribe(route.rt.kind)
        try:
            replay: List[WatchEvent] = []
            if since is not None:
                try:
                    replay = [e for e in self.cluster.events_since(since)
                              if e.kind == route.rt.kind]
                except ExpiredError as exc:
                    self._send_json(410, _status_body(410, "Expired", str(exc)))
                    return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            last_rv = since if since is not None else self.cluster.current_rv
            if bookmarks:
                self._write_chunk(self._bookmark(route, last_rv))

            def deliver(event: WatchEvent) -> None:
                nonlocal last_rv
                rv = event.obj.metadata.resource_version
                if rv <= last_rv:
                    return  # replay/live overlap — already sent
                if (route.namespace is not None
                        and event.obj.metadata.namespace != route.namespace):
                    last_rv = rv
                    return
                self._write_chunk(self._watch_frame(event.type,
                                                    encode_obj(event.obj)))
                last_rv = rv

            for event in replay:
                deliver(event)
            idle = 0
            while not self.stopping.is_set():
                if sub.overflowed.is_set():
                    break  # close: client re-lists (bounded-queue semantics)
                try:
                    event = sub.q.get(timeout=0.5)
                    idle = 0
                except queue.Empty:
                    idle += 1
                    if bookmarks and idle % 10 == 0:
                        # Bookmark the last revision actually DELIVERED on
                        # this stream — advertising cluster.current_rv could
                        # skip events still queued here if the client resumes
                        # from the bookmark after a drop.
                        self._write_chunk(self._bookmark(route, last_rv))
                    continue
                if event is _WatchHub._CLOSE:
                    break
                deliver(event)
                if chaos.fire(chaos.SITE_APISERVER_WATCH,
                              kind=route.rt.kind) is not None:
                    break  # injected server-side stream drop: the client
                           # must resume from its last delivered revision
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away
        finally:
            self.hub.unsubscribe(sub)
            try:
                self._write_chunk(b"")  # terminating chunk
            except OSError:
                pass


class ApiServer:
    """Lifecycle wrapper: `start()` serves on a background thread pool,
    `stop()` drains watch streams and shuts down."""

    def __init__(self, cluster: Optional[InMemoryCluster] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 tls_cert_path: Optional[str] = None,
                 tls_key_path: Optional[str] = None,
                 require_token: Optional[str] = None,
                 client_ca_path: Optional[str] = None) -> None:
        """``tls_cert_path``/``tls_key_path`` serve HTTPS (what a real
        apiserver always does); ``require_token`` additionally enforces
        Bearer auth on every verb — together they exercise the client's
        ca_path/token_path path instead of leaving it dead in tests.
        ``client_ca_path`` demands a client certificate signed by that CA
        (mutual TLS — the kubeconfig client-certificate auth mode)."""
        self.cluster = cluster or InMemoryCluster()
        self.hub = _WatchHub(self.cluster)
        self._stopping = threading.Event()
        handler = type("BoundHandler", (_Handler,), {
            "cluster": self.cluster, "hub": self.hub,
            "stopping": self._stopping, "require_token": require_token})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.tls = bool(tls_cert_path)
        if self.tls:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert_path, tls_key_path)
            if client_ca_path:
                ctx.verify_mode = ssl.CERT_REQUIRED
                ctx.load_verify_locations(cafile=client_ca_path)
            self._httpd.socket = ctx.wrap_socket(self._httpd.socket,
                                                 server_side=True)
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        scheme = "https" if self.tls else "http"
        return f"{scheme}://{self.host}:{self.port}"

    def start(self) -> "ApiServer":
        # analyze: allow[thread-roots] stdlib serve_forever only accepts sockets; the request threads it spawns are modeled by the http:_Handler root
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        kwargs={"poll_interval": 0.05},
                                        daemon=True, name="apiserver")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        self.hub.close()
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
