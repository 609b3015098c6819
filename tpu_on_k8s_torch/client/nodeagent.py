"""The CRR node agent — the OpenKruise-daemon role as a deployable actor
(the counterpart of ``tpu_on_k8s/client/nodeagent.py``).

``NodeAgentLoop`` watches ``ContainerRecreateRequest`` objects over its own
cluster connection and executes them against the node's container runtime —
which, from the API server's point of view, is the pod-status surface the
kubelet owns. With it running, the operator's ``CRRRestarter``
(`tpu_on_k8s_torch/controller/failover.py`) never forges pod status; that
separation is what the reference buys by delegating in-place restarts to
kruise's node daemon (controllers/common/failover.go:210-307).

Deployed per node as a DaemonSet under its own ServiceAccount. With the
``CriRuntime`` the agent NEVER writes pod status — it stops containers
through the node's CRI socket (`tpu_on_k8s_torch/client/cri.py`) and the
kubelet owns the status surface, so the node agent needs no
``pods/status`` verbs at all. The runtime is an injectable seam:
``KubeletSim`` is the status-write
surface for tests / local drivers / simulated clusters where no kubelet
owns pod status — it needs ``pods/status`` re-granted and is never legal on
a real node.
"""
from __future__ import annotations

import threading
from typing import Optional

from tpu_on_k8s_torch.api import crr as crr_api
from tpu_on_k8s_torch.api.core import Pod, utcnow
from tpu_on_k8s_torch.api.crr import ContainerRecreateRequest
from tpu_on_k8s_torch.client.cluster import ConflictError, NotFoundError
from tpu_on_k8s_torch.client.cri import CriError
from tpu_on_k8s_torch.client.testing import KubeletSim


class NodeAgentLoop:
    """Honors ``ContainerRecreateRequest`` objects (the kruise-daemon side
    of reference failover.go:210-307):

    * a Pending CRR whose pod exists (and, for a node-scoped agent, is bound
      to this node) transitions ``Recreating`` → container restart →
      ``Succeeded`` + completion_time;
    * a CRR naming a missing pod — or one whose pod uid no longer matches
      the CRR's pod-uid label — is marked ``Failed`` (the operator falls
      back to delete+recreate on seeing it); the uid is ALSO re-verified
      inside the restart write itself, so a pod replaced mid-flight can
      never be forged to Running;
    * finished CRRs the operator never collected are reaped after
      ``ttl_seconds_after_finished`` (kruise's TTL reaper).

    ``node_name=None`` serves every node — one agent standing in for the
    whole DaemonSet, which is what single-process tests and the local
    driver run.

    EVENT-DRIVEN, not a poll loop: ``start()`` subscribes a watch on the
    CRR kind only (one informer stream per node, not one per resource
    type) and a worker drains a deduplicating key queue. The steady state
    issues NO full-collection LISTs — a polling agent would LIST every
    CRR in the cluster every 100 ms from every node, the exact hot loop
    informers exist to kill. A slow resync (``resync_seconds``, default
    5 min) is the belt-and-braces pass for a missed event; TTL reaping of
    finished CRRs is scheduled per object at its expiry instead of being
    rediscovered by polling.
    """

    WATCH_KINDS = frozenset({"ContainerRecreateRequest"})

    def __init__(self, cluster, *, node_name: Optional[str] = None,
                 poll_seconds: float = 0.02, runtime=None,
                 resync_seconds: float = 300.0):
        del poll_seconds  # legacy poll-loop cadence; kept for call compat
        self.cluster = cluster
        self.runtime = runtime if runtime is not None else KubeletSim(cluster)
        self.node_name = node_name
        self.resync_seconds = resync_seconds
        self.executed = 0  # restarts this agent performed (observability)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._cond = threading.Condition()
        self._queue: set = set()          # pending (namespace, name) keys
        self._timers: list = []           # TTL-reap timers (cancelled on stop)

    def start(self) -> "NodeAgentLoop":
        self.cluster.watch(self._on_event, kinds=self.WATCH_KINDS)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="node-agent")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
            # snapshot under the condition: the agent thread rebuilds
            # this list in _schedule_reap — cancelling a concurrent
            # rebuild's OLD list would let a fresh TTL timer escape and
            # fire into a torn-down cluster
            pending, self._timers = self._timers, []
        for t in pending:
            t.cancel()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    # ---------------------------------------------------------------- wiring
    def _on_event(self, event) -> None:
        if event.kind != "ContainerRecreateRequest" or event.type == "DELETED":
            return
        self._enqueue((event.obj.metadata.namespace, event.obj.metadata.name))

    def _enqueue(self, key) -> None:
        with self._cond:
            self._queue.add(key)
            self._cond.notify()

    def _schedule_reap(self, key, delay: float) -> None:
        if self._thread is None:  # pull-mode (sync_once) drives its own TTL
            return
        timer = threading.Timer(delay, self._enqueue, args=(key,))
        timer.daemon = True
        with self._cond:
            if self._stop.is_set():
                return       # racing stop(): its snapshot already ran
            timer.start()    # start inside the guard, or a timer armed
            self._timers = [t for t in self._timers if t.is_alive()] \
                + [timer]    # between snapshot and append escapes cancel

    # ------------------------------------------------------------------ engine
    def _set_phase(self, req: ContainerRecreateRequest, phase: str,
                   message: str = "") -> bool:
        def mutate(r: ContainerRecreateRequest) -> None:
            r.status.phase = phase
            r.status.message = message
            if phase in (crr_api.PHASE_SUCCEEDED, crr_api.PHASE_FAILED):
                r.status.completion_time = utcnow()

        try:
            self.cluster.update_with_retry(
                ContainerRecreateRequest, req.metadata.namespace,
                req.metadata.name, mutate, subresource="status")
            return True
        except NotFoundError:
            return False  # operator collected/cancelled it mid-flight

    def _handle(self, req: ContainerRecreateRequest) -> None:
        ns = req.metadata.namespace
        if crr_api.finished(req):
            ttl = req.spec.ttl_seconds_after_finished
            done = req.status.completion_time
            if ttl is not None and done is not None:
                remaining = ttl - (utcnow() - done).total_seconds()
                if remaining <= 0:
                    try:
                        self.cluster.delete(ContainerRecreateRequest, ns,
                                            req.metadata.name)
                    except NotFoundError:
                        pass
                else:
                    # event-driven TTL: revisit this object at its expiry
                    # instead of rediscovering it by polling the collection
                    self._schedule_reap((ns, req.metadata.name),
                                        remaining + 0.05)
            return
        pod = self.cluster.try_get(Pod, ns, req.spec.pod_name)
        want_uid = req.metadata.labels.get(crr_api.LABEL_CRR_POD_UID)
        if pod is None or (want_uid and pod.metadata.uid != want_uid):
            self._set_phase(req, crr_api.PHASE_FAILED,
                            "target pod missing or replaced")
            return
        if self.node_name is not None and pod.spec.node_name != self.node_name:
            return  # another node's daemon owns this one
        if req.status.phase != crr_api.PHASE_RECREATING:
            if not self._set_phase(req, crr_api.PHASE_RECREATING):
                return
        try:
            # expect_uid re-verifies the incarnation INSIDE the retried
            # write: a pod deleted+recreated between the check above and
            # this call raises NotFound instead of forging the new pod
            self.runtime.recreate_containers(
                ns, req.spec.pod_name, req.spec.containers,
                expect_uid=want_uid or pod.metadata.uid)
        except NotFoundError:
            self._set_phase(req, crr_api.PHASE_FAILED,
                            "pod deleted or replaced mid-restart")
            return
        except (TimeoutError, CriError) as e:
            # runtime-level failure (dead containerd, kubelet not recreating):
            # Failed tells the operator to take the recreate fallback
            self._set_phase(req, crr_api.PHASE_FAILED,
                            f"runtime restart failed: {e}")
            return
        self.executed += 1
        self._set_phase(req, crr_api.PHASE_SUCCEEDED)

    def sync_once(self) -> None:
        """One pull-based pass (tests drive this directly for determinism)."""
        for req in self.cluster.list(ContainerRecreateRequest):
            try:
                self._handle(req)
            except (ConflictError, NotFoundError):
                pass  # racing the operator's collect/cancel — next pass settles

    def _loop(self) -> None:
        # One initial pass: the in-memory backend's watch delivers no cache
        # replay, and CRRs posted before start() must not wait for a resync.
        try:
            self.sync_once()
        # startup pre-pass: the 5-min resync re-runs sync_once and CRR status
        # surfaces real failures
        except Exception:  # noqa: BLE001 — the daemon must survive blips
            pass
        while not self._stop.is_set():
            with self._cond:
                if not self._queue:
                    self._cond.wait(timeout=self.resync_seconds)
                keys = list(self._queue)
                self._queue.clear()
            if self._stop.is_set():
                return
            if not keys:
                # resync heartbeat (5-minute default): catches a missed
                # event; NOT the steady-state path
                try:
                    self.sync_once()
                # resync heartbeat blip: the next heartbeat retries, CRR
                # status is the durable signal
                except Exception:  # noqa: BLE001
                    pass
                continue
            for key in keys:
                try:
                    req = self.cluster.try_get(ContainerRecreateRequest, *key)
                    if req is not None:
                        self._handle(req)
                except (ConflictError, NotFoundError):
                    pass  # racing the operator's collect — resync settles it
                # per-key blip: the key is re-queued by the next watch
                # event or resync
                except Exception:  # noqa: BLE001 — the daemon must survive
                    pass
