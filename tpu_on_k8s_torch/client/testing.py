"""Kubelet simulation for tests and local runs.

The reference's intended envtest strategy runs a real API server but no kubelet,
so controllers are driven by manipulating pod status (SURVEY §4). ``KubeletSim``
packages those manipulations: admit pods to nodes, run/succeed/fail containers
with exit codes, simulate preemption/eviction. It is also the injectable
container runtime behind the deployable CRR node agent
(``NodeAgentLoop``, which comes with the failover controllers) — the restart
surface a real CRI shim would implement.
"""
from __future__ import annotations

from typing import Optional

from tpu_on_k8s_torch.api.core import (
    Condition,
    ContainerStateTerminated,
    ContainerStatus,
    Pod,
    PodPhase,
    utcnow,
)
from tpu_on_k8s_torch.client.cluster import InMemoryCluster, NotFoundError


def append_pod_log(cluster, namespace: str, name: str, line: str) -> None:
    """Kubelet-side log injection — the TEST SEAM for pod logs.

    A real training container's stdout reaches ``pods/{name}/log`` via the
    kubelet, not via any client verb, so the REST client deliberately has no
    log-append method (``POST .../pods/{name}/log`` is not a Kubernetes verb;
    see the divergence table in `tpu_on_k8s_torch/client/apiserver.py`). Tests and
    the kubelet sim inject log lines here: directly into the in-memory store,
    or over the test apiserver's private log endpoint for REST backends.
    """
    if hasattr(cluster, "append_pod_log"):       # InMemoryCluster store
        cluster.append_pod_log(namespace, name, line)
        return
    from urllib.parse import quote
    cluster._request(                            # test-only seam into ApiServer
        "POST", f"/api/v1/namespaces/{namespace}/pods/{quote(name)}/log",
        {"line": line})


class KubeletSim:
    def __init__(self, cluster: InMemoryCluster) -> None:
        self.cluster = cluster
        self._ip = 0

    def _set(self, namespace: str, name: str, mutate) -> Pod:
        return self.cluster.update_with_retry(Pod, namespace, name, mutate, subresource="status")

    def run_pod(self, namespace: str, name: str, node: str = "node-0") -> Pod:
        """Pending → Running + Ready, with IP and node assigned."""
        self._ip += 1
        ip = f"10.0.0.{self._ip}"

        def mutate(pod: Pod) -> None:
            pod.status.phase = PodPhase.RUNNING
            pod.status.pod_ip = ip
            pod.status.host_ip = ip
            pod.status.start_time = pod.status.start_time or utcnow()
            pod.status.conditions = [Condition(type="Ready", status="True", last_transition_time=utcnow())]
            pod.status.container_statuses = [
                ContainerStatus(name=c.name, ready=True) for c in pod.spec.containers
            ]
            if not pod.spec.node_name:
                pod.spec.node_name = node

        pod = self.cluster.get(Pod, namespace, name)
        if not pod.spec.node_name:
            # node assignment is a spec write; status subresource won't persist it
            self.cluster.update_with_retry(
                Pod, namespace, name, lambda p: setattr(p.spec, "node_name", node))
        return self._set(namespace, name, mutate)

    def run_all(self, namespace: str, label_selector=None, node: str = "node-0") -> int:
        n = 0
        for pod in self.cluster.list(Pod, namespace, label_selector):
            if pod.status.phase == PodPhase.PENDING and pod.metadata.deletion_timestamp is None:
                self.run_pod(namespace, pod.metadata.name, node=f"{node[:5]}-{n}")
                n += 1
        return n

    def terminate_pod(self, namespace: str, name: str, exit_code: int,
                      reason: str = "", phase: Optional[str] = None) -> Pod:
        """Terminate the main container with an exit code; phase derives from the
        code unless forced."""
        if phase is None:
            phase = PodPhase.SUCCEEDED if exit_code == 0 else PodPhase.FAILED

        def mutate(pod: Pod) -> None:
            pod.status.phase = phase
            pod.status.reason = reason
            pod.status.conditions = [Condition(type="Ready", status="False", last_transition_time=utcnow())]
            pod.status.container_statuses = [
                ContainerStatus(
                    name=c.name,
                    ready=False,
                    terminated=ContainerStateTerminated(exit_code=exit_code, reason=reason),
                )
                for c in pod.spec.containers
            ]

        return self._set(namespace, name, mutate)

    def succeed_pod(self, namespace: str, name: str) -> Pod:
        return self.terminate_pod(namespace, name, 0)

    def fail_pod(self, namespace: str, name: str, exit_code: int = 1, reason: str = "Error") -> Pod:
        return self.terminate_pod(namespace, name, exit_code, reason=reason)

    def log_line(self, namespace: str, name: str, line: str) -> None:
        """Emit a line into the pod's log stream (training stdout analog)."""
        append_pod_log(self.cluster, namespace, name, line)

    def evict_pod(self, namespace: str, name: str) -> Pod:
        """Node-pressure eviction (retryable failure class, failover.go:106-113)."""
        return self.terminate_pod(namespace, name, 137, reason="Evicted", phase=PodPhase.FAILED)

    def recreate_containers(self, namespace: str, name: str,
                            containers: Optional[list] = None,
                            expect_uid: Optional[str] = None) -> Pod:
        """What a CRI container restart looks like from the API server: the
        named containers (all, if empty) come back ready with restart_count
        bumped, and the pod returns to Running.

        ``expect_uid`` pins the pod incarnation: the check runs INSIDE the
        retried mutate (under the update's resourceVersion precondition), so
        a pod recreated under the same name between the caller's read and
        this write can never be forged to Running — it raises NotFound, the
        same outcome as the pod vanishing."""
        wanted = set(containers or [])

        def mutate(pod: Pod) -> None:
            if expect_uid is not None and pod.metadata.uid != expect_uid:
                raise NotFoundError(
                    f"pod {namespace}/{name} incarnation changed "
                    f"(uid {pod.metadata.uid} != {expect_uid})")
            pod.status.phase = PodPhase.RUNNING
            pod.status.reason = ""
            pod.status.conditions = [Condition(
                type="Ready", status="True", last_transition_time=utcnow())]
            if not pod.status.container_statuses:
                pod.status.container_statuses = [
                    ContainerStatus(name=c.name) for c in pod.spec.containers]
            for cs in pod.status.container_statuses:
                if wanted and cs.name not in wanted:
                    continue
                cs.ready = True
                cs.restart_count += 1
                cs.terminated = None

        return self._set(namespace, name, mutate)


class KubeletLoop:
    """Background kubelet: polls for Pending pods and runs them, keyed on pod
    uid so a recreated pod (same name, new uid) runs again — real kubelets key
    on uid the same way. ``scheduled_only=True`` models a kubelet that only
    runs pods a scheduler has bound to a node (the gang-admission tests);
    ``auto_succeed=True`` completes pods as soon as they run (build-pod /
    batch-job sims). Works against any cluster backend (in-memory or REST).
    """

    def __init__(self, cluster, *, scheduled_only: bool = False,
                 auto_succeed: bool = False, poll_seconds: float = 0.02):
        import threading

        self.sim = KubeletSim(cluster)
        self.cluster = cluster
        self.scheduled_only = scheduled_only
        self.auto_succeed = auto_succeed
        self.poll_seconds = poll_seconds
        self._stop = threading.Event()
        self._thread: Optional[object] = None

    def start(self) -> "KubeletLoop":
        import threading

        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="kubelet-loop")
        self._thread.start()
        return self

    def _loop(self) -> None:
        ran = set()
        while not self._stop.is_set():
            for p in self.cluster.list(Pod):
                if p.metadata.deletion_timestamp is not None:
                    continue
                key = (p.metadata.name, p.metadata.uid)
                if (key not in ran and p.status.phase == PodPhase.PENDING
                        and (p.spec.node_name or not self.scheduled_only)):
                    try:
                        self.sim.run_pod(p.metadata.namespace,
                                        p.metadata.name,
                                        node=p.spec.node_name or "node-0")
                        ran.add(key)
                    # analyze: allow[silent-loss] test-harness kubelet racing reconciler deletes; next poll settles
                    except Exception:  # noqa: BLE001 — races with reconciles
                        pass
                elif (self.auto_succeed
                      and p.status.phase == PodPhase.RUNNING):
                    try:
                        self.sim.succeed_pod(p.metadata.namespace,
                                             p.metadata.name)
                    # analyze: allow[silent-loss] same reconciler race on the auto-succeed edge; next poll settles
                    except Exception:  # noqa: BLE001
                        pass
            self._stop.wait(self.poll_seconds)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
