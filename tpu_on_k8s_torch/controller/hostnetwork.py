"""Host-network port management (the counterpart of
``tpu_on_k8s/controller/hostnetwork.py``).

Analog of controllers/common/hostnetwork.go: when a job is
annotated ``network-mode=host``, each pod gets a random port from the configured
range; container port and host port are rewritten to it, and the pod's normal
Service is target-port-patched so DNS keeps working (service.go:288-303).

Fixes the reference's container scan bug (hostnetwork.go:54-62 starts at index 1
and can index with ci=-1): we look up the default container by name with a safe
fallback to index 0.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Optional, Tuple

from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Pod

PortMap = Dict[str, int]  # pod name -> allocated host port


def enabled(annotations: Dict[str, str]) -> bool:
    return annotations.get(constants.ANNOTATION_NETWORK_MODE) == constants.NETWORK_MODE_HOST


def allocate_port(port_range: Tuple[int, int], rng: random.Random | None = None) -> int:
    lo, hi = port_range
    return (rng or random).randint(lo, hi - 1)


class PortAllocator:
    """In-use-aware host-port allocation.

    The reference draws blind from the range (hostnetwork.go:29-43 via
    pod.go:534-535) so two pods on one node can collide; here a port stays
    reserved from allocation until the pod's DELETED watch event releases it.
    Allocation is idempotent per pod key (re-reconciles of the same pod get
    the same port). Random probing keeps allocation O(1) while the range is
    mostly free; a linear sweep guarantees progress near exhaustion.
    """

    def __init__(self, port_range: Tuple[int, int],
                 rng: Optional[random.Random] = None) -> None:
        self._lo, self._hi = port_range
        self._rng = rng or random.Random()
        self._lock = threading.Lock()
        self._by_key: Dict[str, int] = {}  # "ns/pod-name" -> port
        self._in_use: set[int] = set()

    def allocate(self, key: str) -> int:
        with self._lock:
            if key in self._by_key:
                return self._by_key[key]
            if len(self._in_use) >= self._hi - self._lo:
                raise RuntimeError(
                    f"hostnetwork port range {self._lo}-{self._hi} exhausted")
            for _ in range(64):
                port = self._rng.randint(self._lo, self._hi - 1)
                if port not in self._in_use:
                    break
            else:
                port = next(p for p in range(self._lo, self._hi)
                            if p not in self._in_use)
            self._in_use.add(port)
            self._by_key[key] = port
            return port

    def reserve(self, key: str, port: int) -> None:
        """Adopt an existing pod's port (controller restart re-sync)."""
        with self._lock:
            self._by_key[key] = port
            self._in_use.add(port)

    def release(self, key: str) -> None:
        with self._lock:
            port = self._by_key.pop(key, None)
            if port is not None and port not in self._by_key.values():
                self._in_use.discard(port)

    def in_use_count(self) -> int:
        with self._lock:
            return len(self._in_use)


def setup_pod_hostnetwork(pod: Pod, port: int) -> None:
    """Switch the pod to hostNetwork and rewrite the coordinator port
    (hostnetwork.go:47-81, bug-fixed)."""
    pod.spec.host_network = True
    container = pod.spec.default_container()
    if container is None:
        return
    for p in container.ports:
        if p.name == constants.DEFAULT_PORT_NAME:
            p.container_port = port
            p.host_port = port
            return
    # No declared port: add one so the rewrite is still visible to env wiring.
    from tpu_on_k8s_torch.api.core import ContainerPort

    container.ports.append(
        ContainerPort(name=constants.DEFAULT_PORT_NAME, container_port=port, host_port=port)
    )
