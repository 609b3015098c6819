"""Real container-runtime executor for the CRR node agent (the CRI shim; the
counterpart of ``tpu_on_k8s/client/cri.py``).

The reference's in-place restart terminates in kruise's node daemon doing an
actual CRI container kill; the kubelet then recreates the container under the
pod's restart policy and updates pod status itself
(controllers/common/failover.go:210-307 posts the CRR; the
kruise daemon executes it against the runtime). ``CriRuntime`` is that last
mile for this framework: it implements the same ``recreate_containers``
signature as the ``KubeletSim`` seam, but instead of writing pod status
through the API server it

1. resolves the pod's CRI sandbox by (namespace, name) and pins the pod
   incarnation via the ``io.kubernetes.pod.uid`` sandbox metadata
   (``expect_uid`` — a recreated same-name pod raises ``NotFoundError``,
   never a forged restart);
2. stops the target containers through the runtime (``crictl stop``), which
   is the CRI analog of kruise's kill;
3. waits READ-ONLY for the kubelet to bring up replacement containers (new
   container ids in ``CONTAINER_RUNNING`` state).

Pod status is therefore never written on this path — the kubelet owns it,
exactly the separation the CRR protocol exists to enforce.

The runtime is driven through ``crictl`` (present on any kubelet node; GKE
ships it) against the containerd socket rather than a hand-rolled gRPC
client: the image has no grpc stack, and crictl IS the stable CLI surface of
the CRI API. The command runner is injectable so tests drive the agent
against a recording fake-CRI double.
"""
from __future__ import annotations

import json
import subprocess
import time
from typing import Callable, Dict, List, Optional

from tpu_on_k8s_torch.client.cluster import NotFoundError

DEFAULT_ENDPOINT = "unix:///run/containerd/containerd.sock"


class CriError(RuntimeError):
    """A runtime invocation failed (crictl non-zero exit / unreachable
    socket). The node agent surfaces it as CRR Failed — the operator's
    recreate fallback is the safe degraded path."""


def _subprocess_runner(argv: List[str], timeout: float) -> str:
    try:
        proc = subprocess.run(argv, capture_output=True, text=True,
                              timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise CriError(f"{argv[0]}: {e}") from e
    if proc.returncode != 0:
        raise CriError(
            f"{' '.join(argv)} rc={proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout


class CriRuntime:
    """``recreate_containers`` against a real node's container runtime.

    ``runner(argv, timeout) -> stdout`` is the execution seam (tests inject a
    recording double; production uses the subprocess runner above).
    """

    def __init__(self, *, crictl: str = "crictl",
                 endpoint: str = DEFAULT_ENDPOINT,
                 runner: Optional[Callable[[List[str], float], str]] = None,
                 stop_timeout_seconds: int = 30,
                 wait_seconds: float = 60.0, poll_seconds: float = 0.5):
        self.crictl = crictl
        self.endpoint = endpoint
        self.runner = runner if runner is not None else _subprocess_runner
        self.stop_timeout_seconds = stop_timeout_seconds
        self.wait_seconds = wait_seconds
        self.poll_seconds = poll_seconds

    # ------------------------------------------------------------ CRI reads
    def _run(self, *args: str) -> str:
        argv = [self.crictl, "--runtime-endpoint", self.endpoint, *args]
        # command timeout: the stop itself may legitimately take the full
        # grace period, plus slack for the runtime to respond
        return self.runner(argv, self.stop_timeout_seconds + 30.0)

    def _json(self, *args: str) -> dict:
        out = self._run(*args)
        try:
            return json.loads(out) if out.strip() else {}
        except json.JSONDecodeError as e:
            raise CriError(f"unparseable crictl output: {out[:200]!r}") from e

    def _find_sandbox(self, namespace: str, name: str,
                      expect_uid: Optional[str]) -> str:
        data = self._json("pods", "--name", name, "--namespace", namespace,
                          "--state", "ready", "-o", "json")
        for item in data.get("items", []):
            meta = item.get("metadata", {})
            if meta.get("name") != name or meta.get("namespace") != namespace:
                continue  # crictl name filters are substring matches
            if expect_uid is not None and meta.get("uid") != expect_uid:
                raise NotFoundError(
                    f"pod {namespace}/{name} incarnation changed "
                    f"(sandbox uid {meta.get('uid')} != {expect_uid})")
            return item["id"]
        raise NotFoundError(
            f"no ready CRI sandbox for pod {namespace}/{name} on this node")

    def _containers(self, sandbox_id: str) -> List[dict]:
        data = self._json("ps", "-a", "--pod", sandbox_id, "-o", "json")
        return data.get("containers", [])

    # --------------------------------------------------------------- restart
    def recreate_containers(self, namespace: str, name: str,
                            containers: Optional[list] = None,
                            expect_uid: Optional[str] = None) -> None:
        """Stop the named containers (all, if empty) and wait for the kubelet
        to recreate them. Raises ``NotFoundError`` when the pod/sandbox is
        gone or its uid changed, ``TimeoutError`` when the kubelet does not
        bring replacements up in time, ``CriError`` on runtime failures."""
        sandbox = self._find_sandbox(namespace, name, expect_uid)
        wanted = set(containers or [])
        # Pick the LATEST attempt per container name: `ps -a` also returns
        # exited earlier attempts of the same container, and letting one of
        # those shadow the live id would make `stop` a no-op while the wait
        # loop immediately blesses the still-running current container as
        # the "replacement" — a forged restart.
        latest: Dict[str, dict] = {}
        for c in self._containers(sandbox):
            cname = c.get("metadata", {}).get("name")
            if wanted and cname not in wanted:
                continue
            attempt = c.get("metadata", {}).get("attempt", 0)
            if (cname not in latest
                    or attempt > latest[cname]["metadata"].get("attempt", 0)):
                latest[cname] = c
        missing = wanted - set(latest)
        if missing:
            raise CriError(
                f"containers {sorted(missing)} not found in pod "
                f"{namespace}/{name}")
        if not latest:
            raise CriError(f"pod {namespace}/{name} has no containers")
        old_ids: Dict[str, str] = {n: c["id"] for n, c in latest.items()}
        for c in latest.values():
            if c.get("state") != "CONTAINER_RUNNING":
                continue  # already stopped/crashed — kubelet recreates it
            try:
                self._run("stop", "--timeout",
                          str(self.stop_timeout_seconds), c["id"])
            except CriError as e:
                # a container that exited between list and stop is fine — the
                # kubelet will recreate it either way
                if "not found" not in str(e).lower():
                    raise
        deadline = time.monotonic() + self.wait_seconds
        while True:
            fresh = {}
            for c in self._containers(sandbox):
                cname = c.get("metadata", {}).get("name")
                if (cname in old_ids and c["id"] != old_ids[cname]
                        and c.get("state") == "CONTAINER_RUNNING"):
                    fresh[cname] = c["id"]
            if set(fresh) == set(old_ids):
                return
            if time.monotonic() >= deadline:
                waiting = sorted(set(old_ids) - set(fresh))
                raise TimeoutError(
                    f"kubelet did not recreate containers {waiting} of pod "
                    f"{namespace}/{name} within {self.wait_seconds}s")
            time.sleep(self.poll_seconds)
