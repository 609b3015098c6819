"""Pod-failure classification and failover actions: the counterpart of
``tpu_on_k8s/controller/failover.py``.

Analog of controllers/common/failover.go — the exit-code taxonomy
(:64-99), retryable kill reasons (:106-113), the ``shouldPodFailover`` predicate
(:52-61, only under RestartPolicy.ON_EXIT_CODE), and the two recovery actions:
recreate (delete + let the engine recreate) and in-place restart (the OpenKruise
ContainerRecreateRequest protocol, abstracted behind ``InPlaceRestarter`` so a
GKE backend can post real CRRs while tests use the in-memory executor).

Slices (SURVEY §5.3): a preempted GPU host surfaces as an Evicted/Killed pod;
it classifies as retryable here, and slice-atomicity is enforced one level up —
a failed host invalidates its whole slice's gang, so the engine fails over the
slice's task group, not just the single pod.
"""
from __future__ import annotations

import enum
from typing import Optional, Protocol

from tpu_on_k8s_torch.api import constants, crr as crr_api
from tpu_on_k8s_torch.api.core import ObjectMeta, OwnerReference, Pod, PodPhase, utcnow
from tpu_on_k8s_torch.api.crr import ContainerRecreateRequest
from tpu_on_k8s_torch.api.types import RestartPolicy
from tpu_on_k8s_torch.client.cluster import (
    AlreadyExistsError,
    InMemoryCluster,
    NotFoundError,
)

# Exit-code taxonomy (failover.go:64-99).
PERMANENT_EXIT_CODES = {1, 2, 126, 127, 128, 139}
RETRYABLE_EXIT_CODES = {130, 137, 143}
USER_DEFINED_RETRYABLE_EXIT_CODE = 138

# Pod kill reasons that retry regardless of exit code (failover.go:106-113).
RETRYABLE_REASONS = {"OOMKilled", "Killed", "Evicted", "UnexpectedAdmissionError"}


class ExitClass(str, enum.Enum):
    PERMANENT = "permanent"
    RETRYABLE = "retryable"
    USER_RETRYABLE = "user-retryable"
    UNKNOWN = "unknown"


def classify_exit_code(code: int) -> ExitClass:
    if code == USER_DEFINED_RETRYABLE_EXIT_CODE:
        return ExitClass.USER_RETRYABLE
    if code in RETRYABLE_EXIT_CODES:
        return ExitClass.RETRYABLE
    if code in PERMANENT_EXIT_CODES:
        return ExitClass.PERMANENT
    return ExitClass.UNKNOWN


def pod_exit_code(pod: Pod) -> Optional[int]:
    """Highest-signal terminated exit code across containers (the reference
    captures the first non-zero main-container code)."""
    best: Optional[int] = None
    for cs in pod.status.container_statuses:
        if cs.terminated is not None:
            code = cs.terminated.exit_code
            if code != 0:
                return code
            best = code
    return best


def should_pod_failover(pod: Pod, restart_policy: RestartPolicy) -> bool:
    """True if a Failed pod should be recovered rather than counted as a
    permanent failure (failover.go:52-61). Only RestartPolicy.ON_EXIT_CODE
    consults the taxonomy; OnFailure always retries; Never/Always do not
    failover here (Always is handled by the kubelet)."""
    if pod.status.phase != PodPhase.FAILED:
        return False
    if restart_policy == RestartPolicy.ON_FAILURE:
        return True
    if restart_policy != RestartPolicy.ON_EXIT_CODE:
        return False
    if pod.status.reason in RETRYABLE_REASONS:
        return True
    code = pod_exit_code(pod)
    if code is None:
        return False
    return classify_exit_code(code) in (ExitClass.RETRYABLE, ExitClass.USER_RETRYABLE)


class RestartOutcome(enum.Enum):
    """Level-triggered in-place-restart protocol states. ``PENDING`` means a
    CRR is in flight and the caller must re-drive on a later reconcile pass
    — never block a reconcile waiting for a node agent. Truthiness follows
    the old bool seam: only a completed restart is truthy."""

    RESTARTED = "restarted"
    PENDING = "pending"
    FAILED = "failed"

    def __bool__(self) -> bool:
        return self is RestartOutcome.RESTARTED


class InPlaceRestarter(Protocol):
    """CRR executor seam (failover.go:210-307). Returns a ``RestartOutcome``
    (or a legacy bool — normalized by ``failover_inplace_restart``); on
    FAILED the caller falls back to delete+recreate (:242-247)."""

    def restart(self, cluster: InMemoryCluster, pod: Pod): ...


class InMemoryRestarter:
    """Test/local executor: resets the pod to Running in place and bumps
    restart counts — what the kruise daemon's CRI restart looks like from the
    API server's perspective. Only legitimate against the in-memory backend,
    where no kubelet owns pod status; a real (REST) cluster takes
    ``CRRRestarter``."""

    def restart(self, cluster: InMemoryCluster, pod: Pod) -> RestartOutcome:
        def mutate(p: Pod) -> None:
            p.status.phase = PodPhase.RUNNING
            p.status.reason = ""
            for cs in p.status.container_statuses:
                cs.ready = True
                cs.restart_count += 1
                cs.terminated = None

        try:
            cluster.update_with_retry(
                Pod, pod.metadata.namespace, pod.metadata.name, mutate,
                subresource="status")
            return RestartOutcome.RESTARTED
        except NotFoundError:
            return RestartOutcome.FAILED


class CRRRestarter:
    """Kruise-protocol executor (failover.go:210-307): post a
    ``ContainerRecreateRequest`` and let the NODE AGENT restart the
    containers — the operator never writes kubelet-owned pod status.

    LEVEL-TRIGGERED, like the reference: each ``restart`` call makes ONE
    observation of the CRR and returns immediately — ``PENDING`` while the
    node agent works, so a whole failing slice costs a reconcile pass
    O(n × API-roundtrip), never O(n × node-agent-latency).
    ``wait_seconds`` is a deadline measured from the CRR's
    creationTimestamp ACROSS passes, not an in-pass poll. States:

    * no CRR ⇒ post one (named after the pod, labeled with the pod uid),
      return PENDING;
    * stale-uid CRR (older pod incarnation) ⇒ delete, return PENDING
      (re-posted next pass, failover.go:231-237);
    * ``Failed`` ⇒ delete the CRR, return FAILED — the caller falls back to
      delete+recreate (failover.go:242-247);
    * ``Succeeded`` with the pod actually Running ⇒ delete the CRR
      (restarts are repeatable; the name must free up, failover.go:258-262),
      return RESTARTED. A Succeeded CRR whose pod is NOT Running is a stale
      leftover from an earlier incident (e.g. an uncollected slice-sibling
      restart) — deleted, PENDING, so a fresh CRR drives the real restart;
    * CRR older than ``wait_seconds`` (no node agent alive / node dead) ⇒
      delete, return FAILED — recreate is the safe degraded path: on a real
      cluster a dead kruise daemon usually means a dead node.
    """

    def __init__(self, cluster: InMemoryCluster, *,
                 wait_seconds: float = 60.0):
        self.cluster = cluster
        self.wait_seconds = wait_seconds

    def _post(self, pod: Pod) -> None:
        labels = {crr_api.LABEL_CRR_POD_UID: pod.metadata.uid}
        job_name = pod.metadata.labels.get(constants.LABEL_JOB_NAME, "")
        if job_name:
            # the job label lets the operator's watch requeue the owning job
            # when the node agent updates the CRR phase (level-triggered
            # protocols advance on events, not on polling)
            labels[constants.LABEL_JOB_NAME] = job_name
        req = ContainerRecreateRequest(
            metadata=ObjectMeta(
                name=pod.metadata.name,
                namespace=pod.metadata.namespace,
                labels=labels,
                owner_references=[OwnerReference(
                    api_version="v1", kind="Pod", name=pod.metadata.name,
                    uid=pod.metadata.uid, controller=False,
                    block_owner_deletion=True)],
            ),
            spec=crr_api.ContainerRecreateRequestSpec(
                pod_name=pod.metadata.name,
                containers=[c.name for c in pod.spec.containers],
                ttl_seconds_after_finished=300.0,
            ),
        )
        try:
            self.cluster.create(req)
        except AlreadyExistsError:
            pass  # another reconcile won the race; adopt theirs

    def _delete(self, namespace: str, name: str) -> None:
        try:
            self.cluster.delete(ContainerRecreateRequest, namespace, name)
        except NotFoundError:
            pass

    def restart(self, cluster: InMemoryCluster, pod: Pod) -> RestartOutcome:
        del cluster  # protocol seam passes it; this executor owns its client
        ns, name = pod.metadata.namespace, pod.metadata.name
        req = self.cluster.try_get(ContainerRecreateRequest, ns, name)
        if req is None:
            if self.cluster.try_get(Pod, ns, name) is None:
                return RestartOutcome.FAILED  # pod vanished; nothing to do
            self._post(pod)
            return RestartOutcome.PENDING
        if (req.metadata.labels.get(crr_api.LABEL_CRR_POD_UID)
                != pod.metadata.uid):
            self._delete(ns, name)  # stale incarnation's CRR
            return RestartOutcome.PENDING
        if req.status.phase == crr_api.PHASE_FAILED:
            self._delete(ns, name)
            return RestartOutcome.FAILED
        if req.status.phase == crr_api.PHASE_SUCCEEDED:
            self._delete(ns, name)
            live = self.cluster.try_get(Pod, ns, name)
            if live is not None and live.status.phase == PodPhase.RUNNING:
                return RestartOutcome.RESTARTED
            # stale success (pod failed again, or success from an earlier
            # uncollected incident): a fresh CRR drives the real restart
            return RestartOutcome.PENDING
        created = req.metadata.creation_timestamp
        age = ((utcnow() - created).total_seconds()
               if created is not None else 0.0)
        if age >= self.wait_seconds:
            # leave no orphan that could fire after our recreate fallback
            self._delete(ns, name)
            return RestartOutcome.FAILED
        return RestartOutcome.PENDING

    def collect(self, pod: Pod) -> Optional[RestartOutcome]:
        """Observe-only: settle an in-flight CRR WITHOUT ever posting a new
        one. Used to re-drive fire-and-forget restarts (slice siblings) —
        consuming their Succeeded/Failed CRRs so the name frees up without
        risking a posting loop. Returns None when no CRR for this pod
        incarnation exists."""
        ns, name = pod.metadata.namespace, pod.metadata.name
        req = self.cluster.try_get(ContainerRecreateRequest, ns, name)
        if req is None or (req.metadata.labels.get(crr_api.LABEL_CRR_POD_UID)
                           != pod.metadata.uid):
            return None
        if req.status.phase == crr_api.PHASE_SUCCEEDED:
            self._delete(ns, name)
            return RestartOutcome.RESTARTED
        if req.status.phase == crr_api.PHASE_FAILED:
            self._delete(ns, name)
            return RestartOutcome.FAILED
        created = req.metadata.creation_timestamp
        if (created is not None
                and (utcnow() - created).total_seconds() >= self.wait_seconds):
            self._delete(ns, name)
            return RestartOutcome.FAILED
        return RestartOutcome.PENDING


def failover_recreate(cluster: InMemoryCluster, pod: Pod) -> bool:
    """Delete the failed pod; the engine's next reconcile recreates it
    (failover.go:149-172). Stamps the failover timestamp annotation first.
    Returns False if the pod was already gone (caller must drain any deletion
    expectation it raised)."""
    try:
        cluster.patch_meta(
            Pod, pod.metadata.namespace, pod.metadata.name,
            annotations={constants.ANNOTATION_LAST_FAILOVER_TIMESTAMP: utcnow().isoformat()},
            # The victim must actually go away: failover delete overrides the
            # preempt-protector (it is not a preemption).
            remove_finalizers=[constants.FINALIZER_PREEMPT_PROTECTOR],
        )
        cluster.delete(Pod, pod.metadata.namespace, pod.metadata.name)
        return True
    except NotFoundError:
        return False


def failover_inplace_restart(
    cluster: InMemoryCluster, pod: Pod, restarter: Optional[InPlaceRestarter]
) -> RestartOutcome:
    """In-place restart via the CRR seam, falling back to recreate
    (failover.go:210-264). RESTARTED = the pod was restarted in place;
    PENDING = a CRR is in flight, re-drive on a later reconcile pass;
    FAILED = the restart was impossible and a recreate happened instead.
    Legacy executors returning a bool are normalized (True→RESTARTED,
    False→FAILED)."""
    if restarter is None:
        failover_recreate(cluster, pod)
        return RestartOutcome.FAILED
    out = restarter.restart(cluster, pod)
    if isinstance(out, bool):
        out = RestartOutcome.RESTARTED if out else RestartOutcome.FAILED
    if out is RestartOutcome.FAILED:
        failover_recreate(cluster, pod)
    return out
