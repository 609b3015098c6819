"""ContainerRecreateRequest: the in-place container-restart wire protocol.

Analog of OpenKruise's ``apps.kruise.io/v1alpha1 ContainerRecreateRequest``
exactly as the reference consumes it
(controllers/common/failover.go:210-307 and
controllers/train/elastic_scale.go:342-397): the OPERATOR
posts a CRR naming a pod and its containers, then polls its status; a
NODE-LEVEL agent (the kruise-daemon role — ``client.testing.NodeAgentLoop``
here) watches CRRs, restarts the containers via the container runtime, and
reports the phase. The operator never writes kubelet-owned pod status —
that separation is the whole point of the protocol, and what lets host
preemption recovery work on a real cluster.

Lifecycle (mirrors the reference's level-triggered state machine):

* one CRR per pod incarnation, named after the pod, labeled with the pod
  uid (the reference labels job generation; uid is the same idea one level
  tighter — a recreated pod must never be restarted by a stale CRR);
* a stale-label CRR is deleted and re-posted (failover.go:231-237);
* phase ``Failed`` ⇒ the operator falls back to delete+recreate
  (failover.go:242-247); ``Succeeded`` ⇒ the operator deletes the CRR
  (failover.go:258-262 — restarts are repeatable, the name must free up).
"""
from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field
from typing import List, Optional

from tpu_on_k8s_torch.api.core import ObjectMeta

API_VERSION_CRR = "apps.distributed.torch.io/v1alpha1"
KIND_CRR = "ContainerRecreateRequest"

# Operator-side label tying a CRR to one pod incarnation.
LABEL_CRR_POD_UID = "apps.distributed.torch.io/pod-uid"

PHASE_PENDING = "Pending"
PHASE_RECREATING = "Recreating"
PHASE_SUCCEEDED = "Succeeded"
PHASE_FAILED = "Failed"


@dataclass
class ContainerRecreateRequestSpec:
    pod_name: str = ""
    # container names to restart; empty = every container in the pod
    containers: List[str] = field(default_factory=list)
    ordered_recreate: bool = False
    # completed CRRs the operator crashed before collecting are reaped by
    # the node agent after this many seconds (kruise's ttlSecondsAfterFinished)
    ttl_seconds_after_finished: Optional[float] = None


@dataclass
class ContainerRecreateRequestStatus:
    phase: str = PHASE_PENDING
    message: str = ""
    completion_time: Optional[_dt.datetime] = None


@dataclass
class ContainerRecreateRequest:
    api_version: str = API_VERSION_CRR
    kind: str = KIND_CRR
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: ContainerRecreateRequestSpec = field(
        default_factory=ContainerRecreateRequestSpec)
    status: ContainerRecreateRequestStatus = field(
        default_factory=ContainerRecreateRequestStatus)


def finished(crr: ContainerRecreateRequest) -> bool:
    return crr.status.phase in (PHASE_SUCCEEDED, PHASE_FAILED)
