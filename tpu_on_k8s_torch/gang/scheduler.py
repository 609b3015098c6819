"""Gang scheduling: the PodGroup objects.

The part of ``tpu_on_k8s/gang/scheduler.py`` that the API and the cluster
client carry: the Volcano-style ``PodGroup`` kind the client's registry
routes (``client/resources.py``). The scheduler itself (the registry of
gang schedulers and the slice-aware admission) comes with the controllers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from tpu_on_k8s_torch.api.core import ObjectMeta


@dataclass
class PodGroupSpec:
    """Volcano PodGroupSpec analog (volcano.sh/apis scheduling/v1beta1)."""

    min_member: int = 1
    min_resources: Dict[str, float] = field(default_factory=dict)
    queue: str = ""
    priority_class_name: str = ""


@dataclass
class PodGroupStatus:
    phase: str = "Pending"  # Pending | Inqueue | Running
    admitted: int = 0


@dataclass
class PodGroup:
    api_version: str = "scheduling.distributed.torch.io/v1beta1"
    kind: str = "PodGroup"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodGroupSpec = field(default_factory=PodGroupSpec)
    status: PodGroupStatus = field(default_factory=PodGroupStatus)
