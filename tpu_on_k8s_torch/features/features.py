"""Feature-gate registry.

Analog of the reference's component-base featuregate wiring
(pkg/features/features.go): named boolean gates with defaults,
settable from config/CLI (``--feature-gates=GangScheduling=false,...``).
"""
from __future__ import annotations

import threading
from typing import Dict

GANG_SCHEDULING = "GangScheduling"        # beta, on (features.go:34)
DAG_SCHEDULING = "DAGScheduling"          # beta, on
JOB_COORDINATOR = "JobCoordinator"        # beta, on
LOCAL_MASTER_ADDR = "TorchLocalMasterAddr"  # beta, on — master uses localhost
                                            # as its own coordinator address
HOSTNET_HEADLESS_SVC = "HostNetWithHeadlessSvc"  # alpha, off

_DEFAULTS = {
    GANG_SCHEDULING: True,
    DAG_SCHEDULING: True,
    JOB_COORDINATOR: True,
    LOCAL_MASTER_ADDR: True,
    HOSTNET_HEADLESS_SVC: False,
}


class FeatureGates:
    def __init__(self, overrides: Dict[str, bool] | None = None) -> None:
        self._lock = threading.Lock()
        self._gates = dict(_DEFAULTS)
        if overrides:
            self.set_many(overrides)

    def enabled(self, name: str) -> bool:
        with self._lock:
            if name not in self._gates:
                raise KeyError(f"unknown feature gate {name!r}")
            return self._gates[name]

    def set(self, name: str, value: bool) -> None:
        with self._lock:
            if name not in self._gates:
                raise KeyError(f"unknown feature gate {name!r}")
            self._gates[name] = value

    def set_many(self, overrides: Dict[str, bool]) -> None:
        for k, v in overrides.items():
            self.set(k, v)

    @classmethod
    def parse(cls, spec: str) -> "FeatureGates":
        """Parse ``Name=true,Other=false`` CLI syntax."""
        overrides = {}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            name, _, val = part.partition("=")
            overrides[name] = val.strip().lower() in ("1", "true", "yes", "on", "")
        return cls(overrides)


def default_gates() -> FeatureGates:
    return FeatureGates()


# Process-wide default instance (per-component instances may override).
gates = FeatureGates()
