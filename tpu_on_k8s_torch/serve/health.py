"""Replica health: readiness with slow-start, liveness by progress.

The fleet's analog of pod probes, driven per fleet step (deterministic —
no wall-clock, the same injectable-step discipline the gateway uses for
deadlines):

* **Readiness** — a replica must complete ``slow_start_steps``
  consecutive healthy steps before the router sends it traffic. A fresh
  replica's first requests pay prefill-program compiles; routing a full
  share at it immediately would tank fleet TTFT (the slow-start half of
  classic LB slow-start). Readiness can *flap* (an injected
  ``ReadinessFlap`` fault, or a real probe failure): the replica leaves
  the ready set and must re-earn its streak.
* **Liveness** — a replica that holds live requests but makes no progress
  (no tokens, no terminals) for ``stall_steps`` consecutive steps is
  **unhealthy**: the in-process shape of a wedged device step
  (``EngineStall``). The fleet ejects it and re-routes its work.

States:

    starting ──slow_start──► ready ◄──streak──┐
       ▲                        │ flap        │
       │                        ▼             │
       └──(new replica)      flapped ─────────┘
    ready/starting ──stall──► unhealthy (terminal: fleet ejects)
    draining / stopped are fleet-level, not probe-level
"""
from __future__ import annotations

import dataclasses
import enum


class ReplicaState(str, enum.Enum):
    """Fleet-visible replica lifecycle (probe states + fleet decisions)."""

    STARTING = "starting"      # slow-start: earning its readiness streak
    READY = "ready"            # routable
    DRAINING = "draining"      # stop_accepting issued; finishing in-flight
    EJECTED = "ejected"        # crashed / failed liveness; removed
    STOPPED = "stopped"        # drained cleanly and removed


#: states in which the replica is still stepped by the fleet
ACTIVE_STATES = frozenset({ReplicaState.STARTING, ReplicaState.READY,
                           ReplicaState.DRAINING})


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """``slow_start_steps`` healthy steps before READY (0 = ready at
    birth); ``stall_steps`` no-progress-while-busy steps before the
    liveness probe declares the replica wedged."""

    slow_start_steps: int = 3
    stall_steps: int = 20

    def __post_init__(self) -> None:
        if self.slow_start_steps < 0:
            raise ValueError(f"slow_start_steps must be >= 0, got "
                             f"{self.slow_start_steps}")
        if self.stall_steps < 1:
            raise ValueError(f"stall_steps must be >= 1, got "
                             f"{self.stall_steps}")


class HealthMonitor:
    """Per-replica probe state. ``observe_step`` is called once per fleet
    step with what actually happened; it returns the replica's
    probe-visible readiness (the fleet owns DRAINING/EJECTED/STOPPED)."""

    def __init__(self, probe: ProbeConfig) -> None:
        self.probe = probe
        self.healthy_streak = 0
        self.stall_streak = 0
        self.flap_steps_left = 0
        self.flaps = 0

    @property
    def ready(self) -> bool:
        return (self.flap_steps_left == 0
                and self.healthy_streak >= self.probe.slow_start_steps)

    @property
    def wedged(self) -> bool:
        return self.stall_streak >= self.probe.stall_steps

    def flap(self, steps: int) -> None:
        """Force not-ready for ``steps`` observations and reset the
        streak — the replica re-earns readiness through slow start."""
        self.flap_steps_left = max(self.flap_steps_left, steps)
        self.healthy_streak = 0
        self.flaps += 1

    def observe_step(self, *, progressed: bool, busy: bool) -> bool:
        """Record one step. ``progressed``: tokens emitted or requests
        retired this step; ``busy``: the replica held live work. An idle
        replica is healthy (nothing to prove); a busy one must move.
        Returns ``self.ready`` after the update."""
        if self.flap_steps_left > 0:
            self.flap_steps_left -= 1
        if busy and not progressed:
            self.stall_streak += 1
            self.healthy_streak = 0
        else:
            self.stall_streak = 0
            self.healthy_streak += 1
        return self.ready
