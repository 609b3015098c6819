"""Deterministic target-tracking recommender: SLO signals → replica target
(the counterpart of ``tpu_on_k8s/autoscale/policy.py``).

The decision core of the serving autoscaler, deliberately free of I/O so
every decision is a pure function of ``(observation, current replicas,
clock)`` plus a handful of monotone stamps — the property that makes two
runs of the same seeded trace produce byte-identical decision logs.

Policy shape (knobs live on the CRD as
`api/inference_types.AutoscalePolicy`):

* **SLO targets** — scale up when TTFT p95 or queue-wait p95 breaches
  the target by more than the hysteresis margin; scale down only when
  every configured signal reads comfortably BELOW target (the dead band
  between the two thresholds absorbs noise).
* **Utilization band** — tokens-in-flight per engine slot above
  ``util_high`` scales up even before latency degrades (queueing theory:
  at high utilization, wait explodes); below ``util_low`` (with an empty
  queue) it is scale-down evidence.
* **Slice-legal steps** — replicas occupy whole slices of 8-GPU hosts,
  and host counts come in topology quanta: steps land on
  `gang/topology.next_legal_host_count` values, never free-form N±1
  (1, 2, 4, 8 ... hosts).
* **Tempo** — separate scale-up/scale-down cooldowns (up is cheap to
  regret, down risks an SLO breach), flap damping (a direction reversal
  needs ``flap_guard_s`` since the opposite move), and a bounded step
  size scaled by breach severity.
* **Warm floor** — ``min_warm`` pre-provisions capacity for burst
  absorption: slice spin-up is minutes, not seconds, so a purely
  reactive policy structurally misses the front of every burst (the
  elastic-allocation argument in PAPERS.md). The floor overrides load
  evidence and is exempt from cooldowns — it is configuration, not
  reaction.
* **Outage** — a stale observation (see `autoscale/signals.py`) holds
  last-known-good. No data is never "no load".
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from tpu_on_k8s_torch.autoscale.signals import FleetObservation
from tpu_on_k8s_torch.controller.loopkernel import (
    CooldownGate,
    format_decision_line,
)
from tpu_on_k8s_torch.gang import topology

ACTION_UP = "up"
ACTION_DOWN = "down"
ACTION_HOLD = "hold"


@dataclasses.dataclass(frozen=True)
class Decision:
    """One recommendation. ``line()`` is the stable decision-log form
    (the shared `controller/loopkernel` serializer — byte-identical to
    the historical format): only observation-derived values
    (deterministic under an injected clock) — no wall time, no object
    ids."""

    seq: int
    action: str
    current: int
    target: int
    reason: str

    def line(self) -> str:
        return format_decision_line(self.seq, self.action, self.current,
                                    self.target, self.reason)


def _fmt(v: Optional[float]) -> str:
    return "none" if v is None else f"{v:.6f}"


class Recommender:
    """Target-tracking policy evaluation. ``decide()`` is pure (no state
    mutated); the caller ``commit()``s a decision only after executing
    it, so a failed patch never burns a cooldown window."""

    def __init__(self, policy, *, accelerator: str = "") -> None:
        # ``policy`` is an api.inference_types.AutoscalePolicy (duck-typed
        # to keep this module importable without the api layer in tests)
        self.policy = policy.normalized() if hasattr(policy, "normalized") \
            else policy
        self.accelerator = accelerator if getattr(
            self.policy, "slice_legal", True) else ""
        # tempo state lives in the shared loop-kernel gate: separate
        # up/down cooldowns + flap damping, stamped only on commit
        self.gate = CooldownGate(
            up_cooldown_s=getattr(self.policy, "scale_up_cooldown_s", 0.0),
            down_cooldown_s=getattr(self.policy, "scale_down_cooldown_s",
                                    0.0),
            flap_guard_s=getattr(self.policy, "flap_guard_s", 0.0))

    # ------------------------------------------------------------ legality
    def _step_up(self, cur: int) -> Optional[int]:
        if self.accelerator:
            return topology.next_legal_host_count(self.accelerator, cur)
        return cur + 1

    def _step_down(self, cur: int) -> Optional[int]:
        if self.accelerator:
            return topology.next_legal_host_count(self.accelerator, cur,
                                                  direction=-1)
        return cur - 1 if cur > 1 else None

    def legalize_up(self, desired: int) -> int:
        """Smallest legal count >= desired (identity without an
        accelerator)."""
        if self.accelerator:
            return topology.snap_host_count(self.accelerator, desired)
        return desired

    def legalize_down(self, desired: int) -> Optional[int]:
        """Largest legal count <= desired (identity without an
        accelerator; None when every legal count exceeds it)."""
        if not self.accelerator:
            return desired
        if desired in topology.legal_host_counts(self.accelerator):
            return desired
        return topology.next_legal_host_count(self.accelerator, desired,
                                              direction=-1)

    # ------------------------------------------------------------ decision
    def decide(self, obs: FleetObservation, cur: int, now: float, *,
               urgent: bool = False) -> Decision:
        """``urgent`` is the SLO engine's severity hint (an error-budget
        objective is PAGING — the SLO engine's burn rate): a scale-up that
        would otherwise sit out the up-cooldown executes immediately,
        marked ``slo_page`` in the reason. Nothing else changes — the
        flap guard, max bound, and slice legality all still apply, and
        the default (False) is byte-for-byte the pre-SLO decision path."""
        p = self.policy
        floor = max(p.min_replicas, p.min_warm)

        # warm floor first: pre-provisioned burst capacity is config, not
        # load reaction — no cooldown, no signal needed, stale or not.
        # The target stays slice-legal even when floor/max_replicas are
        # not themselves legal quanta: snap the floor up, and fall back
        # to the largest legal count under max if that overshoots.
        if cur < floor:
            target = self.legalize_up(floor)
            if target > p.max_replicas:
                target = self.legalize_down(p.max_replicas)
            if target is not None and target > cur:
                return Decision(obs.seq, ACTION_UP, cur, target,
                                f"warm_floor {floor}")

        if obs.stale:
            return Decision(obs.seq, ACTION_HOLD, cur, cur,
                            "stale_signal holding_last_known_good")

        up = self._up_reasons(obs)
        if up:
            return self._scale_up(obs, cur, now, up, urgent=urgent)
        if self._down_ok(obs, cur):
            return self._scale_down(obs, cur, now)
        return Decision(obs.seq, ACTION_HOLD, cur, cur, "steady")

    def commit(self, decision: Decision, now: float) -> None:
        """Record a *executed* scale (cooldown/flap stamps). Warm-floor
        bumps are exempt — they must not delay the first load-driven
        scale-up."""
        if decision.reason.startswith("warm_floor"):
            return
        self.gate.commit(decision.action, now)

    # ----------------------------------------------------------- internals
    def _up_reasons(self, obs: FleetObservation) -> List[str]:
        p = self.policy
        h = 1.0 + p.hysteresis
        reasons: List[str] = []
        if p.target_ttft_s > 0 and obs.ttft_p95 is not None \
                and obs.ttft_p95 > p.target_ttft_s * h:
            reasons.append(f"ttft_p95={_fmt(obs.ttft_p95)}"
                           f">slo={_fmt(p.target_ttft_s)}")
        if p.target_queue_wait_s > 0 and obs.queue_wait_p95 is not None \
                and obs.queue_wait_p95 > p.target_queue_wait_s * h:
            reasons.append(f"queue_wait_p95={_fmt(obs.queue_wait_p95)}"
                           f">slo={_fmt(p.target_queue_wait_s)}")
        tpot_slo = getattr(p, "target_tpot_s", 0.0)
        if tpot_slo > 0 and obs.tpot_p95 is not None \
                and obs.tpot_p95 > tpot_slo * h:
            reasons.append(f"tpot_p95={_fmt(obs.tpot_p95)}"
                           f">slo={_fmt(tpot_slo)}")
        # model swap-in latency: the multi-model cold-start signal — a
        # breach means models are churning through too little residency
        # and the fleet needs more replicas (duck-typed getattr like
        # tpot, so policy stubs without the knob keep working)
        swap_slo = getattr(p, "target_swap_s", 0.0)
        swap_p95 = getattr(obs, "swap_p95", None)
        if swap_slo > 0 and swap_p95 is not None \
                and swap_p95 > swap_slo * h:
            reasons.append(f"swap_p95={_fmt(swap_p95)}"
                           f">slo={_fmt(swap_slo)}")
        util = obs.tokens_per_slot
        if p.util_high > 0 and util is not None and util > p.util_high:
            reasons.append(f"tokens_per_slot={_fmt(util)}"
                           f">high={_fmt(p.util_high)}")
        return reasons

    def _severity(self, obs: FleetObservation) -> float:
        """Worst breach ratio across configured signals — how many
        bounded steps the scale-up takes (a 3x TTFT breach should not
        crawl up one quantum per cooldown window)."""
        p = self.policy
        worst = 1.0
        if p.target_ttft_s > 0 and obs.ttft_p95 is not None:
            worst = max(worst, obs.ttft_p95 / p.target_ttft_s)
        if p.target_queue_wait_s > 0 and obs.queue_wait_p95 is not None:
            worst = max(worst, obs.queue_wait_p95 / p.target_queue_wait_s)
        tpot_slo = getattr(p, "target_tpot_s", 0.0)
        if tpot_slo > 0 and obs.tpot_p95 is not None:
            worst = max(worst, obs.tpot_p95 / tpot_slo)
        swap_slo = getattr(p, "target_swap_s", 0.0)
        swap_p95 = getattr(obs, "swap_p95", None)
        if swap_slo > 0 and swap_p95 is not None:
            worst = max(worst, swap_p95 / swap_slo)
        util = obs.tokens_per_slot
        if p.util_high > 0 and util is not None:
            worst = max(worst, util / p.util_high)
        return worst

    def _scale_up(self, obs: FleetObservation, cur: int, now: float,
                  reasons: List[str], *, urgent: bool = False) -> Decision:
        p = self.policy
        reason = ",".join(reasons)
        if cur >= p.max_replicas:
            return Decision(obs.seq, ACTION_HOLD, cur, cur,
                            f"at_max {reason}")
        in_cooldown = self.gate.up_in_cooldown(now)
        if in_cooldown and not urgent:
            return Decision(obs.seq, ACTION_HOLD, cur, cur,
                            f"up_cooldown {reason}")
        if in_cooldown:
            # paged through the cooldown: the reason says so, so the
            # decision log attributes the early move to the budget burn
            reason = f"slo_page {reason}"
        if self.gate.flap_blocked(ACTION_UP, now):
            return Decision(obs.seq, ACTION_HOLD, cur, cur,
                            f"flap_damped {reason}")
        steps = min(p.max_step, max(1, int(self._severity(obs))))
        target = cur
        for _ in range(steps):
            nxt = self._step_up(target)
            if nxt is None or nxt > p.max_replicas:
                break
            target = nxt
        if target == cur:
            # the next legal quantum overshoots max_replicas: an
            # integer-mode policy would have stepped, a slice-legal one
            # is simply capped here
            return Decision(obs.seq, ACTION_HOLD, cur, cur,
                            f"at_max_legal {reason}")
        return Decision(obs.seq, ACTION_UP, cur, target, reason)

    def _down_ok(self, obs: FleetObservation, cur: int) -> bool:
        """Scale-down needs EVERY configured signal comfortably low.
        Missing latency data (no recent requests) counts as low only
        when the load gauges prove the fleet idle — absent data alone
        must never read as fast."""
        p = self.policy
        h = 1.0 - p.hysteresis
        tpot_slo = getattr(p, "target_tpot_s", 0.0)
        swap_slo = getattr(p, "target_swap_s", 0.0)
        idle = obs.queue_depth == 0 and obs.inflight_tokens == 0
        if not (p.target_ttft_s > 0 or p.target_queue_wait_s > 0
                or tpot_slo > 0 or swap_slo > 0 or p.util_low > 0):
            # no scale-down signal configured at all: a zero-signal
            # policy must hold, not ratchet a live fleet to min on
            # "queue happens to be empty"
            return False
        if obs.ready_replicas < cur:
            return False   # world still assembling — never shrink into it
        if obs.queue_depth > 0:
            return False
        if p.target_ttft_s > 0:
            if obs.ttft_p95 is None:
                if not idle:
                    return False
            elif obs.ttft_p95 >= p.target_ttft_s * h:
                return False
        if p.target_queue_wait_s > 0:
            if obs.queue_wait_p95 is None:
                if not idle:
                    return False
            elif obs.queue_wait_p95 >= p.target_queue_wait_s * h:
                return False
        if tpot_slo > 0:
            if obs.tpot_p95 is None:
                if not idle:
                    return False
            elif obs.tpot_p95 >= tpot_slo * h:
                return False
        if swap_slo > 0:
            # a breaching swap p95 blocks shrink; NO swap data does not
            # (an all-warm pool that never swaps is the goal state, not
            # missing evidence — unlike request latency, absence of
            # swaps under live traffic is itself a healthy signal)
            swap_p95 = getattr(obs, "swap_p95", None)
            if swap_p95 is not None and swap_p95 >= swap_slo * h:
                return False
        if p.util_low > 0:
            util = obs.tokens_per_slot
            if util is None or util >= p.util_low:
                return False
        return True

    def _scale_down(self, obs: FleetObservation, cur: int,
                    now: float) -> Decision:
        p = self.policy
        floor = max(p.min_replicas, p.min_warm)
        reason = (f"underutilized ttft_p95={_fmt(obs.ttft_p95)} "
                  f"tokens_per_slot={_fmt(obs.tokens_per_slot)}")
        if cur <= floor:
            return Decision(obs.seq, ACTION_HOLD, cur, cur, "at_floor")
        if self.gate.down_in_cooldown(now):
            return Decision(obs.seq, ACTION_HOLD, cur, cur,
                            f"down_cooldown {reason}")
        if self.gate.flap_blocked(ACTION_DOWN, now):
            return Decision(obs.seq, ACTION_HOLD, cur, cur,
                            f"flap_damped {reason}")
        nxt = self._step_down(cur)
        if nxt is None or nxt < floor:
            # the next quantum undershoots the floor: land on the
            # smallest legal count satisfying it instead (a raw clamp
            # to `floor` could emit a slice-illegal target)
            nxt = self.legalize_up(floor)
        if nxt >= cur:
            return Decision(obs.seq, ACTION_HOLD, cur, cur, "at_floor")
        return Decision(obs.seq, ACTION_DOWN, cur, nxt, reason)
