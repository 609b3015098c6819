"""The shared control-loop kernel: observe → decide → commit, once (the
counterpart of ``tpu_on_k8s/controller/loopkernel.py``).

Every closed loop in the stack — the ElasticAutoscaler over TorchJobs,
the serving autoscalers — is the same machine: observe a signal window,
decide under cooldown/hysteresis/staleness/flap-damping discipline,
commit the change through an optimistic-concurrency write, and burn
tempo state ONLY after the write lands. This module is the one copy of
that machine:

* **``LoopKernel``** — the template. Subclasses implement ``observe``
  (None = nothing to decide on yet: world assembling, not registered),
  ``decide`` (a decision object with ``action``/``current``/``target``/
  ``reason``/``seq`` — any path that declines must
  ``return self.skip(reason)``, never a bare None), and ``commit``
  (execute; return a `obs/ledger` commit-outcome string — ``landed``,
  ``conflict:<Type>``, ``fallback:<why>``). ``run_tick`` is the ONLY
  driver: it advances the open effect horizon, records the decision
  (subclass ``record`` hook — the loop's decision log, byte-compatible
  with the pre-kernel formats), commits actionable decisions, and
  appends exactly one ledger ``DecisionRecord`` carrying the whole
  tick. No decide/commit path in a kernel subclass may skip the
  ledger, and nothing may call decide/commit around ``run_tick``.
* **``CooldownGate``** — the tempo state every loop shares: separate
  up/down cooldowns, flap damping on direction reversals, and the
  commit-only-after-patch rule (a failed patch burns no cooldown).
  Extracted from `autoscale/policy.Recommender`, which now rides it.
* **The one decision-line serializer** — ``format_decision_line`` /
  ``format_commit_failure_line`` / ``parse_decision_line``. The three
  formats that had drifted apart (the FleetAutoscaler's service lines,
  its pool lines, and its patch-failure lines — plus the
  ElasticAutoscaler's new log) are all renderings of one record shape;
  the parser accepts every historical variant, so old soak logs still
  parse.

Stdlib-only (plus `obs/ledger`): importable without the client stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

from tpu_on_k8s_torch.obs import ledger as ledger_mod
from tpu_on_k8s_torch.obs.ledger import COMMIT_NONE, committed

#: the hold action shared by every loop's decision vocabulary
#: (mirrors `autoscale/policy.ACTION_HOLD` — one string, two importers)
ACTION_HOLD = "hold"
ACTION_SKIP = "skip"


# --------------------------------------------------------------- tempo state
class CooldownGate:
    """Cooldown + flap-damping stamps with commit-only-after-patch
    semantics — the tempo half of every decision loop, in one place.

    ``commit(action, now)`` is called ONLY after the executing write
    lands (the kernel's commit hook / `Recommender.commit`), so a
    failed patch burns no cooldown and the loop retries at full speed
    next tick instead of sulking through a window it never used."""

    def __init__(self, up_cooldown_s: float = 0.0,
                 down_cooldown_s: float = 0.0,
                 flap_guard_s: float = 0.0) -> None:
        self.up_cooldown_s = up_cooldown_s
        self.down_cooldown_s = down_cooldown_s
        self.flap_guard_s = flap_guard_s
        self.last_up_t: Optional[float] = None
        self.last_down_t: Optional[float] = None

    def up_in_cooldown(self, now: float) -> bool:
        return (self.last_up_t is not None
                and now - self.last_up_t < self.up_cooldown_s)

    def down_in_cooldown(self, now: float) -> bool:
        return (self.last_down_t is not None
                and now - self.last_down_t < self.down_cooldown_s)

    def flap_blocked(self, action: str, now: float) -> bool:
        """A direction reversal needs ``flap_guard_s`` since the
        opposite move executed."""
        if action == "up":
            return (self.last_down_t is not None
                    and now - self.last_down_t < self.flap_guard_s)
        if action == "down":
            return (self.last_up_t is not None
                    and now - self.last_up_t < self.flap_guard_s)
        return False

    def commit(self, action: str, now: float) -> None:
        if action == "up":
            self.last_up_t = now
        elif action == "down":
            self.last_down_t = now


# ------------------------------------------------------- decision-line serde
@dataclasses.dataclass(frozen=True)
class DecisionLine:
    """One parsed decision-log line. ``scope`` is the ordered prefix
    (``(("svc", key),)``, ``(("svc", key), ("pool", p))``,
    ``(("job", key),)``, or empty for a bare `policy.Decision.line()`);
    ``failure`` is the exception type name of a ``patch_failed`` line
    (empty for decision lines)."""

    seq: int
    action: str = ""
    current: int = 0
    target: int = 0
    reason: str = ""
    scope: Tuple[Tuple[str, str], ...] = ()
    failure: str = ""

    def line(self) -> str:
        if self.failure:
            return format_commit_failure_line(self.seq, self.failure,
                                              scope=self.scope)
        return format_decision_line(self.seq, self.action, self.current,
                                    self.target, self.reason,
                                    scope=self.scope)


def _scope_prefix(scope: Iterable[Tuple[str, str]]) -> str:
    return "".join(f"{k}={v} " for k, v in scope)


def format_decision_line(seq: int, action: str, current: int, target: int,
                         reason: str, *,
                         scope: Iterable[Tuple[str, str]] = ()) -> str:
    """The ONE decision-line renderer. Byte-compatible with every
    pre-kernel format: the FleetAutoscaler's
    ``svc=<key> seq=N action=a replicas=c->t reason=...``, its pool
    variant (``pool=<p>`` after ``svc=``), and the bare
    `autoscale/policy.Decision.line()` form (empty scope)."""
    return (f"{_scope_prefix(scope)}seq={seq} action={action} "
            f"replicas={current}->{target} reason={reason}")


def format_commit_failure_line(seq: int, failure: str, *,
                               scope: Iterable[Tuple[str, str]] = ()) -> str:
    """The commit-failure line (``patch_failed <ExcType>``) — appended
    after the decision line when the executing write did not land."""
    return f"{_scope_prefix(scope)}seq={seq} patch_failed {failure}"


#: scope keys a decision line may carry, in their canonical order
_SCOPE_KEYS = ("svc", "job", "pool", "lane")


def parse_decision_line(line: str) -> Optional[DecisionLine]:
    """Parse any decision-log line (all historical formats) back into a
    ``DecisionLine``; None if the line is not one. ``reason`` is
    everything after ``reason=`` verbatim (reasons contain spaces), so
    ``parse → format`` round-trips byte-identically."""
    rest = line.strip()
    scope: List[Tuple[str, str]] = []
    seq = None
    while rest:
        head, _, tail = rest.partition(" ")
        key, eq, value = head.partition("=")
        if not eq or not value:
            return None
        if key == "seq":
            try:
                seq = int(value)
            except ValueError:
                return None
            rest = tail
            break
        if key not in _SCOPE_KEYS:
            return None
        scope.append((key, value))
        rest = tail
    if seq is None:
        return None
    tail = rest
    if tail.startswith("patch_failed "):
        failure = tail[len("patch_failed "):]
        if not failure:
            return None
        return DecisionLine(seq=seq, scope=tuple(scope), failure=failure)
    if not tail.startswith("action="):
        return None
    body, sep, reason = tail.partition(" reason=")
    if not sep:
        return None
    fields = dict(part.partition("=")[::2] for part in body.split(" "))
    replicas = fields.get("replicas", "")
    cur_s, sep2, tgt_s = replicas.partition("->")
    if not sep2:
        return None
    try:
        current, target = int(cur_s), int(tgt_s)
    except ValueError:
        return None
    return DecisionLine(seq=seq, action=fields.get("action", ""),
                        current=current, target=target, reason=reason,
                        scope=tuple(scope))


# ------------------------------------------------------------------ horizons
@dataclasses.dataclass
class OpenHorizon:
    """The effect horizon of the loop's last committed decision: the
    ledger seq to close against, what was committed, and which
    intermediate events have already been noted (so ``replicas_ready``
    lands once, not once per tick)."""

    seq: int
    action: str
    target: int
    trigger: str = ""
    noted: set = dataclasses.field(default_factory=set)


# -------------------------------------------------------------------- kernel
class LoopKernel:
    """The observe→decide→commit template (see module doc).

    Subclass hook contract:

    * ``observe(ctx)`` → pack or None (None = no decision exists this
      tick — world assembling, loop frozen; nothing is ledgered).
    * ``decide(pack, ctx)`` → decision or ``self.skip(reason)``. A
      decision duck-types ``seq``/``action``/``current``/``target``/
      ``reason`` (`autoscale/policy.Decision` is the canonical shape).
      Bare ``return None`` is a finding: a declined decision must go
      through ``skip`` so the ledger still sees the tick.
    * ``commit(pack, decision, ctx)`` → a commit-outcome string
      (`obs/ledger.COMMIT_*` vocabulary). Every return must carry the
      outcome; raising is fine (the kernel ledgers ``conflict:<Type>``
      and re-raises).
    * ``record(pack, decision, ctx)`` — the loop's own decision log +
      gauges (byte-compatible with its pre-kernel format).
    * ``signals_of`` / ``exemplars_of`` / ``trigger_of`` /
      ``horizon_events`` — the provenance detail hooks.

    ``run_tick`` is the only entry point; overriding it (or calling
    ``decide``/``commit`` directly) bypasses the ledger and is itself
    a finding."""

    def __init__(self, loop_id: str = "", *, ledger=None) -> None:
        self.loop_id = loop_id
        self.ledger = ledger_mod.ensure(ledger)
        #: loop-local tick counter (one counter across live AND dead
        #: observations — subclasses advance it in ``observe``)
        self.seq = 0
        #: ledger seq of the loop's last landed decision (parent link)
        self.last_committed: Optional[int] = None
        self.open_horizon: Optional[OpenHorizon] = None

    def bind(self, loop_id: str, ledger) -> None:
        """Late-bind identity + ledger (loop states are often minted
        bare by a registry before the owning controller is known)."""
        self.loop_id = loop_id
        self.ledger = ledger_mod.ensure(ledger)

    # ------------------------------------------------------------- template
    def run_tick(self, ctx: Optional[Dict[str, Any]] = None):
        """One loop iteration. Returns the decision (None when observe
        or decide declined)."""
        ctx = {} if ctx is None else ctx
        pack = self.observe(ctx)
        if pack is None:
            return None
        self._advance_horizon(pack, ctx)
        decision = self.decide(pack, ctx)
        if decision is None:
            return None               # decide() ledgered the skip itself
        ctx["decision"] = decision    # provenance hooks may inspect it
        self.record(pack, decision, ctx)
        outcome = COMMIT_NONE
        if self.actionable(decision, ctx):
            try:
                outcome = self.commit(pack, decision, ctx)
            except Exception as e:
                # the write path blew up: ledger the conflict before the
                # caller's error handling sees it — a crashed commit must
                # not be a decision that never happened
                self._ledger_tick(pack, decision,
                                  f"conflict:{type(e).__name__}", ctx)
                raise
        self._ledger_tick(pack, decision, outcome, ctx)
        return decision

    def abandon(self, event: str = ledger_mod.HORIZON_ABANDONED) -> None:
        """Close the loop's open effect horizon because the LOOP is
        being retired (its object deleted, the service deregistered) —
        without this, an unclosable horizon pins the shared ledger's
        ``open_effect_horizons`` gauge for the rest of the process."""
        h = self.open_horizon
        if h is not None:
            self.open_horizon = None
            self.ledger.horizon(h.seq, loop=self.loop_id, event=event,
                                closing=True)

    def skip(self, reason: str, *, tick: Optional[int] = None) -> None:
        """The one legal way for ``decide`` to decline: the tick still
        lands in the ledger (action ``skip``), so "the loop looked and
        chose not to decide" is distinguishable from "the loop never
        ran"."""
        self.ledger.decision(
            loop=self.loop_id, tick=self.seq if tick is None else tick,
            action=ACTION_SKIP, current=0, target=0, reason=reason,
            commit=COMMIT_NONE, parent=self.last_committed)
        return None

    # ------------------------------------------------------- subclass hooks
    def observe(self, ctx: Dict[str, Any]):
        raise NotImplementedError

    def decide(self, pack, ctx: Dict[str, Any]):
        raise NotImplementedError

    def commit(self, pack, decision, ctx: Dict[str, Any]) -> str:
        raise NotImplementedError

    def record(self, pack, decision, ctx: Dict[str, Any]) -> None:
        """The loop's own decision log / gauges; default: nothing."""

    def actionable(self, decision, ctx: Dict[str, Any]) -> bool:
        return (decision.action not in (ACTION_HOLD, ACTION_SKIP)
                and decision.target != decision.current)

    def opens_horizon(self, decision, outcome: str,
                      ctx: Dict[str, Any]) -> bool:
        """Whether a landed commit opens an effect horizon. Default:
        every landed commit does. A loop that KNOWS it will never
        observe the effect (e.g. a rescale that also freezes the loop —
        no future tick exists to close the horizon) must return False:
        an unclosable horizon pins the open_effect_horizons gauge and
        turns normal convergence into a standing alert."""
        return committed(outcome)

    def tick_of(self, pack) -> int:
        return self.seq

    def signals_of(self, pack) -> Tuple[Tuple[str, str], ...]:
        return ()

    def exemplars_of(self, pack) -> Tuple[int, ...]:
        return ()

    def trigger_of(self, pack, ctx: Dict[str, Any]) -> str:
        return ""

    def horizon_events(self, horizon: OpenHorizon, pack,
                       ctx: Dict[str, Any]) -> Iterable[Tuple[str, bool]]:
        """New effect-horizon events observed this tick, as
        ``(event, closing)`` pairs. The kernel de-duplicates against
        ``horizon.noted`` and stops at the first closing event."""
        return ()

    def on_committed(self, rec, decision, outcome: str,
                     ctx: Dict[str, Any]) -> None:
        """Called after a landed commit's bookkeeping (``rec`` is the
        real ledger record). Loops that track cross-decision episodes
        (e.g. which decision answered an SLO page) hook here."""

    # ------------------------------------------------------------- plumbing
    def _advance_horizon(self, pack, ctx: Dict[str, Any]) -> None:
        h = self.open_horizon
        if h is None:
            return
        for event, closing in self.horizon_events(h, pack, ctx):
            if event in h.noted:
                continue
            h.noted.add(event)
            self.ledger.horizon(h.seq, loop=self.loop_id, event=event,
                                closing=closing)
            if closing:
                self.open_horizon = None
                return

    def _ledger_tick(self, pack, decision, outcome: str,
                     ctx: Dict[str, Any]) -> None:
        trigger = self.trigger_of(pack, ctx)
        landed = committed(outcome)
        opens = landed and self.opens_horizon(decision, outcome, ctx)
        rec = self.ledger.decision(
            loop=self.loop_id, tick=self.tick_of(pack),
            action=decision.action, current=decision.current,
            target=decision.target, reason=decision.reason,
            commit=outcome, trigger=trigger, parent=self.last_committed,
            signals=self.signals_of(pack),
            exemplars=self.exemplars_of(pack),
            horizon_open=opens)
        if rec is None or not landed:
            return
        if self.open_horizon is not None:
            # a newer commit took over before the previous effect was
            # observed: close the stale horizon explicitly — an operator
            # reading the chain must see the takeover, and the
            # open_effect_horizons gauge must not leak
            self.ledger.horizon(self.open_horizon.seq, loop=self.loop_id,
                                event=ledger_mod.HORIZON_SUPERSEDED,
                                closing=True)
            self.open_horizon = None
        self.last_committed = rec.seq
        if opens:
            self.open_horizon = OpenHorizon(rec.seq, decision.action,
                                            decision.target,
                                            trigger=trigger)
        self.on_committed(rec, decision, outcome, ctx)
