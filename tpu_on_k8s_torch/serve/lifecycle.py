"""Request lifecycle: states, deadlines, cancellation, and drain.

The engine (`tpu_on_k8s_torch/models/serving.py`) knows three things about a
request: queued, in a slot, finished. A service needs the full lifecycle —

    queued ──► admitted ──► decoding ──► done
      ▲            │            │
      │            └────┬───────┴──► cancelled
      │(replay)         └──────────► deadline_exceeded
      ├───────◄── engine crash (retry budget left)
      │            └──────────────► retry_exhausted (budget spent)
      ├─► rejected
      ├─► cancelled
      └─► deadline_exceeded

An engine crash (``EngineCrashError``) sends surviving in-flight requests
BACK to ``queued`` — the replay edge — with their decode bookkeeping
(first-token time, token count, partial tokens) reset; a request whose
per-request retry budget is already spent terminates as
``retry_exhausted`` instead, so a crashed engine can never silently lose
work (`docs/resilience.md` has the full replay state machine).

Terminal states are sticky; ``rejected`` is only ever assigned at
``submit()`` time (a rejected request never enters the queue). Deadlines
are enforced in two places with different costs: a QUEUED request past its
deadline is expired before it ever occupies a slot (free), and an
ADMITTED/DECODING one is aborted via ``engine.abort`` — its slot is
returned the same step (cheap: host bookkeeping, no device work). This is
the serving analog of the controller's failover semantics
(`controller/failover.py`): preemption arrives as ``stop_accepting()`` +
bounded drain rather than a pod kill.

All clock reads go through an injectable ``clock`` (the gateway passes its
own) so deadline behavior is deterministic under test — the same pattern
`coordinator/plugins.py` uses for quota reservation TTLs.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import numpy as np


class RequestState(str, enum.Enum):
    """Gateway-visible request states (see the module diagram)."""

    QUEUED = "queued"                        # in the gateway's fair queue
    ADMITTED = "admitted"                    # handed to the engine (may be
                                             # mid-chunked-prefill)
    DECODING = "decoding"                    # first token emitted
    # disaggregated-only states (`tpu_on_k8s_torch/serve/disagg.py`): the
    # request lifecycle there is queued → prefilling → handoff →
    # decoding, with the prefill and decode halves on different replicas
    PREFILLING = "prefilling"                # on a prefill-pool replica
    HANDOFF = "handoff"                      # KV in the handoff queue
    DONE = "done"
    CANCELLED = "cancelled"
    DEADLINE_EXCEEDED = "deadline_exceeded"
    REJECTED = "rejected"
    RETRY_EXHAUSTED = "retry_exhausted"       # engine crashed more times
                                              # than the request's replay
                                              # budget allows


#: states a request can still leave
LIVE_STATES = frozenset({RequestState.QUEUED, RequestState.ADMITTED,
                         RequestState.DECODING, RequestState.PREFILLING,
                         RequestState.HANDOFF})
TERMINAL_STATES = frozenset(RequestState) - LIVE_STATES


@dataclasses.dataclass
class GatewayRequest:
    """One request's full gateway-side record. ``tokens`` holds the final
    continuation for DONE and the partial one for a mid-decode cancel or
    deadline abort (clients often want the partial text they paid for)."""

    rid: int
    tenant: str
    priority: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int]
    prefix_id: Optional[int]
    cost: int                         # reserved token budget (prompt + new)
    deadline: Optional[float]         # absolute clock() time, None = never
    submitted_at: float
    on_token: Optional[Callable[[int, int], None]] = None
    state: RequestState = RequestState.QUEUED
    engine_rid: Optional[int] = None
    dispatched_at: Optional[float] = None
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    n_tokens: int = 0
    tokens: Optional[np.ndarray] = None
    cancel_requested: bool = False
    replays: int = 0                  # times re-admitted after engine crash
    not_before: float = 0.0           # replay backoff gate (clock() time)
    # one histogram sample per REQUEST, not per attempt: these survive
    # reset_for_replay so a replayed request cannot double-observe
    # queue-wait/TTFT (counts must stay comparable to requests_submitted)
    queue_wait_observed: bool = False
    ttft_observed: bool = False
    # tracing (`tpu_on_k8s_torch/obs/trace.py`): ``span`` is the request's root
    # span — minted by this gateway, or passed in by the fleet that routed
    # here (``span_owned`` False: the fleet finishes it); ``phase_span``
    # is the currently open lifecycle child (queue / decode attempt).
    # None when tracing is off — every consumer guards.
    span: Any = None
    span_owned: bool = True
    phase_span: Any = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline

    def reset_for_replay(self, now: float, backoff_s: float) -> None:
        """Send the request back to QUEUED after an engine crash: the
        engine-side identity and all decode bookkeeping are void (the
        crashed engine's partial KV and tokens are gone; decode restarts
        from scratch, so streaming consumers may see tokens re-emitted —
        at-least-once delivery). The deadline and submit time are NOT
        reset: the client's clock kept running through the crash."""
        self.replays += 1
        self.state = RequestState.QUEUED
        self.engine_rid = None
        self.dispatched_at = None
        self.first_token_at = None
        self.last_token_at = None
        self.n_tokens = 0
        self.not_before = now + backoff_s


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """What ``gateway.result()`` hands back: the terminal state plus
    whatever tokens were produced (complete for DONE, partial for
    CANCELLED / DEADLINE_EXCEEDED after decode started, empty otherwise)."""

    rid: int
    state: RequestState
    tokens: np.ndarray

    @property
    def ok(self) -> bool:
        return self.state is RequestState.DONE


def finalize(req: GatewayRequest, state: RequestState,
             tokens: Optional[Any] = None) -> GatewayRequest:
    """Move ``req`` to a terminal state exactly once (idempotent: a second
    transition is ignored so e.g. a cancel racing a deadline keeps the
    first verdict)."""
    if req.state in TERMINAL_STATES:
        return req
    req.state = state
    if tokens is not None:
        req.tokens = np.asarray(tokens, np.int32)
    elif req.tokens is None:
        req.tokens = np.zeros(0, np.int32)
    return req
