"""ServingGateway: the single front door to the continuous-batching engine.

Wraps a ``ContinuousBatchingEngine`` without re-implementing it — the
engine keeps doing the one thing it does (one compiled step program over a
slot pool); the gateway owns everything a *service* needs around it:

* **Bounded admission** (`serve/admission.py`): queue bound, load
  shedding, per-tenant token budgets — overload becomes a typed
  ``Rejected``, not an unbounded queue.
* **Fair ordering** (`serve/scheduler.py`): priority lanes, smooth-WRR
  across tenants. The gateway dispatches into the engine only as slots
  free up, so the engine's own FIFO never holds more than the in-flight
  set and the gateway's policy — not arrival order — decides who runs.
* **Lifecycle** (`serve/lifecycle.py`): per-request deadlines (expired
  while queued: reaped before ever occupying a slot; expired mid-decode:
  slot aborted and reusable the same step), client-driven ``cancel()``,
  graceful drain for preemption (``stop_accepting()`` + finish in-flight,
  the serving analog of `controller/failover.py` recovery semantics).
* **Observability**: queue-depth / reject / cancel / deadline counters and
  TTFT / TPOT / queue-wait histograms through ``ServingMetrics`` (TTFT /
  TPOT observations carry trace-id exemplars when tracing is on), plus
  streaming via the engine's existing ``on_token`` hook — and, with a
  ``tracer`` (`tpu_on_k8s_torch/obs/trace.py`), a per-request span tree:
  ``request`` root (or the fleet's, passed via ``trace_parent``) with
  sequential ``queue`` → ``decode`` phase children, a ``first_token``
  event anchoring the TTFT critical path, ``engine_crash`` events on
  replayed attempts, and a flight-recorder dump on every crash. Tracing
  off (the default) is bit-for-bit behavior-neutral.
* **Crash recovery / request replay** (``ReplayPolicy``): when the engine
  dies mid-decode (``EngineCrashError`` out of ``engine.step()``) the
  gateway resets the engine and re-admits every surviving in-flight
  request through the fair queue — per-request retry budget, exponential
  backoff before re-dispatch — finalizing budget-exhausted requests as
  ``RETRY_EXHAUSTED``. A crash therefore never silently loses work:
  every accepted request still reaches exactly one terminal state
  (done / replayed-then-done / retry_exhausted / cancelled / deadline).
  Queued requests never touched the engine and simply keep their place.

Threading model mirrors the engine's: ONE driver thread calls ``step()`` /
``run()`` / ``drain()``; any number of frontend threads call ``submit()``,
``cancel()``, ``result()``, ``state()``. Cancels from frontend threads only
mark the request — the driver performs the actual ``engine.abort`` at the
top of its next step (``abort`` is not safe concurrent with a running
device step).

Give the *gateway* the ``ServingMetrics`` instance and leave the engine's
``metrics=None``: the gateway measures queue-wait/TTFT from gateway
submit time (the number a client sees); the engine would measure from its
own submit, which under the gateway is dispatch time.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional, Union

from tpu_on_k8s_torch.metrics import count_detached_callback
from tpu_on_k8s_torch.models.serving import (
    EngineCrashError,
    EngineOverloadedError,
)
from tpu_on_k8s_torch.obs.trace import STATUS_ERROR, ensure as ensure_tracer
from tpu_on_k8s_torch.serve.admission import (
    REASON_DEADLINE,
    REASON_DRAINING,
    AdmissionConfig,
    AdmissionController,
    Rejected,
)
from tpu_on_k8s_torch.serve.lifecycle import (
    LIVE_STATES,
    GatewayRequest,
    RequestResult,
    RequestState,
    finalize,
)
from tpu_on_k8s_torch.serve.scheduler import FairScheduler


@dataclasses.dataclass(frozen=True)
class ReplayPolicy:
    """How in-flight requests survive an engine crash. ``max_replays`` is
    PER REQUEST across the gateway's lifetime (a request that keeps landing
    on a crashing engine eventually stops consuming capacity);
    ``backoff_base_s`` doubles per replay of that request up to
    ``backoff_cap_s`` — a crashed-and-reset engine usually needs a beat
    before it is trustworthy, and an immediate full-pressure re-dispatch
    of every survivor is exactly the load spike that re-kills it."""

    max_replays: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0

    def __post_init__(self) -> None:
        if self.max_replays < 0:
            raise ValueError(f"max_replays must be >= 0, got "
                             f"{self.max_replays}")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("replay backoff must be >= 0")

    def backoff_for(self, replays: int) -> float:
        """Backoff before the ``replays``-th re-admission (1-based)."""
        return min(self.backoff_cap_s,
                   self.backoff_base_s * (2 ** max(replays - 1, 0)))


class ServingGateway:
    """Admission + fairness + lifecycle over one engine. See module doc."""

    def __init__(self, engine, admission: Optional[AdmissionConfig] = None,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 replay: Optional[ReplayPolicy] = None,
                 tracer=None) -> None:
        if getattr(engine, "_on_retire", None) is not None:
            raise ValueError("engine already has an on_retire consumer — "
                             "one gateway per engine")
        self.engine = engine
        self.metrics = metrics
        self._clock = clock
        # span producer (`tpu_on_k8s_torch/obs/trace.py`): None → the NOOP
        # tracer — no clock reads, no allocation, bit-for-bit neutral
        self._tracer = ensure_tracer(tracer)
        self._admission = AdmissionController(admission)
        self._sched = FairScheduler(tenant_weights)
        self._lock = threading.Lock()
        self._requests: Dict[int, GatewayRequest] = {}
        self._by_engine: Dict[int, int] = {}       # engine rid → gateway rid
        self._next_id = 0
        self._in_engine = 0      # dispatched, not yet retired/aborted: each
                                 # holds (or will hold) exactly one slot
        self._accepting = True
        self._newly_terminal: List[int] = []
        self._replay = replay or ReplayPolicy()
        # crash survivors waiting out their backoff before re-entering the
        # fair queue, in original-admission (rid) order
        self._replay_pending: List[GatewayRequest] = []
        engine._on_retire = self._on_engine_retire
        if (self._tracer.enabled
                and getattr(engine, "_draft", None) is not None
                and getattr(engine, "_on_spec_round", None) is None):
            # speculative engine under a live tracer: turn each spec
            # round into `spec.draft`/`spec.verify` events on the live
            # requests' decode spans, so `tools/trace_report.py` can
            # attribute draft overhead per request. Tracing off installs
            # nothing — spec serving stays bit-for-bit on its
            # pre-tracing behavior (the determinism contract).
            engine._on_spec_round = self._note_spec_round

    # ---- frontend API ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int, *, tenant: str = "default",
               priority: int = 0, deadline_s: Optional[float] = None,
               eos_id: Optional[int] = None, prefix_id: Optional[int] = None,
               on_token=None, trace_parent=None) -> Union[int, Rejected]:
        """Admit a request: returns its id, or a ``Rejected`` (check with
        ``isinstance``) when the bounded queue / load shedding / tenant
        quota / drain refuses it. ``deadline_s`` is relative seconds: past
        it the request is expired wherever it is. Malformed requests
        (empty prompt, impossible lengths) raise ``ValueError`` — caller
        bugs, not load conditions. ``trace_parent`` joins this request to
        an existing trace (the fleet passes its root span in and keeps
        ownership of it; standalone submits root their own)."""
        # the engine owns its request invariants (empty prompt, length vs
        # max_len, prefix existence) — validate through it so a request
        # that would fail at dispatch never reserves budget
        prompt = self.engine.check_request(prompt, max_new_tokens, prefix_id)
        cost = int(prompt.size) + max_new_tokens
        with self._lock:
            now = self._clock()
            if not self._accepting:
                return self._reject(Rejected(
                    REASON_DRAINING, "gateway is draining"))
            if deadline_s is not None and deadline_s <= 0:
                return self._reject(Rejected(
                    REASON_DEADLINE, f"deadline_s {deadline_s} already "
                    f"expired at submit"))
            rej = self._admission.admit(tenant, cost, priority,
                                        queue_depth=len(self._sched))
            if rej is not None:
                return self._reject(rej)
            rid = self._next_id
            self._next_id += 1
            req = GatewayRequest(
                rid=rid, tenant=tenant, priority=priority, prompt=prompt,
                max_new_tokens=max_new_tokens, eos_id=eos_id,
                prefix_id=prefix_id, cost=cost,
                deadline=(now + deadline_s if deadline_s is not None
                          else None),
                submitted_at=now, on_token=on_token)
            if trace_parent is not None:
                req.span, req.span_owned = trace_parent, False
            else:
                req.span = self._tracer.start(
                    "request", rid=rid, tenant=tenant, priority=priority,
                    prompt_tokens=int(prompt.size),
                    max_new_tokens=max_new_tokens)
            req.phase_span = self._tracer.start("queue", parent=req.span,
                                                attempt=0)
            self._requests[rid] = req
            self._sched.push(req)
            depth = len(self._sched)
        if self.metrics is not None:
            self.metrics.inc("requests_submitted")
            self.metrics.set_gauge("queue_depth", depth)
        return rid

    def cancel(self, request_id: int) -> bool:
        """Client-driven cancellation. A QUEUED request is retired here and
        now; an in-engine one is marked and its slot is aborted (freed for
        the next admission) at the top of the driver's next ``step()``.
        False when the id is unknown or already terminal."""
        with self._lock:
            req = self._requests.get(request_id)
            if req is None or req.state not in LIVE_STATES:
                return False
            if req.state is RequestState.QUEUED:
                # a QUEUED request lives either in the fair queue or — as a
                # crash survivor waiting out its backoff — in the replay list
                if not self._sched.remove(req):
                    try:
                        self._replay_pending.remove(req)
                    except ValueError:
                        pass
                self._finalize_locked(req, RequestState.CANCELLED)
            else:
                req.cancel_requested = True
        return True

    def evict_queued(self, max_n: Optional[int] = None,
                     skip: Optional[Callable[[GatewayRequest], bool]] = None
                     ) -> List[int]:
        """Remove up to ``max_n`` QUEUED requests from the BACK of the
        fair queue and return their ids — WITHOUT finalizing them. The
        fleet's scale-up rebalance: work that queued here before new
        capacity existed moves back to the fleet and re-routes onto an
        idle replica. Budget is released (the request leaves this
        gateway entirely); the oldest queued work keeps its place here,
        where it is closest to dispatch. Requests already dispatched,
        cancelled, waiting out a crash-replay backoff, or matched by
        ``skip`` (the fleet skips prefix-warm requests — moving those
        would trade a cache hit for a cold prefill) never move."""
        with self._lock:
            evicted: List[int] = []
            # farthest-from-dispatch first: lowest priority lane, and
            # the newest arrival within it (queued() itself implies no
            # dispatch order, so order explicitly — evicting the
            # next-to-dispatch high-priority request would invert the
            # fairness the scheduler exists to provide)
            for req in sorted(self._sched.queued(),
                              key=lambda r: (r.priority, -r.rid)):
                if max_n is not None and len(evicted) >= max_n:
                    break
                if req.state is not RequestState.QUEUED \
                        or req.cancel_requested \
                        or (skip is not None and skip(req)):
                    continue
                self._sched.remove(req)
                self._admission.release(req.tenant, req.cost)
                del self._requests[req.rid]
                if req.phase_span is not None:
                    # the request leaves this gateway; the fleet's
                    # re-dispatch opens a fresh queue span on the same
                    # trace, so the two segments sum to the true wait
                    req.phase_span.finish("rebalanced")
                    req.phase_span = None
                evicted.append(req.rid)
            return evicted

    def result(self, request_id: int) -> Optional[RequestResult]:
        """The terminal outcome (popped — one consumer per request, like
        ``engine.result``), or None while the request is live. Partial
        tokens ride along for mid-decode cancels/expiries."""
        with self._lock:
            req = self._requests.get(request_id)
            if req is None or req.state in LIVE_STATES:
                return None
            del self._requests[request_id]
            return RequestResult(request_id, req.state, req.tokens)

    def state(self, request_id: int) -> Optional[RequestState]:
        with self._lock:
            req = self._requests.get(request_id)
            return None if req is None else req.state

    # ---- lifecycle internals ----------------------------------------------
    def _reject(self, rej: Rejected) -> Rejected:
        if self.metrics is not None:
            self.metrics.inc("requests_rejected")
            self.metrics.inc(f"rejected_{rej.reason}")
        return rej

    def _finalize_locked(self, req: GatewayRequest, state: RequestState,
                         tokens=None) -> None:
        """Terminal transition + budget release + counters. Lock held."""
        finalize(req, state, tokens)
        self._admission.release(req.tenant, req.cost)
        self._newly_terminal.append(req.rid)
        if req.phase_span is not None:
            req.phase_span.finish(state.value)
            req.phase_span = None
        if req.span is not None and req.span_owned:
            req.span.finish(state.value)
        if self.metrics is None:
            return
        now = self._clock()
        if state is RequestState.DONE:
            self.metrics.inc("requests_finished")
            self.metrics.observe("request_latency_seconds",
                                 now - req.submitted_at)
            if req.n_tokens >= 2 and req.first_token_at is not None:
                self.metrics.observe(
                    "time_per_output_token_seconds",
                    (req.last_token_at - req.first_token_at)
                    / (req.n_tokens - 1),
                    exemplar=(req.span.trace_id or None)
                    if req.span is not None else None)
        elif state is RequestState.CANCELLED:
            self.metrics.inc("requests_cancelled")
        elif state is RequestState.DEADLINE_EXCEEDED:
            self.metrics.inc("deadline_exceeded")
        elif state is RequestState.RETRY_EXHAUSTED:
            self.metrics.inc("retry_exhausted")

    def _on_engine_retire(self, engine_rid: int, tokens) -> None:
        """Engine hook: a dispatched request finished (fires during
        ``engine.step()``, outside the engine lock)."""
        with self._lock:
            rid = self._by_engine.pop(engine_rid, None)
            if rid is None:
                return               # direct-to-engine traffic, not ours —
                                     # leave its result for its consumer
            # claim from the engine so its finished dict stays flat (lock
            # order gateway→engine, same as dispatch/reap)
            self.engine.result(engine_rid)
            self._in_engine -= 1
            self._finalize_locked(self._requests[rid], RequestState.DONE,
                                  tokens)

    def _note_spec_round(self, engine_rids, draft_s: float, verify_s: float,
                         proposed: int, accepted: int) -> None:
        """Engine hook (fires once per speculative round, outside the
        engine lock): mark the round on every live request's decode span.
        ``dt`` rides the engine's own injectable clock — virtual-clock
        runs stay byte-identical (dt=0), hardware runs carry real device
        seconds for the report's draft-overhead attribution."""
        with self._lock:
            for erid in engine_rids:
                rid = self._by_engine.get(erid)
                if rid is None:
                    continue          # retired this very round
                req = self._requests.get(rid)
                if req is None or req.phase_span is None:
                    continue
                req.phase_span.event("spec.draft", dt=draft_s)
                req.phase_span.event("spec.verify", dt=verify_s,
                                     proposed=proposed, accepted=accepted)

    def _wrap_on_token(self, req: GatewayRequest):
        def hook(engine_rid: int, token: int) -> None:
            with self._lock:
                now = self._clock()
                first = req.first_token_at is None
                if first:
                    req.first_token_at = now
                    if req.state is RequestState.ADMITTED:
                        req.state = RequestState.DECODING
                req.last_token_at = now
                req.n_tokens += 1
                # TTFT is observed once per REQUEST: a replay attempt's
                # "first" token is a re-emission, not the client's first —
                # unless the crash beat the original first token, in which
                # case the replay's really is it (the flag, not the replay
                # count, captures that distinction)
                observe_ttft = first and not req.ttft_observed
                if observe_ttft:
                    req.ttft_observed = True
                    if req.span is not None:
                        # the anchor `tools/trace_report.py` decomposes
                        # the TTFT critical path against
                        req.span.event("first_token")
            if self.metrics is not None:
                self.metrics.inc("tokens_emitted")
                if observe_ttft:
                    self.metrics.observe(
                        "time_to_first_token_seconds",
                        now - req.submitted_at,
                        exemplar=(req.span.trace_id or None)
                        if req.span is not None else None)
            if req.on_token is not None:
                # isolate the user's callback ourselves: if the engine saw
                # it raise it would detach this whole hook, and the
                # gateway's TTFT/TPOT bookkeeping would go dark with it
                try:
                    req.on_token(req.rid, token)
                except Exception as e:  # noqa: BLE001
                    req.on_token = None
                    count_detached_callback(
                        self.metrics,
                        f"on_token callback for request {req.rid} raised "
                        f"{type(e).__name__}: {e}; streaming detached")
        return hook

    def _release_replays_locked(self, now: float) -> None:
        """Crash survivors whose backoff has elapsed re-enter the fair
        queue at the HEAD of their tenant's FIFO (they are that tenant's
        oldest work — tail insertion would let later arrivals leapfrog a
        request the crash already delayed once). Lock held."""
        if not self._replay_pending:
            return
        ready = [r for r in self._replay_pending
                 if r.state is RequestState.QUEUED and now >= r.not_before]
        if not ready:
            return
        for req in reversed(ready):   # reversed: push_front keeps rid order
            self._sched.push_front(req)
        self._replay_pending = [r for r in self._replay_pending
                                if r not in ready]

    def _reap_locked(self, now: float) -> None:
        """Expire/cancel queued, replay-pending, and in-engine requests.
        Lock held. Engine aborts are safe here: the driver thread is the
        only caller and the device step has not been launched yet this
        iteration."""
        for req in list(self._replay_pending):
            if req.cancel_requested or req.expired(now):
                self._replay_pending.remove(req)
                self._finalize_locked(
                    req, RequestState.CANCELLED if req.cancel_requested
                    else RequestState.DEADLINE_EXCEEDED)
        for req in list(self._sched.queued()):
            if req.cancel_requested or req.expired(now):
                self._sched.remove(req)
                self._finalize_locked(
                    req, RequestState.CANCELLED if req.cancel_requested
                    else RequestState.DEADLINE_EXCEEDED)
        for rid in list(self._by_engine.values()):
            req = self._requests[rid]
            if req.state not in LIVE_STATES:
                continue
            if req.cancel_requested or req.expired(now):
                partial = self.engine.abort(req.engine_rid)
                if partial is None:
                    continue      # mid-admission this instant; next step
                self._by_engine.pop(req.engine_rid, None)
                self._in_engine -= 1
                self._finalize_locked(
                    req, RequestState.CANCELLED if req.cancel_requested
                    else RequestState.DEADLINE_EXCEEDED, partial)

    def _dispatch_locked(self, now: float) -> None:
        """Feed the engine up to its slot count — never more, so the fair
        queue (not the engine FIFO) stays the ordering authority."""
        while self._in_engine < self.engine.n_slots:
            req = self._sched.pop()
            if req is None:
                break
            try:
                req.engine_rid = self.engine.submit(
                    req.prompt, req.max_new_tokens, eos_id=req.eos_id,
                    prefix_id=req.prefix_id,
                    on_token=self._wrap_on_token(req))
            except EngineOverloadedError:
                # a capped engine shared with direct submitters can fill
                # outside our accounting: un-pop (head, not tail — the
                # request keeps its FIFO place) and retry next step
                self._sched.push_front(req)
                break
            req.state = RequestState.ADMITTED
            req.dispatched_at = now
            if req.phase_span is not None:
                # queue phase ends; the decode attempt (chunked prefill
                # included — the engine admits and prefills in-slot)
                # begins
                req.phase_span.finish()
                req.phase_span = self._tracer.start(
                    "decode", parent=req.span, attempt=req.replays,
                    engine_rid=req.engine_rid)
            self._by_engine[req.engine_rid] = req.rid
            self._in_engine += 1
            if self.metrics is not None and not req.queue_wait_observed:
                # once per request: a replay's second trip through the
                # queue must not add a second sample for the same rid
                req.queue_wait_observed = True
                self.metrics.observe("queue_wait_seconds",
                                     now - req.submitted_at)

    def _recover_engine_crash(self) -> None:
        """The engine died mid-decode: reset it (compiled programs and the
        cache pool survive; host request state does not) and route every
        in-flight request through the replay state machine — back to the
        fair queue with backoff while its retry budget lasts, terminal
        ``RETRY_EXHAUSTED`` after. Queued requests never reached the
        engine and are untouched."""
        dropped = self.engine.reset()
        with self._lock:
            orphans = [rid for rid in dropped if rid not in self._by_engine]
        if orphans:
            # the gateway can only replay what it owns: direct-to-engine
            # traffic (discouraged on a gateway-owned engine, but possible
            # under a shared queue_cap) dies with the crash — say so loudly
            # instead of letting its consumers poll result() forever
            warnings.warn(
                f"engine crash dropped {len(orphans)} non-gateway "
                f"request(s) {orphans}; direct engine.submit traffic "
                f"cannot be replayed", stacklevel=2)
        with self._lock:
            now = self._clock()
            victims = sorted((self._requests[rid]
                              for rid in self._by_engine.values()),
                             key=lambda r: r.rid)
            self._by_engine.clear()
            self._in_engine = 0
            replayed = 0
            for req in victims:
                if req.state not in LIVE_STATES:
                    continue
                if req.span is not None:
                    req.span.event("engine_crash", replays=req.replays)
                if req.replays >= self._replay.max_replays:
                    # the crash ate this attempt's partial tokens with the
                    # engine; an empty terminal result that SAYS so beats a
                    # silent loss
                    self._finalize_locked(req, RequestState.RETRY_EXHAUSTED)
                    continue
                if req.phase_span is not None:
                    req.phase_span.finish(STATUS_ERROR)
                req.reset_for_replay(
                    now, self._replay.backoff_for(req.replays + 1))
                req.phase_span = self._tracer.start(
                    "queue", parent=req.span, attempt=req.replays)
                self._replay_pending.append(req)
                replayed += 1
        # flight recorder: persist the ring of recent spans — the context
        # an operator needs for "what was the engine doing when it died"
        # (covers the RETRY_EXHAUSTED finalizations above too)
        self._tracer.crash_dump("engine_crash")
        if self.metrics is not None:
            self.metrics.inc("engine_crashes")
            if replayed:
                self.metrics.inc("requests_replayed", replayed)

    # ---- the driver loop ---------------------------------------------------
    def step(self) -> List[int]:
        """One gateway iteration: release crash survivors whose backoff
        elapsed, reap cancels/deadlines (freeing their slots), dispatch
        from the fair queue into the freed capacity, then advance the
        engine one step — recovering via request replay if the engine
        crashes under it. Returns ids that reached a terminal state —
        notifications, like ``engine.step``; the payload goes to whoever
        calls ``result(rid)``."""
        with self._lock:
            now = self._clock()
            self._release_replays_locked(now)
            self._reap_locked(now)
            self._dispatch_locked(now)
        if self._in_engine:
            try:
                self.engine.step()
            except EngineCrashError:
                self._recover_engine_crash()
        with self._lock:
            out, self._newly_terminal = self._newly_terminal, []
            depth = len(self._sched)
        if self.metrics is not None:
            self.metrics.set_gauge("queue_depth", depth)
            self.metrics.set_gauge(
                "slots_active",
                self.engine.n_slots - self.engine.free_slots)
        return out

    def _idle_wait(self) -> None:
        """Between steps of ``run``/``drain``: if the ONLY live work is
        crash survivors waiting out replay backoff, sleep toward the
        earliest ``not_before`` instead of hot-spinning the lock. Capped
        small so an injected test clock (which wall sleep cannot advance)
        costs bounded real time per loop turn."""
        with self._lock:
            if (self._in_engine or len(self._sched)
                    or not self._replay_pending):
                return
            gates = [r.not_before for r in self._replay_pending
                     if r.state is RequestState.QUEUED]
            if not gates:
                return
            delay = min(gates) - self._clock()
        if delay > 0:
            time.sleep(min(delay, 0.05))

    def run(self) -> Dict[int, RequestResult]:
        """Step until every accepted request is terminal; claim and return
        all unclaimed results (convenience for batch-style callers and
        tests — a live server just loops ``step()``)."""
        while self._live():
            self.step()
            self._idle_wait()
        return self._claim_all()

    def stop_accepting(self) -> None:
        """New ``submit()`` calls return ``Rejected("draining")`` from now
        on; everything already accepted keeps running."""
        with self._lock:
            self._accepting = False

    def resume_accepting(self) -> None:
        """Reopen the front door — the fleet reclaiming a scale-down
        victim on a scale-up reversal (a warm, already-loaded engine
        beats minutes of fresh-replica spin-up). Only meaningful before
        the replica is retired; a drained-and-removed gateway is gone."""
        with self._lock:
            self._accepting = True

    def drain(self, timeout_s: Optional[float] = None
              ) -> Dict[int, RequestResult]:
        """Graceful shutdown: stop accepting, finish in-flight work, and
        past ``timeout_s`` cancel whatever remains (the CRR/preemption
        shape: SIGTERM grace period, then the pod dies anyway — better to
        cancel cleanly and free the budget than be killed mid-step)."""
        self.stop_accepting()
        deadline = (self._clock() + timeout_s if timeout_s is not None
                    else None)
        while self._live():
            if deadline is not None and self._clock() >= deadline:
                with self._lock:
                    for req in self._requests.values():
                        if req.state in LIVE_STATES:
                            req.cancel_requested = True
                deadline = None      # one sweep marks everything live
            self.step()
            # harmless after the cancel sweep: the next step's reap empties
            # the replay list, so the gate list is empty and this no-ops
            self._idle_wait()
        return self._claim_all()

    def _live(self) -> bool:
        with self._lock:
            return any(r.state in LIVE_STATES
                       for r in self._requests.values())

    def _claim_all(self) -> Dict[int, RequestResult]:
        with self._lock:
            done = [rid for rid, r in self._requests.items()
                    if r.state not in LIVE_STATES]
            out = {}
            for rid in done:
                req = self._requests.pop(rid)
                out[rid] = RequestResult(rid, req.state, req.tokens)
            return out

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._sched)

    @property
    def has_live_requests(self) -> bool:
        """Public drain/removal gate: True while any accepted request has
        not reached a terminal state (what a fleet checks before removing
        a drained replica)."""
        return self._live()
