"""Model pool: one replica gang hosting several ModelVersion serving trees.

The fleet historically served ONE model per InferenceService, so a
long-tail tenant with 50 small fine-tunes paid 50 warm replica floors.
This module is the density half of that bargain: a ``ModelPool`` wraps
one ``ContinuousBatchingEngine`` and multiplexes several same-config
models over it, hot-swapping the ACTIVE params as a params-tree replace
(`models/serving.ContinuousBatchingEngine.replace_params` — the serving
tree rides the ctor's exact preparation path: optional int8 conversion,
same config shape ENFORCED, nothing rebuilt) instead of paying a process
restart per model.

Three design points carry the whole subsystem:

* **Residency vs activity.** Up to ``max_resident`` models stay
  RESIDENT: their prepared params trees are retained (on the engine's
  device, as ``replace_params`` hands them back) and their registered
  prefix KV stays device-resident
  in the engine's paged pool across swaps. Swapping among resident
  models is a pointer replace plus warm prefixes; only a model EVICTED
  from residency (LRU over capacity) pays the surgical paged-KV flush —
  ``drop_prefix`` per prefix id, scoped to the DEPARTING model's
  prefixes only. Every other model's registered prefixes survive the
  swap untouched, with zero recompute (the `tests/test_modelpool.py`
  surgical-flush oracle).
* **A deterministic swap scheduler.** Requests queue per model (FIFO
  lanes). The scheduler stays on the active model until its lane drains
  or the ``swap_batch`` admission quota is spent (batching same-model
  requests is what amortizes the swap-in cost), then swaps to the
  nonempty lane whose HEAD request arrived first — a pure function of
  the submission order, so two runs of the same sequence produce
  byte-identical decision logs.
* **Ledgered swaps.** Every swap lands a ``model_swap`` record on the
  decision ledger (loop ``modelpool/<replica>``) with the measured
  swap-in seconds in its signals; the LRU eviction it forces lands a
  ``model_evict`` record whose PARENT is the swap — so the ledger
  answers "why did model X get evicted from replica Y": because the
  swap to Z (parent record) pushed residency over ``max_resident``.

Chaos: the params replace is a named site (``SITE_MODEL_SWAP``). An
injected ``SwapFailure`` is interpreted ATOMICALLY — the replace is
refused before the engine's pointer moves, so the previous model's
params stay live and keep serving; the failure is counted
(``ModelPoolMetrics.swap_failures``), ledgered with its ``chaos#N``
trigger ref, and the swap retried on the next scheduler pass
(``swap_retries``) — every request queued for the incoming model still
reaches a typed terminal state, zero silent loss.

The measured ``swap_seconds`` histogram is the cold-start signal the
FleetAutoscaler reads beside TTFT (`autoscale/signals.py`): a fleet
thrashing on swaps looks exactly like a fleet short on replicas, and
the recommender treats it that way.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.chaos import SITE_MODEL_SWAP, SwapFailure
from tpu_on_k8s_torch.obs import ledger as ledger_mod
from tpu_on_k8s_torch.obs.ledger import COMMIT_LANDED


class _Lane:
    """One model's FIFO request queue."""

    __slots__ = ("queue",)

    def __init__(self) -> None:
        # (pool rid, arrival seq, prompt, max_new, eos_id, prefix_id,
        #  on_token)
        self.queue: deque = deque()


class _Resident:
    """One resident model: its prepared params tree (None while the
    model is ACTIVE — the engine holds them) and the engine prefix ids
    it owns (the surgical-flush scope)."""

    __slots__ = ("params", "prefixes")

    def __init__(self, params=None) -> None:
        self.params = params
        self.prefixes: List[int] = []


class ModelPool:
    """Multiplex several same-config models over one engine (module doc).

    ``loaders`` maps model name → the serving-tree source: a zero-arg
    callable (a checkpoint read such as ``train/checkpoint.load_params``,
    deferred until first activation) or a ready params tree. ``active`` names the model whose params the
    engine was CONSTRUCTED with. Not thread-safe on its own — one
    driver thread calls ``submit``/``step``/``run``, the same contract
    as the engine it wraps.
    """

    LOOP_PREFIX = "modelpool"

    def __init__(self, engine, loaders: Mapping[str, Any], *,
                 active: str, max_resident: int = 4, swap_batch: int = 64,
                 metrics=None, ledger=None, clock=time.monotonic,
                 replica: str = "replica-0") -> None:
        if active not in loaders:
            raise ValueError(f"active model {active!r} not in loaders")
        if max_resident < 1:
            raise ValueError(f"max_resident must be >= 1, got "
                             f"{max_resident}")
        if swap_batch < 1:
            raise ValueError(f"swap_batch must be >= 1, got {swap_batch}")
        self.engine = engine
        self.loaders: Dict[str, Any] = dict(loaders)
        self.max_resident = max_resident
        self.swap_batch = swap_batch
        #: optional ``metrics.ModelPoolMetrics``
        self.metrics = metrics
        self.ledger = ledger_mod.ensure(ledger)
        self._clock = clock
        self.replica = replica
        self.loop = f"{self.LOOP_PREFIX}/{replica}"
        self._active = active
        #: LRU residency: model → _Resident, oldest first; the active
        #: model is always a member (params=None — the engine holds them)
        self._resident: "OrderedDict[str, _Resident]" = OrderedDict()
        self._resident[active] = _Resident()
        self._lanes: Dict[str, _Lane] = {}
        self._next_rid = 0
        self._next_seq = 0
        self._tick = 0
        self._admitted_since_swap = 0
        #: engine rid → (pool rid, model) for in-flight requests
        self._inflight: Dict[int, Tuple[int, str]] = {}
        self._finished: Dict[int, np.ndarray] = {}
        #: a swap the chaos site refused, to retry on the next pass
        self._retry_model: Optional[str] = None
        self._last_swap_seq: Optional[int] = None
        #: stable one-line-per-decision scheduler log (the deterministic
        #: swap-scheduler oracle byte-compares two runs of it)
        self.decision_log: List[str] = []
        self.stats = {"swaps": 0, "swap_failures": 0, "swap_retries": 0,
                      "evictions": 0, "prefix_flushes": 0}
        if metrics is not None:
            metrics.set_gauge("resident_models", len(self._resident))
            metrics.set_gauge("queued_requests", 0)

    # ------------------------------------------------------------- inspection
    @property
    def active(self) -> str:
        return self._active

    def resident_models(self) -> List[str]:
        """Resident model names, LRU-oldest first."""
        return list(self._resident)

    def queued(self, model: Optional[str] = None) -> int:
        if model is not None:
            lane = self._lanes.get(model)
            return len(lane.queue) if lane else 0
        return sum(len(ln.queue) for ln in self._lanes.values())

    def pending(self) -> int:
        """Everything not yet finished: queued + in-flight."""
        return self.queued() + len(self._inflight)

    # -------------------------------------------------------------- requests
    def submit(self, model: str, prompt, max_new_tokens: int,
               eos_id: Optional[int] = None,
               prefix_id: Optional[int] = None, on_token=None) -> int:
        """Enqueue a request for ``model``; returns its pool request id.
        ``prefix_id`` must be a prefix THIS model registered — a prefix
        KV computed under another model's params would silently decode
        the wrong distribution, so ownership is enforced here."""
        if model not in self.loaders:
            raise ValueError(f"unknown model {model!r}")
        if prefix_id is not None:
            res = self._resident.get(model)
            if res is None or prefix_id not in res.prefixes:
                raise ValueError(
                    f"prefix {prefix_id} does not belong to {model!r} "
                    f"(prefix KV is model-scoped)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{max_new_tokens}")
        rid = self._next_rid
        self._next_rid += 1
        seq = self._next_seq
        self._next_seq += 1
        lane = self._lanes.setdefault(model, _Lane())
        lane.queue.append((rid, seq, prompt, max_new_tokens, eos_id,
                           prefix_id, on_token))
        if self.metrics is not None:
            self.metrics.inc("model_requests", label=model)
            self.metrics.set_gauge("queued_requests", self.queued())
        return rid

    def register_prefix(self, model: str, tokens) -> int:
        """Register a shared prefix for ``model`` (device-resident KV,
        `models/serving.register_prefix`). The engine prefills with its
        LIVE params, so the model must be ACTIVE — activate it first
        (``ensure_active``). The prefix survives swaps for as long as
        the model stays resident; eviction flushes it surgically."""
        if model != self._active:
            raise ValueError(
                f"register_prefix({model!r}) while {self._active!r} is "
                f"active: the engine prefills with the live params — "
                f"activate the model first")
        pid = self.engine.register_prefix(tokens)
        self._resident[model].prefixes.append(pid)
        return pid

    def ensure_active(self, model: str) -> bool:
        """Swap ``model`` in now (draining first is the caller's job —
        the engine refuses a busy swap). True when ``model`` is active
        on return; False when the chaos site refused the swap (previous
        params still live)."""
        if model == self._active:
            return True
        if self._inflight:
            raise RuntimeError(
                f"ensure_active({model!r}) with {len(self._inflight)} "
                f"requests in flight: drain first")
        return self._activate(model)

    def result(self, rid: int) -> Optional[np.ndarray]:
        return self._finished.get(rid)

    # ------------------------------------------------------------ scheduling
    def _oldest_head(self, exclude: Optional[str] = None) -> Optional[str]:
        """The nonempty lane whose head request arrived first — the
        deterministic swap target (pure function of submission order)."""
        best = None
        best_seq = None
        for model, lane in self._lanes.items():
            if model == exclude or not lane.queue:
                continue
            head_seq = lane.queue[0][1]
            if best_seq is None or head_seq < best_seq:
                best, best_seq = model, head_seq
        return best

    def _admit_active(self) -> int:
        """Feed the active model's lane into the engine, up to the
        remaining ``swap_batch`` quota."""
        lane = self._lanes.get(self._active)
        admitted = 0
        while (lane and lane.queue
               and self._admitted_since_swap < self.swap_batch):
            rid, _, prompt, max_new, eos_id, prefix_id, on_token = (
                lane.queue.popleft())
            erid = self.engine.submit(prompt, max_new, eos_id=eos_id,
                                      prefix_id=prefix_id,
                                      on_token=on_token)
            self._inflight[erid] = (rid, self._active)
            self._admitted_since_swap += 1
            admitted += 1
        if admitted and self.metrics is not None:
            self.metrics.set_gauge("queued_requests", self.queued())
        return admitted

    def _schedule(self) -> None:
        """One scheduler pass: retry a refused swap, admit the active
        lane, and swap when the active model's turn is over (lane empty
        or quota spent) and the engine has drained."""
        self._tick += 1
        if self._retry_model is not None and not self._inflight:
            model = self._retry_model
            self.stats["swap_retries"] += 1
            if self.metrics is not None:
                self.metrics.inc("swap_retries")
            if not self._activate(model, retry=True):
                return                      # refused again; try next pass
        self._admit_active()
        active_lane = self._lanes.get(self._active)
        active_left = len(active_lane.queue) if active_lane else 0
        quota_spent = self._admitted_since_swap >= self.swap_batch
        if self._inflight:
            return                          # drain before any swap
        if active_left and not quota_spent:
            return
        nxt = self._oldest_head(exclude=None if quota_spent
                                else self._active)
        if nxt is None or nxt == self._active:
            if quota_spent and active_left:
                # the active lane is the only work left: grant it a new
                # turn instead of wedging on a spent quota
                self._admitted_since_swap = 0
                self._log(f"tick={self._tick} stay model={self._active} "
                          f"queued={active_left}")
                self._admit_active()
            return
        if self._activate(nxt):
            self._admit_active()

    def step(self) -> Dict[int, np.ndarray]:
        """One scheduler pass + one engine step; returns the pool
        requests that finished on this step ({pool rid: tokens})."""
        self._schedule()
        out: Dict[int, np.ndarray] = {}
        if not self._inflight:
            return out
        for erid in self.engine.step():
            rid, model = self._inflight.pop(erid)
            tokens = self.engine.result(erid)
            self._finished[rid] = tokens
            out[rid] = tokens
            if self.metrics is not None:
                self.metrics.inc("model_tokens", n=int(np.size(tokens)),
                                 label=model)
        return out

    def run(self) -> Dict[int, np.ndarray]:
        """Drain every lane; returns {pool rid: tokens}. Makes progress
        every iteration unless a refused swap is the only work left — a
        persistent ``SwapFailure`` schedule is bounded by its trigger,
        so retries eventually clear (the chaos recovery contract)."""
        out: Dict[int, np.ndarray] = {}
        stuck = 0
        while self.pending():
            before = self.pending()
            out.update(self.step())
            stuck = stuck + 1 if self.pending() == before else 0
            if stuck > 1000:
                raise RuntimeError(
                    f"model pool made no progress for {stuck} passes "
                    f"({self.pending()} pending) — unbounded swap "
                    f"refusal?")
        return out

    # --------------------------------------------------------------- swapping
    def _load_params(self, model: str):
        src = self.loaders[model]
        return src() if callable(src) else src

    def _activate(self, model: str, *, retry: bool = False) -> bool:
        """The hot swap: a params-tree replace through the chaos site.
        Refusal (an injected ``SwapFailure``) happens BEFORE the
        engine's pointer moves — the previous params stay live, the
        failure is counted and ledgered, and ``_retry_model`` arms the
        next pass."""
        old = self._active
        t0 = self._clock()
        fault, chaos_seq = chaos.fire_seq(SITE_MODEL_SWAP, model=model,
                                          replica=self.replica)
        trigger = f"chaos#{chaos_seq}" if chaos_seq else ""
        lane = self._lanes.get(model)
        queued = len(lane.queue) if lane else 0
        if isinstance(fault, SwapFailure):
            self.stats["swap_failures"] += 1
            self._retry_model = model
            if self.metrics is not None:
                self.metrics.inc("swap_failures")
            self.ledger.decision(
                loop=self.loop, tick=self._tick, action="model_swap",
                current=len(self._resident), target=len(self._resident),
                reason=f"swap {old}->{model} refused: swap_failure "
                       f"({queued} queued); previous params stay live",
                commit="conflict:SwapFailure", trigger=trigger,
                parent=self._last_swap_seq,
                signals=(("from", old), ("to", model),
                         ("queued", str(queued))))
            self._log(f"tick={self._tick} swap {old}->{model} "
                      f"REFUSED=swap_failure queued={queued}")
            return False
        res = self._resident.get(model)
        if res is not None and res.params is not None:
            # resident: the tree is already prepared (int8-converted,
            # shard-planned) — re-preparing would double-quantize
            prev = self.engine.replace_params(res.params, quantized=True)
            res.params = None
        else:
            prev = self.engine.replace_params(self._load_params(model))
        self._resident[old].params = prev
        if res is None:
            self._resident[model] = _Resident()
        self._resident.move_to_end(model)
        self._active = model
        self._retry_model = None
        self._admitted_since_swap = 0
        swap_s = self._clock() - t0
        self.stats["swaps"] += 1
        if self.metrics is not None:
            self.metrics.inc("swaps")
            self.metrics.observe("swap_seconds", swap_s)
            self.metrics.set_gauge("resident_models", len(self._resident))
        reason = (f"activate {model} ({queued} queued); "
                  f"{'retry after swap_failure' if retry else 'lane turn'}")
        rec = self.ledger.decision(
            loop=self.loop, tick=self._tick, action="model_swap",
            current=len(self._resident), target=len(self._resident),
            reason=reason, commit=COMMIT_LANDED, trigger=trigger,
            parent=self._last_swap_seq,
            signals=(("from", old), ("to", model),
                     ("queued", str(queued)),
                     ("swap_s", f"{swap_s:.6f}")))
        if rec is not None:
            self._last_swap_seq = rec.seq
        self._log(f"tick={self._tick} swap {old}->{model} queued={queued}")
        self._evict_over_capacity(rec.seq if rec is not None else None)
        return True

    def _evict_over_capacity(self, swap_seq: Optional[int]) -> None:
        """LRU eviction down to ``max_resident``, never the active
        model. THE surgical flush: only the departing model's prefix
        ids drop (`engine.drop_prefix` is refcounted per id — slots
        still aliasing a page keep it alive); every other resident
        model's prefixes stay device-warm."""
        while len(self._resident) > self.max_resident:
            victim = next(m for m in self._resident if m != self._active)
            res = self._resident.pop(victim)
            flushed = 0
            for pid in res.prefixes:
                self.engine.drop_prefix(pid)
                flushed += 1
            self.stats["evictions"] += 1
            self.stats["prefix_flushes"] += flushed
            if self.metrics is not None:
                self.metrics.inc("evictions")
                if flushed:
                    self.metrics.inc("prefix_flushes", n=flushed)
                self.metrics.set_gauge("resident_models",
                                       len(self._resident))
            self.ledger.decision(
                loop=self.loop, tick=self._tick, action="model_evict",
                current=len(self._resident) + 1,
                target=len(self._resident),
                reason=f"evict {victim} from {self.replica}: lru over "
                       f"max_resident={self.max_resident} "
                       f"({flushed} prefixes flushed)",
                commit=COMMIT_LANDED, parent=swap_seq,
                signals=(("model", victim),
                         ("prefixes_flushed", str(flushed))))
            self._log(f"tick={self._tick} evict {victim} "
                      f"flushed={flushed}")

    def _log(self, line: str) -> None:
        self.decision_log.append(line)
