"""The preemptible batch/offline inference lane (evals, bulk scoring; the
counterpart of ``tpu_on_k8s/serve/batchlane.py``).

The fifth capacity-broker consumer: a harvestable lane
that soaks up idle decode capacity and yields it within one broker tick
of an SLO page. Two layers:

* **``BatchLane``** — the deterministic core the broker and the digital
  twin drive directly: a FIFO backlog of :class:`BatchItem` work units,
  a granted capacity in allocation units (``slots_per_unit`` concurrent
  items each), and a ``step()`` pump. The broker PUSHes the grant up
  and down through :meth:`apply` (it registers as a *managed* consumer
  — growth comes from the fill phase, shrink from harvest). A shrink
  yields immediately: in-flight items beyond the new capacity go back
  to the FRONT of the backlog with their progress kept — preemption
  costs latency, never work, and never an item (the zero-silent-loss
  invariant ``submitted == completed + in_flight + backlog`` holds
  through any harvest sequence).
* **``BatchGatewayBridge``** — the production adapter riding the
  gateway's admission/drain machinery: it feeds backlog items into a
  `serve/gateway.ServingGateway` at a strictly lower priority than
  interactive traffic (the scheduler's strict priority lanes keep batch
  work invisible to serving latency), and on a harvest it ``cancel()``s
  its own in-flight gateway requests — the same cancellation path a
  drain uses — and requeues them, so a yield needs nothing the gateway
  does not already survive.

Stdlib-only core; the bridge imports nothing until constructed with a
live gateway.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import deque
from typing import Deque, Dict, List, Optional

from tpu_on_k8s_torch.coordinator.broker import KIND_BATCH, PRIORITY_BATCH, Bid

#: gateway priority for bridged batch submissions — strictly below the
#: interactive default (0): the scheduler dispatches higher lanes first
BATCH_GATEWAY_PRIORITY = -10


@dataclasses.dataclass
class BatchItem:
    """One unit of offline work. ``work`` is the remaining step budget
    (decode steps in the twin's cost model); progress survives a yield
    — a preempted item resumes where it stopped, it is never redone
    from scratch and never dropped."""

    item_id: int
    work: int
    tenant: str = "batch"


class BatchLane:
    """The deterministic batch-lane core (see module doc). Thread-safe:
    the broker's tick thread calls ``bid``/``apply`` while the pump
    owner calls ``submit``/``step``."""

    def __init__(self, *, slots_per_unit: int = 1, unit_chips: int = 1,
                 max_units: int = 0, default_work: int = 1,
                 name: str = "batch") -> None:
        self.name = name
        self.slots_per_unit = slots_per_unit
        self.unit_chips = unit_chips
        self.max_units = max_units
        self.default_work = default_work
        self.granted = 0
        self.submitted = 0
        self.completed = 0
        self.yields = 0
        self._backlog: Deque[BatchItem] = deque()
        self._in_flight: List[BatchItem] = []
        self._next_id = 1
        self._lock = threading.Lock()

    # ------------------------------------------------------------- frontend
    def submit(self, work: Optional[int] = None, *,
               tenant: str = "batch") -> int:
        """Enqueue one work item; returns its id. Batch admission never
        rejects — the backlog IS the product (goodput over latency)."""
        with self._lock:
            item = BatchItem(item_id=self._next_id,
                             work=max(1, work if work is not None
                                      else self.default_work),
                             tenant=tenant)
            self._next_id += 1
            self.submitted += 1
            self._backlog.append(item)
            return item.item_id

    def step(self) -> int:
        """One pump tick: admit backlog items into free slots, burn one
        work unit per active item, retire finished ones. Returns the
        number completed this step."""
        with self._lock:
            capacity = self.granted * self.slots_per_unit
            while len(self._in_flight) < capacity and self._backlog:
                self._in_flight.append(self._backlog.popleft())
            done = 0
            survivors: List[BatchItem] = []
            for item in self._in_flight:
                item.work -= 1
                if item.work <= 0:
                    done += 1
                else:
                    survivors.append(item)
            self._in_flight = survivors
            self.completed += done
            return done

    # --------------------------------------------------------- broker hooks
    def bid(self) -> Bid:
        """The lane's standing bid: hold what it has, want enough units
        to run the whole backlog (capped by ``max_units``), floor 0 —
        every chip is harvestable."""
        with self._lock:
            pending = len(self._backlog) + len(self._in_flight)
            want = -(-pending // self.slots_per_unit) if pending else 0
            if self.max_units > 0:
                want = min(want, self.max_units)
            return Bid(name=self.name, kind=KIND_BATCH,
                       priority=PRIORITY_BATCH, current=self.granted,
                       desired=want, floor=0, unit=self.unit_chips,
                       marginal_utility=float(pending),
                       preemption_cost=0.0)

    def apply(self, target_units: int, reason: str) -> bool:
        """The broker's push: resize the grant. A shrink yields within
        this call — in-flight items beyond the new capacity return to
        the FRONT of the backlog (newest first, so FIFO order over the
        whole lane is preserved) with their remaining work intact."""
        with self._lock:
            self.granted = max(0, target_units)
            capacity = self.granted * self.slots_per_unit
            while len(self._in_flight) > capacity:
                self._backlog.appendleft(self._in_flight.pop())
                self.yields += 1
            return True

    # -------------------------------------------------------------- reading
    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"submitted": self.submitted,
                    "completed": self.completed,
                    "backlog": len(self._backlog),
                    "in_flight": len(self._in_flight),
                    "granted": self.granted,
                    "yields": self.yields}

    def intact(self) -> bool:
        """The zero-silent-loss invariant."""
        with self._lock:
            return self.submitted == (self.completed + len(self._backlog)
                                      + len(self._in_flight))


class BatchGatewayBridge:
    """Feed a ``BatchLane`` backlog through a live ``ServingGateway`` at
    batch priority (see module doc). The bridge owns the mapping from
    lane items to gateway request ids; ``pump()`` tops up submissions to
    the granted capacity, ``poll()`` retires finished ones, and
    ``yield_excess()`` — called from the lane's broker ``apply`` on a
    shrink — cancels the newest in-flight gateway requests and requeues
    their items, riding the gateway's own cancellation/drain machinery."""

    def __init__(self, lane: BatchLane, gateway, *,
                 max_new_tokens: int = 16,
                 priority: int = BATCH_GATEWAY_PRIORITY) -> None:
        self.lane = lane
        self.gateway = gateway
        self.max_new_tokens = max_new_tokens
        self.priority = priority
        #: gateway rid -> lane item, in submission order
        self._live: Dict[int, BatchItem] = {}
        self._lock = threading.Lock()

    def pump(self, make_prompt) -> int:
        """Submit backlog items until the granted capacity is full.
        ``make_prompt(item)`` renders the item's prompt (the bridge is
        payload-agnostic). Returns how many were submitted; a gateway
        rejection (shedding, drain) puts the item straight back."""
        submitted = 0
        while True:
            with self.lane._lock:
                capacity = self.lane.granted * self.lane.slots_per_unit
                if not self.lane._backlog or len(self._live) >= capacity:
                    break
                item = self.lane._backlog.popleft()
                self.lane._in_flight.append(item)
            rid = self.gateway.submit(make_prompt(item),
                                      self.max_new_tokens,
                                      tenant=item.tenant,
                                      priority=self.priority)
            if not isinstance(rid, int):
                # Rejected: hand the item back to the lane, front of line
                with self.lane._lock:
                    self.lane._in_flight.remove(item)
                    self.lane._backlog.appendleft(item)
                break
            with self._lock:
                self._live[rid] = item
            submitted += 1
        return submitted

    def poll(self) -> int:
        """Retire gateway-terminal batch requests; returns how many
        completed."""
        done = 0
        with self._lock:
            rids = list(self._live)
        for rid in rids:
            res = self.gateway.result(rid)
            if res is None:
                continue
            with self._lock:
                item = self._live.pop(rid, None)
            if item is None:
                continue
            with self.lane._lock:
                try:
                    self.lane._in_flight.remove(item)
                except ValueError:
                    continue
                self.lane.completed += 1
            done += 1
        return done

    def yield_excess(self) -> int:
        """Shrink enforcement: cancel the newest in-flight gateway
        requests until the live set fits the lane's granted capacity,
        requeueing each item with its work intact. Returns how many
        yielded — all within this one call, the batch lane's
        within-one-tick preemption contract."""
        yielded = 0
        while True:
            with self.lane._lock:
                capacity = self.lane.granted * self.lane.slots_per_unit
            with self._lock:
                if len(self._live) <= capacity:
                    break
                rid = max(self._live)          # newest submission first
                item = self._live.pop(rid)
            self.gateway.cancel(rid)
            with self.lane._lock:
                try:
                    self.lane._in_flight.remove(item)
                except ValueError:
                    pass
                else:
                    self.lane._backlog.appendleft(item)
                    self.lane.yields += 1
            yielded += 1
        return yielded
