"""Multi-tenant fair ordering of the gateway's pending queue.

Reuses the coordinator's smooth-WRR core (`coordinator/policy.py`
``SmoothWRR`` — the exact policy that orders tenant job queues) to order
tenant *request* queues, under strict priority lanes:

* **Priority lanes** — higher ``priority`` always dispatches first
  (the coordinator's PriorityPlugin semantics). Within a lane:
* **Smooth WRR across tenants** — each tenant gets slots in proportion to
  its configured weight (default 1.0, i.e. equal shares). A tenant
  flooding 100 requests cannot starve a tenant with 2: weights are
  *configured* shares, NOT queue depths — depth-weighting is exactly the
  anti-fairness a flooding tenant wants (the coordinator weights by
  pending count because draining long job queues faster IS its goal;
  serving fairness is the opposite).
* **FIFO within a tenant** — a tenant's own requests keep arrival order.

Not thread-safe on its own; the gateway serializes access under its lock.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, List, Optional

from tpu_on_k8s_torch.coordinator.policy import SmoothWRR
from tpu_on_k8s_torch.serve.lifecycle import GatewayRequest


class FairScheduler:
    """Priority lanes → smooth-WRR over tenants → FIFO per tenant."""

    def __init__(self, tenant_weights: Optional[Dict[str, float]] = None
                 ) -> None:
        for t, w in (tenant_weights or {}).items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        self._weights = dict(tenant_weights or {})
        # priority → tenant → FIFO of requests; one WRR state per lane so
        # a tenant's debt in the bulk lane can't tax its interactive lane
        self._lanes: Dict[int, Dict[str, deque]] = {}
        self._wrr: Dict[int, SmoothWRR] = {}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, req: GatewayRequest) -> None:
        lane = self._lanes.setdefault(req.priority, {})
        lane.setdefault(req.tenant, deque()).append(req)
        self._wrr.setdefault(req.priority, SmoothWRR())
        self._len += 1

    def push_front(self, req: GatewayRequest) -> None:
        """Un-pop: return a request to the HEAD of its tenant's FIFO (a
        dispatch that could not complete must not lose its place, or
        FIFO-within-tenant breaks and a repeatedly-unlucky request drifts
        to the back)."""
        lane = self._lanes.setdefault(req.priority, {})
        lane.setdefault(req.tenant, deque()).appendleft(req)
        self._wrr.setdefault(req.priority, SmoothWRR())
        self._len += 1

    def pop(self) -> Optional[GatewayRequest]:
        """The next request to dispatch, or None when empty."""
        for prio in sorted(self._lanes, reverse=True):
            lane = self._lanes[prio]
            weights = {t: self._weights.get(t, 1.0)
                       for t, q in lane.items() if q}
            if not weights:
                continue
            tenant = self._wrr[prio].pick(weights)
            req = lane[tenant].popleft()
            self._prune(prio, tenant)
            self._len -= 1
            return req
        return None

    def remove(self, req: GatewayRequest) -> bool:
        """Pull a specific request (cancel / deadline expiry while queued).
        O(tenant queue length) — fine at gateway scale."""
        lane = self._lanes.get(req.priority, {})
        q = lane.get(req.tenant)
        if q is None:
            return False
        try:
            q.remove(req)
        except ValueError:
            return False
        self._prune(req.priority, req.tenant)
        self._len -= 1
        return True

    def _prune(self, prio: int, tenant: str) -> None:
        lane = self._lanes[prio]
        if not lane[tenant]:
            del lane[tenant]
        if not lane:
            del self._lanes[prio]
            del self._wrr[prio]

    def queued(self) -> Iterator[GatewayRequest]:
        """Snapshot iteration (deadline scans); dispatch order not implied."""
        out: List[GatewayRequest] = []
        for lane in self._lanes.values():
            for q in lane.values():
                out.extend(q)
        return iter(out)
