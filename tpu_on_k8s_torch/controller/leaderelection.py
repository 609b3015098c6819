"""Lease-based leader election (reference main.go:77-83 — controller-runtime
leader election "torch-on-k8s-election").

A coordination Lease object in the cluster: candidates try to acquire it,
the holder renews every ``renew_seconds``, and anyone observing a lease older
than ``lease_seconds`` may take over. Conflict-safe through the cluster's
resource-version semantics — a lost update means someone else renewed first.
"""
from __future__ import annotations

import datetime as _dt
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

from tpu_on_k8s_torch.api.core import ObjectMeta, utcnow
from tpu_on_k8s_torch.client.cluster import AlreadyExistsError, ConflictError, InMemoryCluster
from tpu_on_k8s_torch.utils.logging import get_logger

_log = get_logger("leaderelection")

LEASE_NAME = "tpu-on-k8s-election"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease analog.

    Internal fields are flat; the wire hooks emit/accept the real
    coordination.k8s.io shape — ``spec.holderIdentity``,
    ``spec.leaseDurationSeconds`` (integer), ``spec.renewTime`` (MicroTime:
    RFC 3339 with a *mandatory* 6-digit fraction — a real apiserver's strict
    layout parse rejects a bare seconds timestamp). Without this mapping a
    real cluster would prune the unknown flat fields and every candidate
    would see an unheld lease: split-brain. Pinned by the golden fixture in
    tests/fixtures/wire/lease_update_request.json.
    """

    api_version: str = "coordination.k8s.io/v1"
    kind: str = "Lease"
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder: str = ""
    renew_time: Optional[_dt.datetime] = None
    lease_seconds: float = 15.0

    @staticmethod
    def __wire_out__(d):
        spec: dict = {}
        holder = d.pop("holder", None)
        if holder:
            spec["holderIdentity"] = holder
        rt = d.pop("renewTime", None)
        if rt:
            if "." not in rt:  # MicroTime: fraction is not optional
                # insert before any offset suffix (Z, +hh:mm, -hh:mm after
                # the date part) so non-UTC/naive clocks stay parseable too
                for i, ch in enumerate(rt[11:], start=11):
                    if ch in "Z+-":
                        rt = rt[:i] + ".000000" + rt[i:]
                        break
                else:
                    rt += ".000000"
            spec["renewTime"] = rt
        ls = d.pop("leaseSeconds", None)
        if ls is not None:
            # integer ≥ 1 on the wire (the apiserver's validation floor);
            # sub-second test leases round up rather than expiring instantly
            spec["leaseDurationSeconds"] = max(1, int(round(ls)))
        d["spec"] = spec
        return d

    @staticmethod
    def __wire_in__(d):
        spec = d.get("spec")
        if isinstance(spec, dict):
            d = dict(d)
            if "holderIdentity" in spec:
                d["holder"] = spec["holderIdentity"] or ""
            if spec.get("renewTime"):
                d["renew_time"] = spec["renewTime"]
            if spec.get("leaseDurationSeconds") is not None:
                d["lease_seconds"] = float(spec["leaseDurationSeconds"])
        return d


class LeaderElector:
    """Acquire/renew loop; ``is_leader`` gates the manager's controllers."""

    def __init__(self, cluster: InMemoryCluster, identity: str,
                 namespace: str = "tpu-on-k8s-system",
                 lease_seconds: float = 15.0, renew_seconds: float = 5.0,
                 clock: Callable[[], _dt.datetime] = utcnow,
                 on_started_leading: Optional[Callable[[], None]] = None,
                 on_stopped_leading: Optional[Callable[[], None]] = None,
                 lease_name: str = LEASE_NAME):
        self.cluster = cluster
        self.identity = identity
        self.lease_name = lease_name
        self.namespace = namespace
        self.lease_seconds = lease_seconds
        self.renew_seconds = renew_seconds
        self.clock = clock
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._leader = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    @property
    def is_leader(self) -> bool:
        return self._leader

    # ------------------------------------------------------------------ core
    def _expired(self, lease: Lease) -> bool:
        if lease.renew_time is None:
            return True
        age = (self.clock() - lease.renew_time).total_seconds()
        return age > lease.lease_seconds

    def try_acquire_or_renew(self) -> bool:
        """One election round; returns whether we hold the lease after it."""
        now = self.clock()
        existing = self.cluster.try_get(Lease, self.namespace, self.lease_name)
        if existing is None:
            lease = Lease(metadata=ObjectMeta(name=self.lease_name,
                                              namespace=self.namespace),
                          holder=self.identity, renew_time=now,
                          lease_seconds=self.lease_seconds)
            try:
                self.cluster.create(lease)
            except (AlreadyExistsError, ConflictError):
                return self._transition(False)
            return self._transition(True)
        if existing.holder != self.identity and not self._expired(existing):
            return self._transition(False)

        def mutate(lease: Lease) -> None:
            # re-checked under the update's conflict retry: only renew what
            # is still ours or still expired
            if lease.holder != self.identity and not self._expired(lease):
                raise _LostRace()
            lease.holder = self.identity
            lease.renew_time = self.clock()
            lease.lease_seconds = self.lease_seconds

        try:
            self.cluster.update_with_retry(Lease, self.namespace,
                                           self.lease_name, mutate)
        except _LostRace:
            return self._transition(False)
        return self._transition(True)

    def _transition(self, leading: bool) -> bool:
        if leading and not self._leader:
            self._leader = True
            if self.on_started_leading:
                self.on_started_leading()
        elif not leading and self._leader:
            self._leader = False
            if self.on_stopped_leading:
                self.on_stopped_leading()
        return leading

    # --------------------------------------------------------------- run loop
    def run(self) -> None:  # pragma: no cover - timing loop; logic is above
        self.try_acquire_or_renew()  # immediate first round, then renew cycle
        while not self._stop.wait(self.renew_seconds):
            self.try_acquire_or_renew()

    def start(self) -> None:  # pragma: no cover
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._leader:
            self._release()

    def _release(self) -> None:
        def mutate(lease: Lease) -> None:
            if lease.holder == self.identity:
                lease.holder = ""
                lease.renew_time = None

        try:
            self.cluster.update_with_retry(Lease, self.namespace,
                                           self.lease_name, mutate)
        # analyze: allow[silent-loss] best-effort lease release — expiry is the fallback, and the failure is logged
        except Exception:
            # best-effort: the lease expires on its own if the release write
            # loses a race or the server is gone — but say so
            _log.warning("lease release failed; relying on expiry",
                         exc_info=True)
        self._transition(False)


class _LostRace(Exception):
    pass
