"""The port's cluster client (``client/cluster.py``, ``client/testing.py``)
and controller runtime (``controller/runtime.py``,
``controller/leaderelection.py``) against the reference on the CPU.

The reference's oracles run against the port through
``test_torch_api.reference_cases``: all 14 cases of ``tests/test_cluster.py``
(``InMemoryCluster``, ``KubeletSim``, ``Controller``, ``Manager``,
``Workqueue``), ``tests/test_utils_parity.py`` (the bounded map, the
semaphore, kubeconfig resolution) and the four Lease cases of
``tests/test_leaderelection.py``. Its fifth case,
``test_operator_leader_elect_flag_gates_controllers``, drives the
operator's entry point and runs with the entry's other cases in
``tests/test_torch_main.py``.

A seeded differential applies one sequence of creates, full and status
updates (stale ones among them), metadata and merge patches, finalizer
edits, deletes and owner cascades to the reference's ``InMemoryCluster``
and to the port's: every operation's outcome (the object through the map,
or the error's type), every watch event, resourceVersion, generation and
uid are equal.
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_api import (
    port_kind,
    reference_cases,
    to_port_wire,
    to_ref_wire,
)
from tpu_on_k8s.api import core as rcore
from tpu_on_k8s.api import types as rtypes
from tpu_on_k8s.client import cluster as rcluster
from tpu_on_k8s.client import resources as rresources
from tpu_on_k8s.utils import serde as rserde
from tpu_on_k8s_torch.client import cluster as pcluster
from tpu_on_k8s_torch.client import resources as presources
from tpu_on_k8s_torch.utils import serde as pserde

globals().update(reference_cases("test_cluster"))
globals().update(reference_cases("test_utils_parity"))
globals().update(reference_cases(
    "test_leaderelection",
    skip=("test_operator_leader_elect_flag_gates_controllers",)))


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestCluster", "TestWorkqueue",
            "test_bounded_map_respects_width_and_order",
            "test_first_candidate_wins_second_waits",
            "test_release_on_stop_lets_other_win_immediately"} <= names
    assert "test_operator_leader_elect_flag_gates_controllers" not in names


# ---- the seeded differential --------------------------------------------------

_STAMPS = ("creationTimestamp", "deletionTimestamp")


def _stamped(d):
    """A wire dict with the server's clock stamps reduced to set / unset:
    the two clusters stamp at different instants."""
    if isinstance(d, dict):
        return {k: (v is not None) if k in _STAMPS else _stamped(v)
                for k, v in d.items()}
    if isinstance(d, list):
        return [_stamped(v) for v in d]
    return d


class _Side:
    """One package's cluster, fed reference objects (mapped for the port)
    and read back as reference-shaped wire dicts."""

    def __init__(self, port: bool) -> None:
        self.port = port
        self.cluster = (pcluster if port else rcluster).InMemoryCluster()
        self.log = []
        self.cluster.watch(lambda e: self.log.append(
            (e.type, e.kind, e.obj.metadata.name,
             e.obj.metadata.resource_version, e.obj.metadata.generation,
             e.obj.metadata.uid)))

    def cls(self, ref_cls):
        if not self.port:
            return ref_cls
        kind = ref_cls.__dataclass_fields__["kind"].default
        return presources.by_kind(port_kind(kind)).cls

    def obj(self, ref_obj):
        if not self.port:
            return rserde.deep_copy(ref_obj)
        wire = rserde.to_dict(ref_obj, drop_none=False, wire=True)
        return pserde.from_dict(self.cls(type(ref_obj)), to_port_wire(wire))

    def wire(self, obj):
        if obj is None:
            return None
        serde = pserde if self.port else rserde
        d = serde.to_dict(obj, drop_none=False, wire=True)
        return _stamped(d if self.port else to_port_wire(d))

    def event_log(self):
        if self.port:
            return self.log
        return [(t, port_kind(k), *rest) for t, k, *rest in self.log]


def _pod(name, owner=None, finalizers=()):
    meta = rcore.ObjectMeta(name=name, finalizers=list(finalizers))
    if owner is not None:
        meta.owner_references = [rcore.OwnerReference(
            api_version=owner.api_version, kind=owner.kind,
            name=owner.metadata.name, uid=owner.metadata.uid,
            controller=True)]
    return rcore.Pod(metadata=meta, spec=rcore.PodSpec(
        containers=[rcore.Container(name="tpu", image="i")]))


def _job(name, workers):
    tmpl = rcore.PodTemplateSpec(spec=rcore.PodSpec(
        containers=[rcore.Container(name="tpu", image="i")]))
    return rtypes.TPUJob(
        metadata=rcore.ObjectMeta(name=name),
        spec=rtypes.TPUJobSpec(tasks={rtypes.TaskType.WORKER: rtypes.TaskSpec(
            num_tasks=workers, template=tmpl)}))


def _ops(seed: int, n: int = 60):
    """A seeded operation list over a small name pool (so that operations
    collide: updates of missing objects, creates of existing ones)."""
    rng = np.random.default_rng(seed)
    verbs = ["create_pod", "create_job", "update", "stale_update", "status",
             "patch_meta", "merge_patch", "delete", "get"]
    return [(str(rng.choice(verbs)), int(rng.integers(0, 4)),
             int(rng.integers(0, 1000))) for _ in range(n)]


def _run(side: _Side, ops):
    """Apply ``ops`` and return each one's outcome: the object (as a
    reference-shaped wire dict, stamps reduced) or the error's type name."""
    c = side.cluster
    Pod, Job = side.cls(rcore.Pod), side.cls(rtypes.TPUJob)
    errors = pcluster.ApiError if side.port else rcluster.ApiError
    serde = pserde if side.port else rserde
    stale = {}
    out = []
    for verb, i, r in ops:
        pod, job = f"p{i}", f"j{i % 2}"
        try:
            if verb == "create_pod":
                owner = c.try_get(Job, "default", job) if r % 3 == 0 else None
                fins = ["a.io/keep"] if r % 4 == 0 else []
                if owner is not None:
                    owner = rserde.from_dict(rtypes.TPUJob, _back(side, owner))
                res = c.create(side.obj(_pod(pod, owner, fins)))
            elif verb == "create_job":
                res = c.create(side.obj(_job(job, 1 + r % 4)))
            elif verb == "get":
                res = c.get(Pod, "default", pod)
                stale[pod] = res
            elif verb in ("update", "stale_update", "status"):
                if verb == "stale_update" and pod in stale:
                    obj = stale[pod]
                else:
                    obj = c.get(Pod, "default", pod)
                    stale.setdefault(pod, obj)
                obj = serde.deep_copy(obj)
                obj.metadata.labels[f"l{r % 3}"] = str(r)
                obj.spec.node_name = f"n{r % 2}"
                obj.status.phase = "Running"
                res = c.update(obj, subresource="status" if verb == "status"
                               else "")
            elif verb == "patch_meta":
                res = c.patch_meta(
                    Pod, "default", pod, labels={"x": str(r), "l0": None},
                    annotations={"a": str(r)},
                    add_finalizers=["a.io/keep"] if r % 2 else [],
                    remove_finalizers=[] if r % 2 else ["a.io/keep"])
            elif verb == "merge_patch":
                cur = c.get(Job, "default", job)
                rv = cur.metadata.resource_version - (r % 2)
                res = c.merge_patch(Job, "default", job, {
                    "metadata": {"resourceVersion": str(rv),
                                 "labels": {"m": str(r)}},
                    "spec": {"tasks": {"Worker": {"numTasks": 1 + r % 5}}}})
            else:  # delete, a job half of the time: the cascade
                if r % 2:
                    c.delete(Job, "default", job)
                else:
                    c.delete(Pod, "default", pod)
                res = None
            out.append((verb, side.wire(res)))
        except errors as e:
            out.append((verb, type(e).__name__))
    return out


def _back(side: _Side, obj):
    """A port object as a reference wire dict (for building owner refs)."""
    if not side.port:
        return rserde.to_dict(obj, drop_none=False, wire=True)
    return to_ref_wire(pserde.to_dict(obj, drop_none=False, wire=True))


@pytest.mark.parametrize("seed", range(6))
def test_seeded_operations_equal_the_reference(seed):
    ops = _ops(seed)
    ref, port = _Side(port=False), _Side(port=True)
    want, got = _run(ref, ops), _run(port, ops)
    assert got == want
    assert port.event_log() == ref.event_log()
    assert ref.cluster.current_rv == port.cluster.current_rv
    assert [e[1:] for e in port.cluster.events] == \
        [e[1:] for e in ref.cluster.events]
    # every reference kind routes in the port too
    assert {port_kind(r.kind) for r in rresources.all_types()} == \
        {r.kind for r in presources.all_types()}


def test_the_sequence_exercises_every_outcome():
    """The seeds above reach conflicts, missing objects, duplicates,
    finalizer-pinned deletes and cascades, so that equality means
    something."""
    outcomes = set()
    for seed in range(6):
        side = _Side(port=True)
        for verb, res in _run(side, _ops(seed)):
            outcomes.add(res if isinstance(res, str) else verb)
        outcomes |= {e[0] for e in side.log}
    assert {"ConflictError", "NotFoundError", "AlreadyExistsError",
            "DELETED", "MODIFIED", "merge_patch", "status"} <= outcomes
