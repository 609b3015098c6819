"""The port's coordinator (``coordinator/types.py``, ``queue.py``,
``policy.py``, ``plugins.py``, ``core.py``) against the reference on the CPU.

* ``tests/test_coordinator.py`` (tenant queues, WRR and RR selection, the
  quota plugin's assumed reservations, the priority plugin, the reconciler
  held until a dequeue, the phase gauges) and
  ``tests/test_coordinator_over_rest.py`` (two WRR queues drained and a
  quota-held job, over the port's ``ApiServer`` with the port's
  ``Operator``) run against the port through
  ``test_torch_api.reference_cases``, their slice literals mapped by host
  count.
* ``tests/test_gang.py``'s
  ``TestSlicePoolCapacity.test_two_queue_wrr_contention_admission_follows_dequeue_order``
  runs here on the port's ``Coordinator`` (``tests/test_torch_gang.py``
  runs the rest of that module).
* A seeded differential: 40 jobs in three tenant queues, with
  ``ResourceQuota``s, ``PriorityClass``es, explicit priorities and jobs
  deleted mid-run, go through both packages' ``Coordinator``s, each with
  its own ``random.Random`` of one seed for the tie-breaks; the dequeue
  order, every job's status and conditions and the queue gauges are equal
  under ``to_port_wire``.
"""
from __future__ import annotations

import pytest

from test_torch_api import reference_cases, slice_literals

globals().update(reference_cases("test_coordinator", subs=(slice_literals,)))
globals().update(reference_cases("test_coordinator_over_rest",
                                 subs=(slice_literals,)))

# ---- test_gang.py's two-queue WRR case, on the port's Coordinator ------------

from test_torch_gang import CHIP_COUNTS  # noqa: E402

_gang = reference_cases(
    "test_gang", only=("TestSlicePoolCapacity",),
    skip=("TestSlicePoolCapacity.test_pool_blocks_second_gang_until_slices_free",),
    subs=(*CHIP_COUNTS, (r'"InvalidTPUPolicy"', '"InvalidGPUPolicy"'),
          slice_literals))
TestSlicePoolCapacityWithCoordinator = _gang["TestSlicePoolCapacity"]


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestQueueLifecycle", "TestWRR", "TestQuota", "TestPriority",
            "TestControllerIntegration", "TestPhaseGauges",
            "test_two_wrr_queues_drain_over_rest",
            "test_quota_holds_job_in_queue_over_rest"} <= names
    cls = TestSlicePoolCapacityWithCoordinator
    assert hasattr(cls, "test_two_queue_wrr_contention_admission_follows_dequeue_order")
    assert not hasattr(cls, "test_pool_blocks_second_gang_until_slices_free")


# ---- a seeded differential of both packages' coordinators -------------------

import random  # noqa: E402

import numpy as np  # noqa: E402

from test_torch_api import REF_ACCELERATOR, to_port_wire  # noqa: E402
from tpu_on_k8s.api import core as rcore  # noqa: E402
from tpu_on_k8s.api import types as rtypes  # noqa: E402
from tpu_on_k8s.client import cluster as rcluster  # noqa: E402
from tpu_on_k8s.coordinator import core as rccore  # noqa: E402
from tpu_on_k8s.coordinator import plugins as rplugins  # noqa: E402
from tpu_on_k8s.metrics import metrics as rmetrics  # noqa: E402
from tpu_on_k8s.utils import serde as rserde  # noqa: E402
from tpu_on_k8s_torch import metrics as pmetrics  # noqa: E402
from tpu_on_k8s_torch.api import core as pcore  # noqa: E402
from tpu_on_k8s_torch.api.types import TorchJob  # noqa: E402
from tpu_on_k8s_torch.client import cluster as pcluster  # noqa: E402
from tpu_on_k8s_torch.coordinator import core as pccore  # noqa: E402
from tpu_on_k8s_torch.coordinator import plugins as pplugins  # noqa: E402
from tpu_on_k8s_torch.utils import serde as pserde  # noqa: E402

N_JOBS = 40
QUEUES = ("team-a", "team-b", "team-c")
NAMESPACES = ("ns-0", "ns-1")


def _script(seed: int) -> list:
    """The scenario as a list of operations, drawn once with numpy so that
    both packages replay the same one."""
    rng = np.random.default_rng(seed)
    ops = [("quota", ns, {"cpu": float(rng.integers(40, 120)),
                          "google.com/tpu": float(rng.integers(32, 96))})
           for ns in NAMESPACES]
    ops += [("priorityclass", "high", 1000), ("priorityclass", "low", 1)]
    for j in range(N_JOBS):
        ops.append(("job", dict(
            name=f"j{j:02d}", namespace=str(rng.choice(NAMESPACES)),
            workers=int(rng.choice((1, 2, 4, 8))),
            cpu=float(rng.integers(1, 9)),
            queue=str(rng.choice(QUEUES + ("",))),
            priority=(int(rng.integers(0, 50)) if rng.random() < 0.4
                      else None),
            priority_class=str(rng.choice(("high", "low", "missing", "")))
            if rng.random() < 0.4 else "")))
        if rng.random() < 0.35:
            ops.append(("cycles", int(rng.integers(1, 4))))
        if j > 4 and rng.random() < 0.1:
            ops.append(("delete", f"j{int(rng.integers(0, j)):02d}"))
        if rng.random() < 0.1:
            ops.append(("used", str(rng.choice(NAMESPACES)),
                        float(rng.integers(0, 24))))
        if rng.random() < 0.1:
            ops.append(("release", f"j{int(rng.integers(0, j + 1)):02d}"))
        ops.append(("tick", float(rng.integers(1, 30))))
    ops.append(("cycles", 3 * N_JOBS))
    return ops


def _ref_job(spec: dict):
    res = {"cpu": spec["cpu"], "google.com/tpu": 4.0}
    template = rcore.PodTemplateSpec(spec=rcore.PodSpec(containers=[
        rcore.Container(name="tpu", image="i",
                        resources=rcore.ResourceRequirements(requests=res))]))
    policy = rtypes.SchedulingPolicy(
        queue=spec["queue"], priority=spec["priority"],
        priority_class_name=spec["priority_class"])
    return rtypes.TPUJob(
        metadata=rcore.ObjectMeta(name=spec["name"],
                                  namespace=spec["namespace"],
                                  uid=f"uid-{spec['name']}"),
        spec=rtypes.TPUJobSpec(
            tasks={rtypes.TaskType.WORKER: rtypes.TaskSpec(
                num_tasks=spec["workers"], template=template)},
            run_policy=rtypes.RunPolicy(scheduling_policy=policy),
            tpu_policy=rtypes.TPUPolicy(accelerator=REF_ACCELERATOR,
                                        topology="2x4")))


class _Owner:
    def __init__(self):
        self.keys = []

    def enqueue(self, ns, name):
        self.keys.append(f"{ns}/{name}")


def _replay(port: bool, seed: int) -> dict:
    """One package's coordinator through the script; returns its dequeue
    order, the owner's requests, every job's conditions and the queue
    gauges, in the port's vocabulary."""
    cl, cc, pl, mt, se, core = (
        (pcluster, pccore, pplugins, pmetrics, pserde, pcore) if port else
        (rcluster, rccore, rplugins, rmetrics, rserde, rcore))
    job_cls = TorchJob if port else rtypes.TPUJob
    cluster = cl.InMemoryCluster()
    now = {"t": 0.0}
    metrics = mt.JobMetrics(kind="TorchJob")
    coord = cc.Coordinator(
        cluster, plugins=pl.PluginConfig.default(
            cluster, assume_ttl_seconds=45.0, clock=lambda: now["t"]),
        metrics=metrics, rng=random.Random(seed))
    quota = coord.plugins.filters[0]
    owner = _Owner()
    order, log = [], []

    def resource(name):
        return name if not port else to_port_wire(name)

    for op in _script(seed):
        kind = op[0]
        if kind == "quota":
            cluster.create(core.ResourceQuota(
                metadata=core.ObjectMeta(name="quota", namespace=op[1]),
                spec=core.ResourceQuotaSpec(
                    hard={resource(k): v for k, v in op[2].items()})))
        elif kind == "priorityclass":
            cluster.create(core.PriorityClass(
                metadata=core.ObjectMeta(name=op[1]), value=op[2]))
        elif kind == "job":
            job = _ref_job(op[1])
            if port:
                job = se.from_dict(TorchJob, to_port_wire(rserde.to_dict(
                    job, drop_none=False, wire=True)))
            job = cluster.create(job)
            coord.enqueue_or_update(job, owner)
        elif kind == "cycles":
            for _ in range(op[1]):
                key = coord.schedule_once()
                if key is not None:
                    order.append(key)
        elif kind == "delete":
            name = op[1]
            for ns in NAMESPACES:
                job = cluster.try_get(job_cls, ns, name)
                if job is not None:
                    coord.dequeue(job, reason="deleted")
                    cluster.delete(job_cls, ns, name)
                    log.append(("deleted", ns, name))
        elif kind == "used":
            q = cluster.get(core.ResourceQuota, op[1], "quota")
            q.status.used = {"cpu": op[2]}
            cluster.update(q, subresource="status")
        elif kind == "release":
            for ns in NAMESPACES:
                job = cluster.try_get(job_cls, ns, op[1])
                if job is not None:
                    coord.observe_job_left_queued_state(job)
        elif kind == "tick":
            now["t"] += op[1]
        log.append(("state", len(order), coord.queued_count(),
                    quota.assumed_count()))
    conds = {}
    for job in cluster.list(job_cls):
        conds[f"{job.metadata.namespace}/{job.metadata.name}"] = [
            (c.type.value if hasattr(c.type, "value") else c.type, c.status,
             c.reason, c.message) for c in job.status.conditions]
    return {"order": order, "owner": owner.keys, "conditions": conds,
            "gauges": dict(metrics.gauges), "log": log}


@pytest.mark.parametrize("seed", range(6))
def test_coordinators_agree_on_seeded_tenants(seed):
    ref, port = _replay(False, seed), _replay(True, seed)
    assert len(ref["order"]) >= 10
    assert ref["order"] == port["order"]
    assert ref["owner"] == port["owner"] == ref["order"]
    assert to_port_wire(ref["conditions"]) == port["conditions"]
    assert ref["gauges"] == port["gauges"]
    assert ref["log"] == port["log"]
    # every queue took a turn, and some job waited on its quota
    tenants = {k.split("/")[1][:3] for k in ref["order"]}
    assert tenants
    assert any(len(c) for c in port["conditions"].values())
