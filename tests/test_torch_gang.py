"""The port's gang scheduler (``gang/scheduler.py``: ``SliceGangScheduler``,
``SliceGangAdmission`` over ``NodePool``s, the registry) against the
reference on the CPU.

* ``tests/test_gang.py`` runs against the port through
  ``test_torch_api.reference_cases``: its slices mapped by host count
  (``slice_literals``), its two chip counts doubled (a reference host holds
  4 TPU chips, a port host 8 GPUs) and its ``InvalidTPUPolicy`` read as
  ``InvalidGPUPolicy``. One case waits (``WAITS``).
* The largest legal slice, ``64x8`` (64 hosts, 512 GPUs): a master and 63
  workers in one job-wide gang, and 64 workers in a per-role gang, each
  created, bound and admitted onto a node pool by both packages; every
  PodGroup and pod is equal under ``to_port_wire``, 512 GPUs claimed.
"""
from __future__ import annotations

import pytest

from test_torch_api import (
    PORT_ACCELERATOR,
    REF_ACCELERATOR,
    port_topology,
    reference_cases,
    slice_literals,
    to_port_wire,
)
from tpu_on_k8s.api import constants as RC
from tpu_on_k8s.api import core as rcore
from tpu_on_k8s.api import types as rtypes
from tpu_on_k8s.client import cluster as rcluster
from tpu_on_k8s.gang import scheduler as rscheduler
from tpu_on_k8s.utils import serde as rserde
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api import core as pcore
from tpu_on_k8s_torch.api.types import TorchJob
from tpu_on_k8s_torch.client import cluster as pcluster
from tpu_on_k8s_torch.gang import scheduler as pscheduler
from tpu_on_k8s_torch.gang import topology
from tpu_on_k8s_torch.utils import serde as pserde

#: the reference's cases that wait for a later slice of the port
WAITS = {
    "TestSlicePoolCapacity.test_two_queue_wrr_contention_admission_follows_dequeue_order":
        "builds tpu_on_k8s.coordinator.core.Coordinator, which the port "
        "gains with the coordinator (ROADMAP Queue 1, 6e)",
}

#: the reference's chip counts as GPU counts: 8 hosts x 4 chips are 8 x 8
#: GPUs, and 3/5 of 5 hosts x 4 chips are 3/5 of 5 x 8
CHIP_COUNTS = (
    (r'"google\.com/tpu": 32\}', '"nvidia.com/gpu": 64}'),
    (r'"google\.com/tpu": pytest\.approx\(12\.0\)',
     '"nvidia.com/gpu": pytest.approx(24.0)'),
)

globals().update(reference_cases(
    "test_gang", skip=tuple(WAITS),
    subs=(*CHIP_COUNTS, (r'"InvalidTPUPolicy"', '"InvalidGPUPolicy"'),
          slice_literals)))


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestPodGroupShapes", "TestBinding", "TestAdmission",
            "TestRegistry", "TestEngineIntegration",
            "TestSlicePoolCapacity"} <= names
    for case in WAITS:
        cls, meth = case.split(".")
        assert not hasattr(globals()[cls], meth), case
    assert hasattr(TestSlicePoolCapacity,
                   "test_pool_blocks_second_gang_until_slices_free")


def test_gang_scheduler_name_says_gpu():
    assert pscheduler.GANG_SCHEDULER_NAME == "gpu-slice"
    assert pscheduler.default_registry(pcluster.InMemoryCluster()).names() == [
        "gpu-slice"]


# ---- the largest legal slice --------------------------------------------------

REF_64 = "16x16"          # 64 hosts of tpu-v5-lite-podslice


def _ref_job(master: bool, workers: int) -> rtypes.TPUJob:
    def template():
        return rcore.PodTemplateSpec(spec=rcore.PodSpec(containers=[
            rcore.Container(name=RC.DEFAULT_CONTAINER_NAME, image="img:1",
                            resources=rcore.ResourceRequirements(
                                requests={"cpu": 4.0}))]))
    tasks = {rtypes.TaskType.WORKER: rtypes.TaskSpec(num_tasks=workers,
                                                     template=template())}
    if master:
        tasks[rtypes.TaskType.MASTER] = rtypes.TaskSpec(num_tasks=1,
                                                        template=template())
    return rtypes.TPUJob(
        metadata=rcore.ObjectMeta(name="big", namespace="default",
                                  uid="uid-64x8-job"),
        spec=rtypes.TPUJobSpec(tasks=tasks, tpu_policy=rtypes.TPUPolicy(
            accelerator=REF_ACCELERATOR, topology=REF_64)))


def _gang(port: bool, job_ref: rtypes.TPUJob, per_role: bool):
    """One package's scheduler: the job's podgroups, its pods bound as the
    engine binds them, one admission pass over a pool of two 64-host
    slices. Returns (podgroups, pods) as wire dicts in the port's words."""
    cl, sch, core, serde = ((pcluster, pscheduler, pcore, pserde) if port
                            else (rcluster, rscheduler, rcore, rserde))
    job = job_ref
    accelerator, topo = REF_ACCELERATOR, REF_64
    if port:
        job = pserde.from_dict(TorchJob, to_port_wire(
            rserde.to_dict(job_ref, drop_none=False, wire=True)))
        accelerator, topo = PORT_ACCELERATOR, port_topology(REF_ACCELERATOR, REF_64)
    cluster = cl.InMemoryCluster()
    cluster.create(job)
    gs = sch.SliceGangScheduler(cluster, per_role=per_role)
    gs.create_podgroups(job)
    for task_type, task in job.spec.tasks.items():
        for i in range(task.num_tasks):
            pod = core.Pod(metadata=core.ObjectMeta(
                name=f"big-{task_type.value.lower()}-{i}", namespace="default",
                labels={(constants if port else RC).LABEL_JOB_NAME: "big"}),
                spec=core.PodSpec(containers=[core.Container(name="c")]))
            gs.bind_pod(job, pod, task_type)
            cluster.create(pod)
    pool = sch.NodePool("a3", accelerator, topo, num_slices=2)
    admission = sch.SliceGangAdmission(cluster, pools=[pool])
    admitted = admission.sync()
    kinds = (sch.PodGroup, core.Pod)
    out = [[serde.to_dict(o, drop_none=False, wire=True)
            for o in sorted(cluster.list(k, "default"),
                            key=lambda o: o.metadata.name)] for k in kinds]
    for objs in out:
        for o in objs:
            o["metadata"].pop("creationTimestamp")
    if not port:
        out = to_port_wire(out)
        for pg in out[0]:
            res = pg["spec"]["minResources"]
            res[constants.RESOURCE_GPU] *= 2     # 4 TPU chips a host, 8 GPUs
    return admitted, admission.free_slices("a3"), out


@pytest.mark.parametrize("master,workers,per_role", [
    (True, 63, False), (False, 64, True), (True, 64, True)],
    ids=["master-63-workers-job-wide", "64-workers-per-role",
         "master-64-workers-per-role"])
def test_64x8_gang_matches_the_reference(master, workers, per_role):
    assert topology.hosts_per_slice(PORT_ACCELERATOR, "64x8") == 64
    ref = _gang(False, _ref_job(master, workers), per_role)
    port = _gang(True, _ref_job(master, workers), per_role)
    assert port == ref
    admitted, free, (pgs, pods) = port
    worker_group = [pg for pg in pgs
                    if pg["spec"]["minMember"] == 64]
    assert len(worker_group) == 1
    assert worker_group[0]["spec"]["minResources"][constants.RESOURCE_GPU] == 512
    assert worker_group[0]["metadata"]["name"] in admitted
    assert free == 1                      # one 64-host slice taken
    nodes = {p["spec"]["nodeName"] for p in pods
             if p["metadata"]["annotations"].get(
                 constants.ANNOTATION_GANG_GROUP_NAME)
             == worker_group[0]["metadata"]["name"]}
    assert nodes == {f"a3-s0-h{h}" for h in range(64)}
    assert all(p["spec"]["schedulerName"] == "gpu-slice" for p in pods)
