"""The port's job controller (``controller/engine.py``, ``torchjob.py``,
``config``, ``expectations``, ``dag``, ``hostnetwork``, ``failover``) and
its gang scheduler against the reference on the CPU.

* ``tests/test_engine.py`` runs against the port through
  ``test_torch_api.reference_cases``, its slice literals mapped by host
  count (``slice_literals``). Five of its cases assert the TPU wiring and
  are replaced by GPU twins here (``TPU_ENV_TWINS``): the env, the
  compile cache, the user's env winning, the elastic rendezvous args
  (``c10d``, not ``xla``) and Megascale (a multi-slice job is one world).
* A seeded differential builds 36 job specs with numpy — master or none,
  the worker count, elastic or not, hostnetwork, spot replicas, restart
  policies, exit codes, ``num_slices``, gangs — and runs each through both
  packages' controllers on their ``InMemoryCluster``s under the same
  ``KubeletSim`` outcomes. Every pod, service, PodGroup, event and job
  status is equal under ``to_port_wire`` once the env is read as
  ``RANK`` = ``TPU_PROCESS_ID``, ``WORLD_SIZE`` = ``TPU_NUM_PROCESSES`` and
  ``MASTER_ADDR:MASTER_PORT`` = ``XLA_COORDINATOR_ADDRESS``, the dropped TPU
  names absent from the port's pods. Two of the specs are the largest
  legal slice, ``64x8``: a master and 63 workers, and 64 gang-admitted
  workers.
* Over REST, the operator's flows of ``tests/test_rest_backend.py`` (a job's
  lifecycle, here with its TTL cleanup) and
  ``tests/test_hostnetwork_spot_over_rest.py`` (host ports allocated and
  released on the DELETED event, spot replicas) run as GPU twins on the
  port's ``ApiServer`` and ``RestCluster`` with the port's ``Operator``
  (``tpu_on_k8s_torch/main.py``); the reference's own cases run on it in
  ``tests/test_torch_main.py``.
"""
from __future__ import annotations

import random
import sys
import time

import numpy as np
import pytest

from test_torch_api import (
    DROPPED,
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
from tpu_on_k8s.client import testing as rtesting
from tpu_on_k8s.controller import failover as rfailover
from tpu_on_k8s.controller import runtime as rruntime
from tpu_on_k8s.controller import tpujob as rtpujob
from tpu_on_k8s.gang import scheduler as rscheduler
from tpu_on_k8s.gang import topology as rtopology
from tpu_on_k8s.utils import serde as rserde
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api import core as pcore
from tpu_on_k8s_torch.api.core import PodPhase, PodSpec, PodTemplateSpec
from tpu_on_k8s_torch.api.types import (
    CleanPodPolicy,
    ElasticPolicy,
    GPUPolicy,
    SpotTaskSpec,
    TaskSpec,
    TaskType,
    TorchJob,
    TorchJobSpec,
)
from tpu_on_k8s_torch.client import cluster as pcluster
from tpu_on_k8s_torch.client import resources as presources
from tpu_on_k8s_torch.client import testing as ptesting
from tpu_on_k8s_torch.client.apiserver import ApiServer
from tpu_on_k8s_torch.client.rest import RestCluster
from tpu_on_k8s_torch.controller import failover as pfailover
from tpu_on_k8s_torch.controller import runtime as pruntime
from tpu_on_k8s_torch.controller import torchjob as ptorchjob
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.gang import scheduler as pscheduler
from tpu_on_k8s_torch.utils import serde as pserde

#: the reference's cases that assert the TPU wiring -> their twins here
TPU_ENV_TWINS = {
    "TestLifecycle.test_tpu_env_wiring": "test_torch_env_wiring",
    "TestLifecycle.test_compile_cache_and_perf_env_injected":
        "test_no_tpu_or_xla_wiring_is_injected",
    "TestLifecycle.test_user_perf_env_wins_over_injection":
        "test_user_profiling_env_wins_over_injection",
    "TestLifecycle.test_elastic_wiring": "test_elastic_wiring_rendezvous_is_c10d",
    "TestLifecycle.test_megascale_env_multislice":
        "test_multislice_job_is_one_world",
}

globals().update(reference_cases("test_engine", skip=tuple(TPU_ENV_TWINS),
                                 subs=(slice_literals,)))
#: the reference module run against the port, for its helpers
ENG = sys.modules["_port_test_engine"]

#: the env names of the reference's TPU wiring that the port never writes
TPU_ENV = tuple(getattr(RC, n) for n in DROPPED if n.startswith("ENV_")) + (
    RC.ENV_COORDINATOR_ADDRESS, RC.ENV_PROCESS_ID, RC.ENV_NUM_PROCESSES)


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestLifecycle", "TestSpotAndDeadline",
            "TestSliceAtomicFailover"} <= names
    for case, twin in TPU_ENV_TWINS.items():
        cls, meth = case.split(".")
        assert not hasattr(globals()[cls], meth), case
        assert twin in names, twin
    assert hasattr(TestLifecycle, "test_profiling_env_injected_only_when_configured")


def _started(n_workers=2, **kw):
    cluster, manager, engine, sim = ENG.make_env()
    ptorchjob.submit_job(cluster, ENG.job_spec(workers=n_workers, **kw))
    manager.run_until_idle()
    if kw.get("master", True):
        sim.run_pod("default", "j1-master-0")
        manager.run_until_idle()
    return cluster, {p.metadata.name: p for p in ENG.pods_of(cluster)}


def test_torch_env_wiring():
    """``test_tpu_env_wiring`` in the GPU flavour: the torch.distributed env
    of the reference operator, the GPU requests and the accelerator
    selector (and no topology selector)."""
    _, pods = _started()
    master = pods["j1-master-0"].spec.containers[0].env_map()
    assert master[constants.ENV_MASTER_ADDR] == "localhost"
    assert master[constants.ENV_MASTER_PORT] == "8476"
    assert master[constants.ENV_PROCESS_ID] == "0"
    assert master[constants.ENV_NUM_PROCESSES] == "3"
    w1 = pods["j1-worker-1"]
    env = w1.spec.containers[0].env_map()
    assert env[constants.ENV_MASTER_ADDR] == "j1-master-0.default"
    assert env[constants.ENV_MASTER_PORT] == "8476"
    assert env[constants.ENV_PROCESS_ID] == "2"  # rank shifted past master
    assert env[constants.ENV_NUM_PROCESSES] == "3"
    assert env[constants.ENV_PYTHONUNBUFFERED] == "1"
    assert w1.spec.node_selector == {
        constants.NODE_SELECTOR_GPU_ACCELERATOR: PORT_ACCELERATOR}
    res = w1.spec.containers[0].resources
    assert res.requests[constants.RESOURCE_GPU] == 8
    assert res.limits[constants.RESOURCE_GPU] == 8


def test_no_tpu_or_xla_wiring_is_injected():
    """The port runs no XLA: no TPU env, no compile-cache volume or mount,
    on any pod."""
    _, pods = _started()
    assert len(pods) == 3
    for pod in pods.values():
        env = pod.spec.containers[0].env_map()
        assert not set(TPU_ENV) & set(env), pod.metadata.name
        assert not pod.spec.volumes
        assert not pod.spec.containers[0].volume_mounts


def test_user_profiling_env_wins_over_injection():
    """Setdefault semantics: a profiling env the user set in the pod
    template survives the reconciler's injection."""
    cluster = pcluster.InMemoryCluster()
    manager = pruntime.Manager()
    ptorchjob.setup_torchjob_controller(cluster, manager, config=JobControllerConfig(
        profile_dir="/prof", profiler_port=9009))
    job = ENG.job_spec(master=False)
    container = job.spec.tasks[TaskType.WORKER].template.spec.containers[0]
    container.set_env(constants.ENV_PROFILE_DIR, "/mine")
    ptorchjob.submit_job(cluster, job)
    manager.run_until_idle()
    env = cluster.get(pcore.Pod, "default", "j1-worker-0").spec.containers[0].env_map()
    assert env[constants.ENV_PROFILE_DIR] == "/mine"
    assert env[constants.ENV_PROFILER_PORT] == "9009"


def test_elastic_wiring_rendezvous_is_c10d():
    """``test_elastic_wiring`` with torchrun's backend: every assertion of
    the reference's case, ``--rdzv_backend=c10d`` for its ``xla``."""
    cluster, manager, engine, sim = ENG.make_env()
    spec = ENG.job_spec(workers=2, elastic=ElasticPolicy(min_replicas=2, max_replicas=8),
                        annotations={constants.ANNOTATION_ENABLE_ELASTIC: "true"})
    ptorchjob.submit_job(cluster, spec)
    manager.run_until_idle()
    sim.run_pod("default", "j1-master-0")
    manager.run_until_idle()
    w0 = cluster.get(pcore.Pod, "default", "j1-worker-0")
    args = w0.spec.containers[0].args
    assert f"{constants.ARG_RDZV_BACKEND}=c10d" in args
    assert f"{constants.ARG_RDZV_ENDPOINT}=j1-master-0.default:8476" in args
    assert f"{constants.ARG_NNODES}=2:8" in args
    assert w0.metadata.annotations[constants.ANNOTATION_WORLD_SIZE] == "3"
    vf = [e for e in w0.spec.containers[0].env if e.name == constants.ENV_NUM_PROCESSES]
    assert vf and vf[0].value_from is not None
    assert constants.FINALIZER_PREEMPT_PROTECTOR in w0.metadata.finalizers
    assert constants.LABEL_JOB_GENERATION in w0.metadata.labels
    assert {c.name for c in w0.spec.init_containers} == {"image-warmup", "master-waiter"}


def test_multislice_job_is_one_world():
    """Two slices of two hosts: one world of four ranks behind worker-0,
    and no per-slice env."""
    _, pods = _started(n_workers=4, master=False, num_slices=2)
    envs = [pods[f"j1-worker-{i}"].spec.containers[0].env_map() for i in range(4)]
    assert [e[constants.ENV_PROCESS_ID] for e in envs] == ["0", "1", "2", "3"]
    for env in envs:
        assert env[constants.ENV_NUM_PROCESSES] == "4"
        assert env[constants.ENV_MASTER_ADDR] == "j1-worker-0.default"
        assert not set(TPU_ENV) & set(env)


# ---- the seeded differential ---------------------------------------------------

#: exit codes and reasons of the failures the kubelet reports
EXIT_CODES = (1, 2, 3, 126, 127, 130, 137, 138, 139, 143)
REASONS = ("Error", "OOMKilled", "Evicted", "Killed", "")
POLICIES = (None, rtypes.RestartPolicy.NEVER, rtypes.RestartPolicy.ON_FAILURE,
            rtypes.RestartPolicy.ON_EXIT_CODE)
#: ``google.com/tpu`` per host of the reference's slice vs GPUs per host
GPU_SCALE = 8 / rtopology.chips_per_host(REF_ACCELERATOR)
_STAMP_KEYS = ("Timestamp", "Time")


def make_spec(seed: int) -> dict:
    """One job's description, drawn from a seeded generator."""
    rng = np.random.default_rng(seed)
    topos = [t for t in rtopology.legal_topologies(REF_ACCELERATOR)
             if rtopology.hosts_per_slice(REF_ACCELERATOR, t) <= 4]
    topo = topos[int(rng.integers(len(topos)))]
    hosts = rtopology.hosts_per_slice(REF_ACCELERATOR, topo)
    num_slices = int(rng.integers(1, 3))
    quorum = hosts * num_slices
    gang = [None, True, False][int(rng.integers(3))]
    workers = quorum * int(rng.integers(1, 3))
    if gang is not None and rng.random() < 0.15:
        workers = max(quorum - 1, 1)          # a gang that could never admit
    elastic = ["none", "none", "annotation", "policy"][int(rng.integers(4))]
    spec = dict(
        seed=seed, topology=topo, num_slices=num_slices,
        master=bool(rng.random() < 0.6), workers=workers, gang=gang,
        elastic=elastic, hostnetwork=bool(rng.random() < 0.3),
        spot=int(rng.integers(1, workers + 1)) if rng.random() < 0.3 else 0,
        master_policy=POLICIES[int(rng.integers(len(POLICIES)))],
        worker_policy=POLICIES[int(rng.integers(len(POLICIES)))],
        restarter=bool(rng.random() < 0.5),
        ttl=0 if rng.random() < 0.25 else None,
        backoff=int(rng.integers(0, 3)) if rng.random() < 0.3 else None,
        failures=[(["master", "worker"][int(rng.integers(2))],
                   int(rng.integers(workers)),
                   EXIT_CODES[int(rng.integers(len(EXIT_CODES)))],
                   REASONS[int(rng.integers(len(REASONS)))])
                  for _ in range(int(rng.integers(1, 3)))])
    return spec


def ref_job(spec: dict) -> rtypes.TPUJob:
    def template():
        return rcore.PodTemplateSpec(spec=rcore.PodSpec(containers=[
            rcore.Container(name=RC.DEFAULT_CONTAINER_NAME, image="img:1",
                            resources=rcore.ResourceRequirements(
                                requests={"cpu": 1.0}))]))

    tasks = {}
    if spec["master"]:
        tasks[rtypes.TaskType.MASTER] = rtypes.TaskSpec(
            num_tasks=1, template=template(),
            restart_policy=spec["master_policy"])
    worker = rtypes.TaskSpec(num_tasks=spec["workers"], template=template(),
                             restart_policy=spec["worker_policy"])
    if spec["spot"]:
        worker.spot_task_spec = rtypes.SpotTaskSpec(
            num_spot_tasks=spec["spot"], priority_class_name="spot",
            labels={"capacity-type": "spot"})
    tasks[rtypes.TaskType.WORKER] = worker
    annotations = {}
    if spec["elastic"] == "annotation":
        annotations[RC.ANNOTATION_ENABLE_ELASTIC] = "true"
    if spec["hostnetwork"]:
        annotations[RC.ANNOTATION_NETWORK_MODE] = RC.NETWORK_MODE_HOST
    run = rtypes.RunPolicy(ttl_seconds_after_finished=spec["ttl"],
                           backoff_limit=spec["backoff"])
    return rtypes.TPUJob(
        metadata=rcore.ObjectMeta(name=f"d{spec['seed']}",
                                  uid=f"job-{spec['seed']:05d}",
                                  annotations=annotations),
        spec=rtypes.TPUJobSpec(
            tasks=tasks, run_policy=run,
            elastic_policy=(rtypes.ElasticPolicy(
                min_replicas=1, max_replicas=spec["workers"])
                if spec["elastic"] == "policy" else None),
            tpu_policy=rtypes.TPUPolicy(accelerator=REF_ACCELERATOR,
                                        topology=spec["topology"],
                                        num_slices=spec["num_slices"])))


class Side:
    """One package's controller on its own cluster, read back as wire dicts
    in the port's vocabulary."""

    def __init__(self, port: bool, spec: dict) -> None:
        self.port, self.spec = port, spec
        cl, rt, tj, fo, sch, te = (
            (pcluster, pruntime, ptorchjob, pfailover, pscheduler, ptesting)
            if port else
            (rcluster, rruntime, rtpujob, rfailover, rscheduler, rtesting))
        self.cluster = cl.InMemoryCluster()
        self.manager = rt.Manager()
        self.gang = (None if spec["gang"] is None else
                     sch.SliceGangScheduler(self.cluster, per_role=spec["gang"]))
        self.admission = sch.SliceGangAdmission(self.cluster)
        setup = (tj.setup_torchjob_controller if port
                 else tj.setup_tpujob_controller)
        self.engine = setup(
            self.cluster, self.manager, gang_scheduler=self.gang,
            restarter=fo.InMemoryRestarter() if spec["restarter"] else None)
        # both draw the same host ports
        self.engine.port_allocator._rng = random.Random(spec["seed"])
        self.sim = te.KubeletSim(self.cluster)
        self.kinds = ([presources.by_kind(k).cls for k in (
            "Pod", "Service", "PodGroup", "Event")] if port else
            [rcore.Pod, rcore.Service, rscheduler.PodGroup, rcore.Event])
        self.job_cls = TorchJob if port else rtypes.TPUJob
        job = ref_job(spec)
        if port:
            job = pserde.from_dict(TorchJob, to_port_wire(
                rserde.to_dict(job, drop_none=False, wire=True)))
        tj.submit_job(self.cluster, job)
        self.name = job.metadata.name

    def settle(self) -> None:
        self.manager.run_until_idle()
        if self.gang is not None:
            self.admission.sync()
            self.manager.run_until_idle()

    def snapshot(self) -> dict:
        serde = pserde if self.port else rserde
        out = {}
        for cls in self.kinds:
            objs = sorted(self.cluster.list(cls, "default"),
                          key=lambda o: o.metadata.name)
            out[cls.kind] = [serde.to_dict(o, drop_none=False, wire=True)
                             for o in objs]
        job = self.cluster.try_get(self.job_cls, "default", self.name)
        out["status"] = (None if job is None else
                         serde.to_dict(job.status, drop_none=False, wire=True))
        out = _stamped(out)
        return out if self.port else self._as_port(out)

    def _as_port(self, snap: dict) -> dict:
        """The reference's snapshot in the port's vocabulary."""
        snap = to_port_wire(snap)
        ref_slice = f"{REF_ACCELERATOR}/{self.spec['topology']}"
        port_slice = (f"{PORT_ACCELERATOR}/"
                      f"{port_topology(REF_ACCELERATOR, self.spec['topology'])}")
        # the slice and the kind as messages spell them
        snap = _map_strings(snap, lambda s: s.replace(ref_slice, port_slice)
                            .replace(RC.KIND_TPUJOB, constants.KIND_TORCHJOB))
        for pod in snap["Pod"]:
            spec = pod["spec"]
            spec["nodeSelector"].pop(RC.NODE_SELECTOR_TPU_TOPOLOGY, None)
            spec["volumes"] = [v for v in spec["volumes"]
                               if v["name"] != RC.COMPILE_CACHE_VOLUME]
            for c in spec["containers"] + spec["initContainers"]:
                c["volumeMounts"] = [m for m in c["volumeMounts"]
                                     if m["name"] != RC.COMPILE_CACHE_VOLUME]
                c["env"] = _as_torch_env(c["env"])
                c["args"] = [a.replace(f"{RC.ARG_RDZV_BACKEND}=xla",
                                       f"{RC.ARG_RDZV_BACKEND}=c10d")
                             for a in c["args"]]
                for res in (c["resources"]["requests"], c["resources"]["limits"]):
                    if constants.RESOURCE_GPU in res:
                        res[constants.RESOURCE_GPU] *= GPU_SCALE
        for pg in snap["PodGroup"]:
            res = pg["spec"]["minResources"]
            if constants.RESOURCE_GPU in res:
                res[constants.RESOURCE_GPU] *= GPU_SCALE
        return snap


def _map_strings(x, fn):
    if isinstance(x, dict):
        return {k: _map_strings(v, fn) for k, v in x.items()}
    if isinstance(x, list):
        return [_map_strings(v, fn) for v in x]
    return fn(x) if isinstance(x, str) else x


def _stamped(x):
    """Clock stamps reduced to set / unset (the two controllers run at
    different instants)."""
    if isinstance(x, dict):
        return {k: ((v is not None) if k.endswith(_STAMP_KEYS) or k ==
                    constants.ANNOTATION_LAST_FAILOVER_TIMESTAMP
                    or k == RC.ANNOTATION_LAST_FAILOVER_TIMESTAMP
                    else _stamped(v)) for k, v in x.items()}
    if isinstance(x, list):
        return [_stamped(v) for v in x]
    return x


def _as_torch_env(env: list) -> list:
    """The reference's env (already mapped) as the port writes it: the
    coordinator's host:port split into MASTER_ADDR and MASTER_PORT in its
    place, the TPU names the port drops left out."""
    out = []
    for e in env:
        if e["name"] == RC.ENV_COORDINATOR_ADDRESS:
            host, _, port = e["value"].rpartition(":")
            out.append({**e, "name": constants.ENV_MASTER_ADDR, "value": host})
            out.append({**e, "name": constants.ENV_MASTER_PORT, "value": port})
        elif e["name"] not in TPU_ENV:
            out.append(e)
    return out


def run_script(side: Side) -> list:
    """The same KubeletSim outcomes on either side; a snapshot after each."""
    snaps = []
    side.settle()
    snaps.append(side.snapshot())
    for _ in range(2):
        side.sim.run_all("default")
        side.settle()
    snaps.append(side.snapshot())
    job = side.name
    for task, index, code, reason in side.spec["failures"]:
        name = f"{job}-{task}-{index if task == 'worker' else 0}"
        pod = side.cluster.try_get(side.kinds[0], "default", name)
        if pod is None or pod.status.phase != "Running":
            continue
        side.sim.fail_pod("default", name, exit_code=code, reason=reason)
        side.settle()
        snaps.append(side.snapshot())
        side.sim.run_all("default")
        side.settle()
        snaps.append(side.snapshot())
    for pod in sorted(side.cluster.list(side.kinds[0], "default"),
                      key=lambda p: p.metadata.name):
        if pod.status.phase == "Running":
            side.sim.succeed_pod("default", pod.metadata.name)
    side.settle()
    snaps.append(side.snapshot())
    return snaps


SEEDS = list(range(34))
BIG = {  # the largest legal slice: 64 hosts of 8 GPUs
    "64x8-master-63-workers": dict(
        seed=1000, topology="16x16", num_slices=1, master=True, workers=63,
        gang=None, elastic="none", hostnetwork=False, spot=0,
        master_policy=None, worker_policy=rtypes.RestartPolicy.ON_EXIT_CODE,
        restarter=False, ttl=None, backoff=None,
        failures=[("worker", 62, 137, "OOMKilled")]),
    "64x8-gang-64-workers": dict(
        seed=1001, topology="16x16", num_slices=1, master=False, workers=64,
        gang=True, elastic="none", hostnetwork=True, spot=8,
        master_policy=None, worker_policy=rtypes.RestartPolicy.ON_EXIT_CODE,
        restarter=True, ttl=0, backoff=None,
        failures=[("worker", 7, 1, "Error")]),
}


def test_big_cases_are_the_largest_legal_slice():
    for spec in BIG.values():
        assert port_topology(REF_ACCELERATOR, spec["topology"]) == "64x8"
        assert rtopology.hosts_per_slice(REF_ACCELERATOR, spec["topology"]) == 64


@pytest.mark.parametrize("spec", [make_spec(s) for s in SEEDS] + list(BIG.values()),
                         ids=[f"seed{s}" for s in SEEDS] + list(BIG))
def test_controllers_agree_on_seeded_jobs(spec):
    ref, port = Side(False, spec), Side(True, spec)
    got, want = run_script(port), run_script(ref)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for key in w:
            assert g[key] == w[key], (spec, i, key)
    # the port's pods carry the torch.distributed env and the GPUs, and
    # none of the TPU names
    for snap in got:
        for pod in snap["Pod"]:
            main = pod["spec"]["containers"][0]
            names = {e["name"] for e in main["env"]}
            assert {constants.ENV_MASTER_ADDR, constants.ENV_MASTER_PORT,
                    constants.ENV_PROCESS_ID,
                    constants.ENV_NUM_PROCESSES} <= names
            assert not names & set(TPU_ENV)
            assert main["resources"]["requests"][constants.RESOURCE_GPU] == 8


# ---- over REST: the reference's operator flows on the port's Operator -----------

def _wait(pred, what, timeout=30):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


@pytest.fixture()
def rest_plane():
    """The port's ApiServer, and the port's ``Operator`` over a RestCluster,
    started; yields (server url, its TorchJob engine, a client factory).
    Everything stops after."""
    from tpu_on_k8s_torch.main import Operator, build_parser

    srv = ApiServer().start()
    clients = []

    def client():
        clients.append(RestCluster(srv.url))
        return clients[-1]

    op = Operator(build_parser().parse_args(
        ["--cluster-backend", "rest", "--api-server", srv.url,
         "--no-leader-elect", "--coordinator-period-seconds", "0.02"]),
        cluster=client())
    op.start()
    try:
        yield srv.url, op.engine, client
    finally:
        op.stop()
        for c in clients:
            c.close()
        srv.stop()


def _rest_job(name, workers, master=True, topology="2x8", annotations=None,
              **worker):
    template = PodTemplateSpec(spec=PodSpec(containers=[
        pcore.Container(name="torch", image="i")]))
    tasks = {TaskType.WORKER: TaskSpec(num_tasks=workers, template=template,
                                       **worker)}
    if master:
        tasks[TaskType.MASTER] = TaskSpec(num_tasks=1, template=template)
    return TorchJob(
        metadata=pcore.ObjectMeta(name=name, annotations=annotations or {}),
        spec=TorchJobSpec(tasks=tasks, gpu_policy=GPUPolicy(
            accelerator=PORT_ACCELERATOR, topology=topology)))


def test_full_torchjob_lifecycle_over_rest(rest_plane):
    """``test_rest_backend.py::test_full_tpujob_lifecycle_over_rest`` with
    TTL cleanup: submit, run, succeed and reap one job over HTTP, the
    kubelet simulated on a second connection; the torch.distributed env
    was written on the wire."""
    _, _, client = rest_plane
    user, kubelet = client(), client()
    sim = ptesting.KubeletSim(kubelet)
    job = _rest_job("wire", 2)
    job.spec.run_policy.ttl_seconds_after_finished = 0
    job.spec.run_policy.clean_pod_policy = CleanPodPolicy.NONE
    ptorchjob.submit_job(user, job)
    env = {}

    def step():
        sim.run_all("default")
        pods = kubelet.list(pcore.Pod, "default")
        if len(pods) == 3 and all(p.status.phase == PodPhase.RUNNING
                                  for p in pods):
            worker = kubelet.get(pcore.Pod, "default", "wire-worker-0")
            env.update({e.name: e.value for e in worker.spec.containers[0].env
                        if e.value is not None})
            for p in pods:
                sim.succeed_pod("default", p.metadata.name)
        return env and kubelet.try_get(TorchJob, "default", "wire") is None

    _wait(step, "the job to succeed and be reaped by its TTL")
    assert env[constants.ENV_PROCESS_ID] == "1"        # rank shifted past master
    assert env[constants.ENV_NUM_PROCESSES] == "3"
    assert env[constants.ENV_MASTER_ADDR] == "wire-master-0.default"
    assert env[constants.ENV_MASTER_PORT] == str(constants.DEFAULT_COORDINATOR_PORT)
    _wait(lambda: not kubelet.list(pcore.Pod, "default"), "cascade GC")


def test_hostnetwork_ports_allocate_and_release_over_rest(rest_plane):
    """``test_hostnetwork_spot_over_rest.py``'s hostnetwork case: two jobs
    draw distinct host ports; deleting one releases its port through the
    DELETED watch event."""
    url, engine, client = rest_plane
    kubelet = ptesting.KubeletLoop(client()).start()
    user = client()
    host = {constants.ANNOTATION_NETWORK_MODE: constants.NETWORK_MODE_HOST}
    try:
        ports = []
        for name in ("hn-a", "hn-b"):
            ptorchjob.submit_job(user, _rest_job(name, 1, master=False,
                                                 topology="1x1", annotations=host))
            pod = f"{name}-worker-0"
            _wait(lambda: user.try_get(pcore.Pod, "default", pod) is not None, pod)
            got = user.get(pcore.Pod, "default", pod)
            assert got.spec.host_network
            ports.append(got.spec.containers[0].ports[0].container_port)
        assert 20000 <= min(ports) and max(ports) < 30000
        assert ports[0] != ports[1]
        user.delete(TorchJob, "default", "hn-a")
        _wait(lambda: user.try_get(pcore.Pod, "default", "hn-a-worker-0") is None,
              "hn-a pod gone")
        _wait(lambda: engine.port_allocator.in_use_count() == 1,
              "port released on DELETED event")
    finally:
        kubelet.stop()


def test_spot_task_spec_round_trips_and_applies_over_rest(rest_plane):
    """``test_hostnetwork_spot_over_rest.py``'s spot case: the SpotTaskSpec
    survives the camelCase round trip and the trailing replicas run at
    spot priority."""
    _, _, client = rest_plane
    user = client()
    ptorchjob.submit_job(user, _rest_job(
        "spotty", 4, master=False, spot_task_spec=SpotTaskSpec(
            num_spot_tasks=2, priority_class_name="spot-priority",
            labels={"capacity-type": "spot"})))
    spot = user.get(TorchJob, "default", "spotty").spec.tasks[
        TaskType.WORKER].spot_task_spec
    assert (spot.num_spot_tasks, spot.priority_class_name) == (2, "spot-priority")

    def pods():
        return [p for p in user.list(pcore.Pod)
                if p.metadata.labels.get(constants.LABEL_JOB_NAME) == "spotty"]

    _wait(lambda: len(pods()) == 4, "4 worker pods")
    spot_pods = sorted(p.metadata.name for p in pods()
                       if p.spec.priority_class_name == "spot-priority")
    assert spot_pods == ["spotty-worker-2", "spotty-worker-3"]
    for p in pods():
        assert (p.metadata.labels.get("capacity-type") == "spot") == (
            p.metadata.name in spot_pods)
