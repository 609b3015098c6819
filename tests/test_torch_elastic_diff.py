"""The port's elastic machinery against the reference's, job for job, on the
CPU.

A seeded differential builds 30 elastic jobs with numpy (the host count and
``num_slices``, so the worker count, a master or none, min and max, then
what happens to the job: preempted victims and the checkpoint round, a user
respec, or four windows of step-time observations for the autoscaler) and
runs each through both packages on their ``InMemoryCluster``s under the
same ``KubeletSim`` outcomes: the job controller with an
``ElasticController`` and ``InMemoryRestarter``, and the elastic
autoscaler on a ``DecisionLedger`` of one fake clock. After every step the
job's spec, generation, annotations and elastic status, every pod's labels
(the generation among them), annotations, finalizers, phase, env, args and
node selector, the event reasons, and the autoscaler's decision lines and
ledger lines are equal under ``to_port_wire``, once the reference's env is
read as the torch.distributed env (``test_torch_engine._as_torch_env``).
The one mapped difference is the shape-change restart: where a respec
changes the slice's topology the reference recreates the survivors and
the port restarts them in place, so the restart stamps and the recreate's
events are set aside, and the port's survivors must carry
``elastic-restarts``. A further case preempts half of a ``64x8`` job (64
hosts), which lands on ``32x8``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from test_torch_api import REF_ACCELERATOR, port_topology, to_port_wire
from test_torch_engine import TPU_ENV, _as_torch_env
from tpu_on_k8s.api import constants as RC
from tpu_on_k8s.api import core as rcore
from tpu_on_k8s.api import types as rtypes
from tpu_on_k8s.client import cluster as rcluster
from tpu_on_k8s.client import testing as rtesting
from tpu_on_k8s.controller import autoscaler as rautoscaler
from tpu_on_k8s.controller import elastic as relastic
from tpu_on_k8s.controller import failover as rfailover
from tpu_on_k8s.controller import runtime as rruntime
from tpu_on_k8s.controller import tpujob as rtpujob
from tpu_on_k8s.gang import topology as rtopology
from tpu_on_k8s.obs import ledger as rledger
from tpu_on_k8s.utils import serde as rserde
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Event, Pod
from tpu_on_k8s_torch.api.types import TorchJob
from tpu_on_k8s_torch.client import cluster as pcluster
from tpu_on_k8s_torch.client import testing as ptesting
from tpu_on_k8s_torch.controller import autoscaler as pautoscaler
from tpu_on_k8s_torch.controller import elastic as pelastic
from tpu_on_k8s_torch.controller import failover as pfailover
from tpu_on_k8s_torch.controller import runtime as pruntime
from tpu_on_k8s_torch.controller import torchjob as ptorchjob
from tpu_on_k8s_torch.obs.ledger import DecisionLedger
from tpu_on_k8s_torch.utils import serde as pserde

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)


# ---- the seeded differential ----------------------------------------------------

SCENARIOS = ("preempt", "respec", "observe")


def make_spec(seed: int) -> dict:
    """One elastic job and what happens to it, from a seeded generator."""
    rng = np.random.default_rng(seed)
    topos = [t for t in rtopology.legal_topologies(REF_ACCELERATOR)
             if 1 <= rtopology.hosts_per_slice(REF_ACCELERATOR, t) <= 8]
    topo = topos[int(rng.integers(len(topos)))]
    hosts = rtopology.hosts_per_slice(REF_ACCELERATOR, topo)
    num_slices = int(rng.integers(1, 3)) if hosts <= 4 else 1
    workers = hosts * num_slices
    scenario = SCENARIOS[seed % len(SCENARIOS)]
    if scenario == "preempt" and workers == 1:
        scenario = "respec"       # a preemption needs a survivor
    spec = dict(
        seed=seed, topology=topo, num_slices=num_slices, workers=workers,
        scenario=scenario,
        master=bool(rng.random() < 0.6) and scenario != "observe",
        min_replicas=int(rng.integers(1, workers + 1)),
        max_replicas=int(rng.integers(workers, 3 * workers + 1)),
        victims=sorted(int(i) for i in rng.choice(
            workers, int(rng.integers(1, workers)) if workers > 1 else 0,
            replace=False)),
        respec=int(rng.integers(1, 3 * workers + 1)),
        latencies=[round(float(rng.uniform(0.2, 3.0)), 3) for _ in range(4)])
    return spec


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        self.t += 0.25
        return self.t


def ref_job(spec: dict) -> rtypes.TPUJob:
    template = rcore.PodTemplateSpec(spec=rcore.PodSpec(containers=[
        rcore.Container(name=RC.DEFAULT_CONTAINER_NAME, image="img:1")]))
    tasks = {rtypes.TaskType.WORKER: rtypes.TaskSpec(
        num_tasks=spec["workers"], template=template)}
    if spec["master"]:
        tasks[rtypes.TaskType.MASTER] = rtypes.TaskSpec(num_tasks=1,
                                                        template=template)
    return rtypes.TPUJob(
        metadata=rcore.ObjectMeta(
            name=f"e{spec['seed']}", uid=f"job-{spec['seed']:05d}",
            annotations={RC.ANNOTATION_ENABLE_ELASTIC: "true"}),
        spec=rtypes.TPUJobSpec(
            tasks=tasks,
            elastic_policy=rtypes.ElasticPolicy(
                min_replicas=spec["min_replicas"],
                max_replicas=spec["max_replicas"]),
            tpu_policy=rtypes.TPUPolicy(accelerator=REF_ACCELERATOR,
                                        topology=spec["topology"],
                                        num_slices=spec["num_slices"])))


class Side:
    """One package's elastic machinery on its own cluster: the job
    controller with an ``ElasticController`` and an in-memory restarter,
    the elastic autoscaler on a ``DecisionLedger`` of a fake clock, and a
    ``KubeletSim``; read back in the port's vocabulary."""

    def __init__(self, port: bool, spec: dict) -> None:
        self.port, self.spec = port, spec
        cl, rt, tj, fo, el, au, te, led = (
            (pcluster, pruntime, ptorchjob, pfailover, pelastic,
             pautoscaler, ptesting, None) if port else
            (rcluster, rruntime, rtpujob, rfailover, relastic, rautoscaler,
             rtesting, rledger))
        self.cluster = cl.InMemoryCluster()
        self.manager = rt.Manager()
        restarter = fo.InMemoryRestarter()
        self.elastic = el.ElasticController(self.cluster, restarter=restarter)
        setup = (tj.setup_torchjob_controller if port
                 else tj.setup_tpujob_controller)
        setup(self.cluster, self.manager, restarter=restarter,
              elastic_controller=self.elastic)
        self.ledger = (DecisionLedger if port else led.DecisionLedger)(
            FakeClock())
        self.scaler = au.setup_elastic_autoscaler(self.cluster,
                                                  ledger=self.ledger)
        self.sim = te.KubeletSim(self.cluster)
        self.job_cls = TorchJob if port else rtypes.TPUJob
        self.pod_cls = Pod if port else rcore.Pod
        self.event_cls = Event if port else rcore.Event
        self.el = el
        job = ref_job(spec)
        if port:
            job = pserde.from_dict(TorchJob, to_port_wire(
                rserde.to_dict(job, drop_none=False, wire=True)))
        tj.submit_job(self.cluster, job)
        self.name = job.metadata.name

    def settle(self) -> None:
        for _ in range(2):
            self.manager.run_until_idle()
            self.sim.run_all("default")
        self.manager.run_until_idle()

    def job(self):
        return self.cluster.get(self.job_cls, "default", self.name)

    def preempt(self) -> None:
        for i in self.spec["victims"]:
            self.cluster.delete(self.pod_cls, "default",
                                f"{self.name}-worker-{i}")
        self.manager.run_until_idle()

    def ack(self) -> None:
        gen = self.job().metadata.annotations[
            RC.ANNOTATION_CKPT_REQUESTED_VERSION if not self.port else
            constants.ANNOTATION_CKPT_REQUESTED_VERSION]
        key = (constants.ANNOTATION_CKPT_COMPLETED_VERSION if self.port
               else RC.ANNOTATION_CKPT_COMPLETED_VERSION)
        self.cluster.patch_meta(self.job_cls, "default", self.name,
                                annotations={key: gen})

    def respec(self, hosts: int) -> None:
        self.cluster.update_with_retry(
            self.job_cls, "default", self.name,
            lambda j: self.el.apply_host_count(j, hosts))

    def observe(self, window: int, latency: float) -> None:
        for b in range(5):
            self.sim.log_line(
                "default", f"{self.name}-worker-0",
                f"[elastic-metrics] epoch=1 batch={window * 5 + b} "
                f"latency={latency} accuracy=0.9")
        self.scaler.run_once()

    def snapshot(self) -> dict:
        serde = pserde if self.port else rserde
        job = self.job()
        pods = {}
        for p in self.cluster.list(self.pod_cls, "default"):
            main = serde.to_dict(p.spec.containers[0], drop_none=False,
                                 wire=True)
            pods[p.metadata.name] = dict(
                uid=p.metadata.uid, labels=dict(p.metadata.labels),
                annotations=dict(p.metadata.annotations),
                finalizers=list(p.metadata.finalizers),
                deleting=p.metadata.deletion_timestamp is not None,
                phase=str(getattr(p.status.phase, "value", p.status.phase)),
                env=main["env"], args=main["args"],
                node_selector=dict(p.spec.node_selector))
        events = [e.reason for e in sorted(
            self.cluster.list(self.event_cls, "default"),
            key=lambda e: e.metadata.name)]
        out = dict(
            spec=serde.to_dict(job.spec, drop_none=False, wire=True),
            generation=job.metadata.generation,
            annotations=dict(job.metadata.annotations),
            elastic=serde.to_dict(job.status.elastic_statuses,
                                  drop_none=False, wire=True),
            pods=pods, events=events,
            decisions=list(self.scaler.decision_log),
            ledger=self.ledger.lines())
        return out if self.port else self._as_port(out)

    def _as_port(self, snap: dict) -> dict:
        snap = to_port_wire(snap)
        for pod in snap["pods"].values():
            pod["node_selector"].pop(RC.NODE_SELECTOR_TPU_TOPOLOGY, None)
            pod["env"] = _as_torch_env(pod["env"])
            pod["args"] = [a.replace(f"{RC.ARG_RDZV_BACKEND}=xla",
                                     f"{RC.ARG_RDZV_BACKEND}=c10d")
                           for a in pod["args"]]
        return snap


def run_script(side: Side) -> list:
    snaps = []
    side.settle()
    snaps.append(side.snapshot())
    kind = side.spec["scenario"]
    if kind == "preempt":
        side.preempt()
        snaps.append(side.snapshot())
        side.ack()
        side.settle()
    elif kind == "respec":
        side.respec(side.spec["respec"])
        side.settle()
    else:
        for window, latency in enumerate(side.spec["latencies"]):
            side.observe(window, latency)
            side.settle()
            snaps.append(side.snapshot())
    snaps.append(side.snapshot())
    return snaps


#: what the shape-change restart changes on a survivor: the reference
#: recreates it (a new pod, restarted 0 times, no respec stamp); the port
#: restarts it in place, and stamps both
_RESTART_STAMPS = (constants.ANNOTATION_ELASTIC_RESTARTS,
                   constants.ANNOTATION_RESPEC_GENERATION)
#: the reference's events of a recreate, which an in-place restart has not
_RECREATE_EVENTS = ("SuccessfulDeletePod", "SuccessfulCreatePod",
                    "FailoverRecreate")


def _shape_changed(snaps) -> bool:
    topo = {s["spec"]["gpuPolicy"]["topology"] for s in snaps}
    return len(topo) > 1


def _comparable(snap: dict, restarted: bool) -> dict:
    """A snapshot without the pods' uids (each cluster mints its own), and
    after a shape change without what the restart changes."""
    out = dict(snap, pods={})
    for name, pod in snap["pods"].items():
        pod = {k: v for k, v in pod.items() if k != "uid"}
        if restarted:
            pod["annotations"] = {k: v for k, v in pod["annotations"].items()
                                  if k not in _RESTART_STAMPS}
        out["pods"][name] = pod
    if restarted:
        out["events"] = [e for e in snap["events"]
                         if e not in _RECREATE_EVENTS]
    return out


SEEDS = list(range(30))
BIG = dict(  # 64 hosts of 8 GPUs preempted down to 32
    seed=1000, topology="16x16", num_slices=1, workers=64,
    scenario="preempt", master=True, min_replicas=1, max_replicas=64,
    victims=list(range(32, 64)), respec=32, latencies=[])


def test_big_case_is_64x8_to_32x8():
    assert port_topology(REF_ACCELERATOR, BIG["topology"]) == "64x8"
    assert port_topology(REF_ACCELERATOR, "8x16") == "32x8"


@pytest.mark.parametrize("spec", [make_spec(s) for s in SEEDS] + [BIG],
                         ids=[f"seed{s}" for s in SEEDS] + ["64x8-to-32x8"])
def test_elastic_machinery_agrees_on_seeded_jobs(spec):
    ref, port = Side(False, spec), Side(True, spec)
    got, want = run_script(port), run_script(ref)
    assert len(got) == len(want)
    restarted = _shape_changed(got)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _comparable(g, restarted), _comparable(w, restarted)
        for key in w:
            assert g[key] == w[key], (spec, i, key)
    final = got[-1]
    if spec is BIG:
        assert final["spec"]["gpuPolicy"]["topology"] == "32x8"
        assert final["spec"]["tasks"]["Worker"]["numTasks"] == 32
    # the post-scale world in the port's pods: the torch.distributed env and
    # none of the TPU names; survivors of a shape change restarted in place
    world = sum(t["numTasks"] for t in final["spec"]["tasks"].values())
    gen = str(final["generation"])
    survivors = {p["uid"] for p in got[0]["pods"].values()}
    for name, pod in final["pods"].items():
        names = {e["name"] for e in pod["env"]}
        assert {constants.ENV_MASTER_ADDR, constants.ENV_MASTER_PORT,
                constants.ENV_PROCESS_ID,
                constants.ENV_NUM_PROCESSES} <= names
        assert not names & set(TPU_ENV)
        assert pod["annotations"][constants.ANNOTATION_WORLD_SIZE] == str(world)
        assert pod["labels"][constants.LABEL_JOB_GENERATION] == gen
        if restarted and pod["uid"] in survivors:
            assert int(pod["annotations"][
                constants.ANNOTATION_ELASTIC_RESTARTS]) >= 1, name
