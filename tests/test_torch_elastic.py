"""The port's elasticity (``controller/elastic.py``) against the reference on
the CPU.

* ``tests/test_elastic.py`` runs against the port through
  ``test_torch_api.reference_cases``, its slice literals mapped by host
  count. Two of its cases change the slice's shape (8 → 4 and 8 → 2 hosts).
  The reference recreates every survivor there, since a TPU slice's
  topology is a node selector; the GPU flavour restarts the survivors in
  place with the post-scale ``RANK``, ``WORLD_SIZE`` annotation and
  ``MASTER_ADDR``, as the operator this was modelled on does for every
  rescale. ``test_full_checkpoint_rescale_cycle`` fails under the map and
  is replaced by its twin here; ``test_user_rescale_without_checkpoint_round_proceeds``
  passes as it is and gets a twin that also asserts the in-place restart.
  ``test_same_topology_rescale_restarts_in_place_with_fresh_env`` reads
  ``TPU_WORKER_HOSTNAMES``; its twin reads the torch.distributed env.
* ``tests/test_elastic_over_rest.py``'s flow runs on a ``Manager`` wired
  by hand (``HandWired``): the reference's case builds
  ``tpu_on_k8s.main.Operator``, the operator's entry point, which the port
  has not yet. Its respec changes the slice's shape (8 → 4 hosts), so the
  survivors restart in place through ``ContainerRecreateRequest``s, and
  the twin runs the node agent that executes them beside the kubelet. The
  other operator-plane test files take ``HandWired`` from here.
* The seeded differential of both packages' elastic machinery is in
  ``tests/test_torch_elastic_diff.py``.
* The elastic story (``tests/test_elastic_story.py``) is in
  ``tests/test_torch_elastic_story.py``.
"""
from __future__ import annotations

import argparse
import functools
import sys

import torch

from test_torch_api import PORT_ACCELERATOR, reference_cases, slice_literals
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Pod
from tpu_on_k8s_torch.api.types import TaskType, TorchJob
from tpu_on_k8s_torch.client import InMemoryCluster
from tpu_on_k8s_torch.controller.autoscaler import setup_elastic_autoscaler
from tpu_on_k8s_torch.controller.config import JobControllerConfig
from tpu_on_k8s_torch.controller.elastic import ElasticController, apply_host_count
from tpu_on_k8s_torch.controller.failover import CRRRestarter, InMemoryRestarter
from tpu_on_k8s_torch.controller.modelversion import setup_modelversion_controller
from tpu_on_k8s_torch.controller.runtime import Manager
from tpu_on_k8s_torch.controller.torchjob import setup_torchjob_controller
from tpu_on_k8s_torch.obs.ledger import DecisionLedger
from tpu_on_k8s_torch.train.checkpoint import CheckpointAgent

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)


# ---- the operator, wired by hand -------------------------------------------

def operator_flags() -> argparse.ArgumentParser:
    """The flags of the operator's entry point that the reference's REST
    cases pass, with the reference's defaults."""
    p = argparse.ArgumentParser()
    p.add_argument("--cluster-backend", default="auto")
    p.add_argument("--api-server", default="")
    p.add_argument("--no-leader-elect", dest="leader_elect",
                   action="store_false")
    p.add_argument("--crr-wait-seconds", type=float, default=60.0)
    p.add_argument("--elastic-loop-period-seconds", type=float, default=30.0)
    return p


class HandWired:
    """What the operator's entry point wires for 6c's flows, on a
    ``Manager`` by hand: the TorchJob controller with an
    ``ElasticController``, ``CRRRestarter`` on a REST cluster and
    ``InMemoryRestarter`` on an in-memory one (the reference's
    ``build_restarter``), the elastic autoscaler on one ``DecisionLedger``,
    and the ModelVersion controller. ``start``/``stop`` or ``run_once``."""

    def __init__(self, args: argparse.Namespace, cluster=None) -> None:
        self.cluster = cluster if cluster is not None else InMemoryCluster()
        self.manager = Manager()
        self.config = JobControllerConfig(
            elastic_loop_period_seconds=args.elastic_loop_period_seconds)
        rest = not isinstance(self.cluster, InMemoryCluster)
        restarter = (CRRRestarter(self.cluster,
                                  wait_seconds=args.crr_wait_seconds)
                     if rest else InMemoryRestarter())
        self.elastic = ElasticController(self.cluster, restarter=restarter)
        self.engine = setup_torchjob_controller(
            self.cluster, self.manager, config=self.config,
            restarter=restarter, elastic_controller=self.elastic)
        self.ledger = DecisionLedger()
        self.autoscaler = setup_elastic_autoscaler(
            self.cluster, config=self.config, ledger=self.ledger)
        self.modelversion = setup_modelversion_controller(
            self.cluster, self.manager, config=self.config)

    def run_once(self) -> int:
        return self.manager.run_until_idle()

    def start(self) -> None:
        self.manager.start(
            workers_per_controller=self.config.max_concurrent_reconciles)
        self.autoscaler.run()

    def stop(self) -> None:
        self.autoscaler.stop()
        self.manager.stop()
        close = getattr(self.cluster, "close", None)
        if callable(close):
            close()


#: the port's agent over the port's job kind
TorchJobCheckpointAgent = functools.partial(CheckpointAgent, job_cls=TorchJob)

#: a reference line that imports the operator's entry point or the agent,
#: resolved in the hand-wired stand-ins here
HAND_WIRED = (
    (r"from tpu_on_k8s_torch\.main import Operator, build_parser",
     "from test_torch_elastic import HandWired as Operator, "
     "operator_flags as build_parser"),
    (r"from tpu_on_k8s_torch\.train\.checkpoint import CheckpointAgent",
     "from test_torch_elastic import TorchJobCheckpointAgent as "
     "CheckpointAgent"),
)


def port_module(ref: str) -> str:
    """A reference line importing another reference test module, resolved
    in its run against the port (loaded by ``reference_cases`` first)."""
    return (rf"from tests\.{ref} import", f"from _port_{ref} import")


# ---- tests/test_elastic.py against the port ------------------------------------

#: the reference's cases that fail under the map -> their twins here
TWINS = {
    "TestPreemptionProtocol.test_full_checkpoint_rescale_cycle":
        "test_full_checkpoint_rescale_cycle_restarts_in_place",
    "TestPreemptionProtocol.test_same_topology_rescale_restarts_in_place_with_fresh_env":
        "test_same_topology_rescale_restarts_in_place_with_torch_env",
}

globals().update(reference_cases("test_elastic", skip=tuple(TWINS),
                                 subs=(slice_literals,)))
EL = sys.modules["_port_test_elastic"]


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestApplyHostCount", "TestPreemptionProtocol"} <= names
    for case, twin in TWINS.items():
        cls, meth = case.split(".")
        assert not hasattr(globals()[cls], meth), case
        assert twin in names, twin
    assert hasattr(TestPreemptionProtocol,
                   "test_user_rescale_without_checkpoint_round_proceeds")


def _pods(cluster, job):
    return {p.metadata.name: p for p in cluster.list(
        Pod, "default", {constants.LABEL_JOB_NAME: job})}


def _assert_torch_env(pods, job, world, uids=None):
    """Every pod of a post-scale world: restarted in place once (its uid
    unchanged), the accelerator its only node selector, the world size in
    the annotation ``WORLD_SIZE`` reads, and ``RANK`` / ``MASTER_ADDR`` of
    the new world (the master's own rank 0 on localhost)."""
    for name, p in pods.items():
        if uids is not None:
            assert p.metadata.uid == uids[name], name
        assert p.metadata.annotations[constants.ANNOTATION_ELASTIC_RESTARTS] == "1"
        assert p.spec.node_selector == {
            constants.NODE_SELECTOR_GPU_ACCELERATOR: PORT_ACCELERATOR}
        assert p.metadata.annotations[constants.ANNOTATION_WORLD_SIZE] == str(world)
        env = p.spec.containers[0].env_map()
        [ws] = [e for e in p.spec.containers[0].env
                if e.name == constants.ENV_NUM_PROCESSES]
        assert constants.ANNOTATION_WORLD_SIZE in ws.value_from.field_path
        index = int(p.metadata.labels[constants.LABEL_TASK_INDEX])
        if "master" in name:
            assert env[constants.ENV_PROCESS_ID] == "0"
            assert env[constants.ENV_MASTER_ADDR] == "localhost"
        else:
            assert env[constants.ENV_PROCESS_ID] == str(index + 1)
            assert env[constants.ENV_MASTER_ADDR] == f"{job}-master-0.default"
        assert env[constants.ENV_MASTER_PORT] == str(
            constants.DEFAULT_COORDINATOR_PORT)


def test_full_checkpoint_rescale_cycle_restarts_in_place():
    """``test_full_checkpoint_rescale_cycle`` in the GPU flavour: the respec
    shrinks the slice from 8 hosts (``8x8``) to 4 (``4x8``), and every
    survivor restarts in place with the post-scale env instead of being
    recreated on a new node pool. Every other assertion is the
    reference's."""
    cluster, manager, engine, sim, elastic = EL.make_env()
    EL.start_running(cluster, manager, sim)
    pods = cluster.list(Pod, "default", {constants.LABEL_JOB_NAME: "ej"})
    assert len(pods) == 9
    workers = sorted((p for p in pods if "worker" in p.metadata.name),
                     key=lambda p: p.metadata.name)
    for p in workers:
        assert p.metadata.labels[constants.LABEL_JOB_GENERATION] == "1"
        assert constants.FINALIZER_PREEMPT_PROTECTOR in p.metadata.finalizers
    uids = {p.metadata.name: p.metadata.uid for p in pods}

    for p in workers[4:]:
        cluster.delete(Pod, "default", p.metadata.name)
    manager.run_until_idle()
    job = cluster.get(TorchJob, "default", "ej")
    assert job.metadata.annotations[
        constants.ANNOTATION_CKPT_REQUESTED_VERSION] == "1"
    assert len(cluster.list(Pod, "default",
                            {constants.LABEL_JOB_NAME: "ej"})) == 9

    cluster.patch_meta(TorchJob, "default", "ej", annotations={
        constants.ANNOTATION_CKPT_COMPLETED_VERSION: "1"})
    manager.run_until_idle()

    job = cluster.get(TorchJob, "default", "ej")
    assert job.spec.tasks[TaskType.WORKER].num_tasks == 4
    assert job.spec.gpu_policy.topology == "4x8"
    assert job.metadata.generation == 2
    sim.run_pod("default", "ej-master-0")
    manager.run_until_idle()
    pods = _pods(cluster, "ej")
    assert len([n for n in pods if "worker" in n]) == 4
    for p in pods.values():
        assert p.metadata.labels[constants.LABEL_JOB_GENERATION] == "2"
    _assert_torch_env(pods, "ej", world=5, uids=uids)
    job = cluster.get(TorchJob, "default", "ej")
    assert job.metadata.annotations.get(
        constants.ANNOTATION_SCALE_STATE) == constants.SCALE_STATE_DONE
    assert constants.ANNOTATION_READY_TO_START_WORKER not in job.metadata.annotations


def test_user_rescale_without_checkpoint_round_proceeds_in_place():
    """``test_user_rescale_without_checkpoint_round_proceeds`` (8 → 2 hosts,
    ``8x8`` → ``2x8``), asserting the in-place restart of the master and
    the two surviving workers with the post-scale env."""
    cluster, manager, engine, sim, elastic = EL.make_env()
    EL.start_running(cluster, manager, sim)
    uids = {n: p.metadata.uid for n, p in _pods(cluster, "ej").items()}

    def mutate(j):
        apply_host_count(j, 2)
    cluster.update_with_retry(TorchJob, "default", "ej", mutate)
    manager.run_until_idle()
    sim.run_pod("default", "ej-master-0")
    manager.run_until_idle()
    pods = _pods(cluster, "ej")
    workers = [p for n, p in pods.items() if "worker" in n]
    assert len(workers) == 2
    assert all(p.metadata.labels[constants.LABEL_JOB_GENERATION] == "2"
               for p in pods.values())
    assert cluster.get(TorchJob, "default", "ej").spec.gpu_policy.topology == "2x8"
    _assert_torch_env(pods, "ej", world=3, uids=uids)


def test_same_topology_rescale_restarts_in_place_with_torch_env():
    """``test_same_topology_rescale_restarts_in_place_with_fresh_env`` with
    the torch.distributed env for ``TPU_WORKER_HOSTNAMES``: two slices of 8
    hosts drop to one, and the 8 survivors restart in place as ranks 1-8 of
    a world of 9 behind the master."""
    from tpu_on_k8s_torch.utils import conditions as cond

    cluster = InMemoryCluster()
    manager = Manager()
    restarter = InMemoryRestarter()
    elastic = ElasticController(cluster, restarter=restarter)
    engine = setup_torchjob_controller(cluster, manager, restarter=restarter,
                                       elastic_controller=elastic)
    sim = EL.KubeletSim(cluster)
    job = EL.elastic_job(workers=16, name="ms", min_replicas=2, max_replicas=32)
    job.spec.gpu_policy.num_slices = 2
    job.spec.run_policy.backoff_limit = 3
    EL.submit_job(cluster, job)
    manager.run_until_idle()
    sim.run_pod("default", "ms-master-0")
    manager.run_until_idle()
    sim.run_all("default")
    manager.run_until_idle()

    workers = sorted((p for p in cluster.list(Pod, "default")
                      if "worker" in p.metadata.name),
                     key=lambda p: int(p.metadata.labels[constants.LABEL_TASK_INDEX]))
    assert len(workers) == 16
    for p in workers[8:]:
        cluster.delete(Pod, "default", p.metadata.name)
    manager.run_until_idle()
    cluster.patch_meta(TorchJob, "default", "ms", annotations={
        constants.ANNOTATION_CKPT_COMPLETED_VERSION: "1"})
    manager.run_until_idle()

    job = cluster.get(TorchJob, "default", "ms")
    assert job.spec.gpu_policy.num_slices == 1
    assert job.spec.gpu_policy.topology == "8x8"  # unchanged shape
    assert job.spec.tasks[TaskType.WORKER].num_tasks == 8
    pods = cluster.list(Pod, "default", {constants.LABEL_JOB_NAME: "ms"})
    survivors = {p.metadata.name: p for p in pods if "worker" in p.metadata.name}
    assert len(survivors) == 8
    for p in survivors.values():
        assert all(cs.restart_count == 1 for cs in p.status.container_statuses)
    _assert_torch_env(survivors, "ms", world=9)
    assert engine.restart_count(job, pods) == 0
    assert not cond.is_failed(cluster.get(TorchJob, "default", "ms").status)


def test_preemption_checkpoint_rescale_over_rest_restarts_in_place():
    """``test_preemption_checkpoint_rescale_over_rest`` with the node agent:
    the controller, the checkpoint agent, the kubelet, the node agent and
    the user each on their own ``RestCluster``. Six of 8 workers survive
    the preemption, the respec snaps them to 4 (``4x8``), and the 4 kept
    restart in place through CRRs the node agent executes. Every other
    assertion is the reference's."""
    import time

    from tpu_on_k8s_torch.api.core import PodPhase
    from tpu_on_k8s_torch.client import KubeletLoop
    from tpu_on_k8s_torch.client.apiserver import ApiServer
    from tpu_on_k8s_torch.client.nodeagent import NodeAgentLoop
    from tpu_on_k8s_torch.client.rest import RestCluster
    from tpu_on_k8s_torch.controller.torchjob import submit_job

    srv = ApiServer().start()
    op = HandWired(operator_flags().parse_args(
        ["--cluster-backend", "rest", "--api-server", srv.url,
         "--no-leader-elect", "--crr-wait-seconds", "10"]),
        cluster=RestCluster(srv.url))
    op.start()
    kubelet_client = RestCluster(srv.url)
    kubelet = KubeletLoop(kubelet_client).start()
    agent_node_client = RestCluster(srv.url)
    node_agent = NodeAgentLoop(agent_node_client).start()
    agent_client = RestCluster(srv.url)
    saved = []
    agent = TorchJobCheckpointAgent(agent_client, "default", "story",
                                    lambda gen: saved.append(gen))
    user = RestCluster(srv.url)
    try:
        submit_job(user, EL.elastic_job(name="story"))  # 8 workers, 8x8

        def wait(pred, what, timeout=30):
            deadline = time.time() + timeout
            while time.time() < deadline:
                if pred():
                    return
                time.sleep(0.05)
            raise AssertionError(f"timed out waiting for {what}")

        def workers():
            return [p for p in user.list(Pod)
                    if p.metadata.labels.get(constants.LABEL_TASK_TYPE)
                    == "worker"]

        wait(lambda: len([p for p in workers()
                          if p.status.phase == PodPhase.RUNNING]) == 8,
             "8 running workers")
        gen0 = user.get(TorchJob, "default", "story").metadata.generation
        uids = {p.metadata.name: p.metadata.uid for p in user.list(Pod)}

        for name in ("story-worker-6", "story-worker-7"):
            pod = user.get(Pod, "default", name)
            assert constants.FINALIZER_PREEMPT_PROTECTOR in pod.metadata.finalizers
            user.delete(Pod, "default", name)

        def requested():
            job = user.get(TorchJob, "default", "story")
            return job.metadata.annotations.get(
                constants.ANNOTATION_CKPT_REQUESTED_VERSION)

        wait(lambda: requested() is not None, "checkpoint request annotation")
        req_gen = int(requested())
        wait(lambda: agent.poll_once() is not None, "agent ack", timeout=10)
        assert saved == [req_gen]

        wait(lambda: user.try_get(Pod, "default", "story-worker-7") is None,
             "victim cleanup")
        wait(lambda: user.get(TorchJob, "default", "story").metadata.generation
             > req_gen, "generation bump")
        wait(lambda: user.get(TorchJob, "default", "story")
             .spec.tasks[TaskType.WORKER].num_tasks == 4, "respec to 4")
        job = user.get(TorchJob, "default", "story")
        assert job.spec.gpu_policy.topology == "4x8"
        assert job.metadata.generation > gen0

        def new_gen_running():
            ws = [p for p in workers()
                  if p.status.phase == PodPhase.RUNNING
                  and p.metadata.deletion_timestamp is None]
            gens = {p.metadata.labels.get(constants.LABEL_JOB_GENERATION)
                    for p in ws}
            return len(ws) == 4 and gens == {str(job.metadata.generation)}

        wait(new_gen_running, "4 workers at the new generation")
        pods = {p.metadata.name: p for p in user.list(Pod)
                if p.metadata.deletion_timestamp is None}
        assert sorted(pods) == ["story-master-0"] + [
            f"story-worker-{i}" for i in range(4)]
        _assert_torch_env(pods, "story", world=5, uids=uids)
        assert node_agent.executed >= 5
    finally:
        node_agent.stop()
        kubelet.stop()
        op.stop()
        for c in (user, agent_client, kubelet_client, agent_node_client):
            c.close()
        srv.stop()

