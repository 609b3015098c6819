"""The port's elastic autoscaler (``controller/autoscaler.py``) against the
reference on the CPU.

* ``tests/test_autoscaler.py`` runs against the port through
  ``test_torch_api.reference_cases``, its slice literals mapped by host
  count: the observation parser, the continue rule, and the scaling loop
  (grow to the next legal host count, freeze on a regression, cap at
  ``max_replicas``, revert on pending pods, the watermark over pre-scale
  lines, registration).
* ``tests/test_autoscaler_over_rest.py``'s flow runs on a ``Manager`` wired
  by hand (``test_torch_elastic.HandWired``; the reference's case builds
  ``tpu_on_k8s.main.Operator``, which the port has not yet): the loop
  scrapes worker-0's log through the pods/log subresource and grows the job
  from 2 hosts to 4 and 8. Each growth changes the slice's shape, so the
  running workers restart in place through ``ContainerRecreateRequest``s,
  and the twin runs the node agent that executes them beside the kubelet.
"""
from __future__ import annotations

import sys
import time

import torch

from test_torch_api import reference_cases, slice_literals
from test_torch_elastic import HandWired, operator_flags
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Pod, PodPhase
from tpu_on_k8s_torch.api.types import TaskType, TorchJob
from tpu_on_k8s_torch.client import KubeletLoop
from tpu_on_k8s_torch.client.apiserver import ApiServer
from tpu_on_k8s_torch.client.nodeagent import NodeAgentLoop
from tpu_on_k8s_torch.client.rest import RestCluster
from tpu_on_k8s_torch.client.testing import append_pod_log
from tpu_on_k8s_torch.controller.torchjob import submit_job

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

globals().update(reference_cases("test_autoscaler", subs=(slice_literals,)))
AS = sys.modules["_port_test_autoscaler"]


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestParsing", "TestScalingLoop"} <= names


def test_autoscaler_grows_via_log_scrape_over_rest_with_node_agent():
    """``test_autoscaler_over_rest.py``'s flow: the free-running loop at a
    0.2 s cadence reads worker-0's log over HTTP and grows 2 → 4 → 8 hosts
    (``2x8`` → ``4x8`` → ``8x8``); the workers already running restart in
    place (same uid, elastic-restarts stamped) as the node agent executes
    their CRRs. Every assertion of the reference's case is kept."""
    srv = ApiServer().start()
    op = HandWired(operator_flags().parse_args(
        ["--cluster-backend", "rest", "--api-server", srv.url,
         "--no-leader-elect", "--elastic-loop-period-seconds", "0.2",
         "--crr-wait-seconds", "10"]),
        cluster=RestCluster(srv.url))
    op.start()
    kubelet_client = RestCluster(srv.url)
    kubelet = KubeletLoop(kubelet_client).start()
    agent_client = RestCluster(srv.url)
    agent = NodeAgentLoop(agent_client).start()
    user = RestCluster(srv.url)
    try:
        submit_job(user, AS.native_job(workers=2, hi=8))

        def wait(pred, what, timeout=30):
            deadline = time.time() + timeout
            while time.time() < deadline:
                if pred():
                    return
                time.sleep(0.05)
            raise AssertionError(f"timed out waiting for {what}")

        def num_workers():
            return (user.get(TorchJob, "default", "nj")
                    .spec.tasks[TaskType.WORKER].num_tasks)

        def running():
            return [p for p in user.list(Pod)
                    if p.status.phase == PodPhase.RUNNING]

        wait(lambda: len(running()) == 2, "2 running workers")
        uid0 = user.get(Pod, "default", "nj-worker-0").metadata.uid
        batch_counter = iter(range(10_000))

        def log_until(latency, target_workers, what):
            deadline = time.time() + 30
            while time.time() < deadline:
                append_pod_log(
                    user, "default", "nj-worker-0",
                    f"[elastic-metrics] epoch=1 batch={next(batch_counter)} "
                    f"latency={latency} accuracy=0.9")
                if num_workers() == target_workers:
                    return
                time.sleep(0.15)
            raise AssertionError(f"timed out waiting for {what}")

        log_until(1.0, 4, "growth to 4 hosts")
        assert (user.get(TorchJob, "default", "nj").spec.gpu_policy.topology
                == "4x8")
        wait(lambda: len(running()) == 4, "4 running workers")
        w0 = user.get(Pod, "default", "nj-worker-0")
        assert w0.metadata.uid == uid0
        assert w0.metadata.annotations[
            constants.ANNOTATION_ELASTIC_RESTARTS] == "1"
        assert w0.metadata.annotations[constants.ANNOTATION_WORLD_SIZE] == "4"
        log_until(0.6, 8, "growth to 8 hosts")
        assert agent.executed >= 2
    finally:
        agent.stop()
        kubelet.stop()
        op.stop()
        for c in (user, kubelet_client, agent_client):
            c.close()
        srv.stop()
