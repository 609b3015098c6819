"""The port's failover (``controller/failover.py``), the job engine's chaos
site (``chaos.SITE_RECONCILE`` with ``PodFail`` and ``SlicePreempt``) and
``metrics.JobMetrics`` against the reference on the CPU.

* Exit-code classification: a seeded table of exit codes, kill reasons,
  pod phases and restart policies gives the same class, exit code and
  failover decision in both packages.
* The in-place restart protocol: ``failover_inplace_restart`` through
  ``InMemoryRestarter`` and through ``CRRRestarter`` (post, pending,
  succeeded, failed, stale uid, recreate fallback) leaves the same pods,
  ``ContainerRecreateRequest``s and outcomes.
* The faults at ``SITE_RECONCILE``: one seeded schedule of ``PodFail`` and
  ``SlicePreempt`` on jobs of one and two slices, among them the largest
  legal slice (``64x8``: a master and 63 workers), ends in the same pods,
  services, events and job status as the reference's, and ``JobMetrics``
  renders the same families and samples.
"""
from __future__ import annotations

import re

import numpy as np
import pytest

from test_torch_api import to_port_wire
from test_torch_engine import Side
from tpu_on_k8s import chaos as rchaos
from tpu_on_k8s.api import core as rcore
from tpu_on_k8s.api import crr as rcrr
from tpu_on_k8s.api import types as rtypes
from tpu_on_k8s.client import cluster as rcluster
from tpu_on_k8s.controller import failover as rfailover
from tpu_on_k8s.controller import runtime as rruntime
from tpu_on_k8s.metrics import metrics as rmetrics
from tpu_on_k8s.utils import serde as rserde
from tpu_on_k8s_torch import chaos as pchaos
from tpu_on_k8s_torch import metrics as pmetrics
from tpu_on_k8s_torch.api import core as pcore
from tpu_on_k8s_torch.api import crr as pcrr
from tpu_on_k8s_torch.api import types as ptypes
from tpu_on_k8s_torch.client import cluster as pcluster
from tpu_on_k8s_torch.controller import failover as pfailover
from tpu_on_k8s_torch.controller import runtime as pruntime
from tpu_on_k8s_torch.utils import serde as pserde

PACKAGES = {
    False: (rcore, rtypes, rcluster, rfailover, rcrr, rserde),
    True: (pcore, ptypes, pcluster, pfailover, pcrr, pserde),
}


# ---- exit-code classification -------------------------------------------------

def _classification_table(n: int = 400, seed: int = 0):
    rng = np.random.default_rng(seed)
    known = sorted(rfailover.PERMANENT_EXIT_CODES | rfailover.RETRYABLE_EXIT_CODES
                   | {rfailover.USER_DEFINED_RETRYABLE_EXIT_CODE, 0})
    reasons = sorted(rfailover.RETRYABLE_REASONS) + ["Error", "Completed", ""]
    phases = ["Failed", "Failed", "Running", "Succeeded"]
    policies = [p.value for p in rtypes.RestartPolicy]
    rows = []
    for _ in range(n):
        code = (known[int(rng.integers(len(known)))] if rng.random() < 0.6
                else int(rng.integers(0, 256)))
        rows.append((code if rng.random() < 0.9 else None,
                     reasons[int(rng.integers(len(reasons)))],
                     phases[int(rng.integers(len(phases)))],
                     policies[int(rng.integers(len(policies)))]))
    return rows


def _pod(port: bool, code, reason, phase):
    core = PACKAGES[port][0]
    status = core.PodStatus(phase=phase, reason=reason)
    if code is not None:
        status.container_statuses = [core.ContainerStatus(
            name="c", terminated=core.ContainerStateTerminated(
                exit_code=code, reason=reason))]
    return core.Pod(metadata=core.ObjectMeta(name="p"), status=status)


def test_exit_code_classification_matches_the_reference():
    rows = _classification_table()
    for code in range(256):
        assert (pfailover.classify_exit_code(code).value
                == rfailover.classify_exit_code(code).value), code
    seen = set()
    for code, reason, phase, policy in rows:
        got, want = [], []
        for port, out in ((True, got), (False, want)):
            fo, types = PACKAGES[port][3], PACKAGES[port][1]
            pod = _pod(port, code, reason, phase)
            out.append(fo.pod_exit_code(pod))
            out.append(fo.should_pod_failover(pod, types.RestartPolicy(policy)))
        assert got == want, (code, reason, phase, policy)
        seen.add(got[1])
    assert seen == {True, False}
    assert pfailover.PERMANENT_EXIT_CODES == rfailover.PERMANENT_EXIT_CODES
    assert pfailover.RETRYABLE_EXIT_CODES == rfailover.RETRYABLE_EXIT_CODES
    assert pfailover.RETRYABLE_REASONS == rfailover.RETRYABLE_REASONS
    # only OnExitCode consults the table
    pod = _pod(True, 1, "Error", "Failed")
    assert not pfailover.should_pod_failover(pod, ptypes.RestartPolicy.ON_EXIT_CODE)
    assert pfailover.should_pod_failover(pod, ptypes.RestartPolicy.ON_FAILURE)


# ---- the in-place restart protocol --------------------------------------------

def _restart_story(port: bool) -> list:
    """One scripted run of both restarters and the recreate fallback; each
    step's outcome and the cluster's pods and CRRs as port wire dicts."""
    core, _, cl, fo, crr, serde = PACKAGES[port]
    cluster = cl.InMemoryCluster()
    for name in ("w0", "w1", "w2"):
        cluster.create(core.Pod(
            metadata=core.ObjectMeta(name=name, namespace="default",
                                     labels={"job": "j"}),
            spec=core.PodSpec(containers=[core.Container(name="torch" if port else "tpu")]),
            status=core.PodStatus(phase="Failed", container_statuses=[
                core.ContainerStatus(name="torch" if port else "tpu")])))
    log = []

    def snap(outcome):
        objs = [serde.to_dict(o, drop_none=False, wire=True)
                for k in (core.Pod, crr.ContainerRecreateRequest)
                for o in sorted(cluster.list(k, "default"),
                                key=lambda o: o.metadata.name)]
        for o in objs:
            for key in ("creationTimestamp", "deletionTimestamp"):
                o["metadata"][key] = o["metadata"][key] is not None
            o["metadata"].get("annotations", {}).pop(
                "distributed.tpu.io/last-failover-timestamp", None)
            o["metadata"].get("annotations", {}).pop(
                "distributed.torch.io/last-failover-timestamp", None)
        log.append([getattr(outcome, "value", outcome), objs])

    pod = lambda n: cluster.get(core.Pod, "default", n)  # noqa: E731
    snap(fo.failover_inplace_restart(cluster, pod("w0"), fo.InMemoryRestarter()))
    crrs = fo.CRRRestarter(cluster, wait_seconds=3600)
    snap(fo.failover_inplace_restart(cluster, pod("w1"), crrs))      # post
    snap(fo.failover_inplace_restart(cluster, pod("w1"), crrs))      # pending
    snap(crrs.collect(pod("w1")))

    def phase(value):
        def mutate(r):
            r.status.phase = value
        cluster.update_with_retry(crr.ContainerRecreateRequest, "default",
                                  "w1", mutate, subresource="status")

    phase(crr.PHASE_SUCCEEDED)
    snap(fo.failover_inplace_restart(cluster, pod("w1"), crrs))      # stale
    cluster.update_with_retry(core.Pod, "default", "w1",
                              lambda p: setattr(p.status, "phase", "Running"),
                              subresource="status")
    snap(fo.failover_inplace_restart(cluster, pod("w1"), crrs))      # post
    phase(crr.PHASE_SUCCEEDED)
    snap(fo.failover_inplace_restart(cluster, pod("w1"), crrs))      # done
    snap(fo.failover_inplace_restart(cluster, pod("w2"), crrs))      # post
    phase_w2 = crr.PHASE_FAILED

    def fail(r):
        r.status.phase = phase_w2
    cluster.update_with_retry(crr.ContainerRecreateRequest, "default", "w2",
                              fail, subresource="status")
    snap(fo.failover_inplace_restart(cluster, pod("w2"), crrs))      # recreate
    snap(fo.failover_inplace_restart(cluster, pod("w0"), None))      # no executor
    snap(fo.failover_recreate(cluster, core.Pod(metadata=core.ObjectMeta(
        name="gone", namespace="default"))))
    return log if port else to_port_wire(log)


def test_restart_protocol_matches_the_reference():
    got, want = _restart_story(True), _restart_story(False)
    assert [o for o, _ in got] == [
        "restarted", "pending", "pending", "pending", "pending", "pending",
        "restarted", "pending", "failed", "failed", False]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, i


# ---- the faults at SITE_RECONCILE ------------------------------------------------

def _chaos_spec(seed, topology, num_slices, master, workers, restarter):
    return dict(
        seed=seed, topology=topology, num_slices=num_slices, master=master,
        workers=workers, gang=None, elastic="annotation" if restarter else "none",
        hostnetwork=False, spot=0, master_policy=None,
        worker_policy=rtypes.RestartPolicy.ON_EXIT_CODE,
        restarter=restarter, ttl=None, backoff=None, failures=[])


#: (job, schedule): each fault fires at the reconcile pass its trigger picks
CHAOS_CASES = {
    "pod-fail-retryable": (
        _chaos_spec(2000, "2x4", 1, True, 2, False),
        [("PodFail", dict(task_type="worker", index=1, exit_code=137,
                          reason="OOMKilled"), 1)]),
    "pod-fail-permanent-master": (
        _chaos_spec(2001, "2x4", 1, True, 2, False),
        [("PodFail", dict(task_type="master", index=0, exit_code=1,
                          reason="Error"), 1)]),
    "slice-preempt-of-two-in-place": (
        _chaos_spec(2002, "2x4", 2, False, 4, True),
        [("SlicePreempt", dict(slice_index=1), 1),
         ("PodFail", dict(task_type="worker", index=0, exit_code=143,
                          reason="Killed"), 3)]),
    "64x8-master-63-workers": (
        _chaos_spec(2003, "16x16", 1, True, 63, False),
        [("PodFail", dict(task_type="worker", index=62, exit_code=137,
                          reason="Evicted"), 1),
         ("SlicePreempt", dict(slice_index=0), 3)]),
}


def _run_chaos(port: bool, spec: dict, schedule) -> tuple:
    chaos, runtime = (pchaos, pruntime) if port else (rchaos, rruntime)
    side = Side(port, spec)
    snaps = []
    side.settle()
    for _ in range(2):
        side.sim.run_all("default")
        side.settle()
    snaps.append(side.snapshot())
    rules = [chaos.FaultRule(chaos.SITE_RECONCILE, chaos.on_call(at),
                             getattr(chaos, kind)(**kw))
             for kind, kw, at in schedule]
    with chaos.FaultInjector(rules, seed=spec["seed"]) as inj:
        for _ in range(4):
            side.engine.reconcile(runtime.Request("default", side.name))
            side.settle()
            snaps.append(side.snapshot())
            side.sim.run_all("default")
            side.settle()
        fired = list(inj.events)
    snaps.append(side.snapshot())
    metrics = side.engine.metrics
    return snaps, fired, dict(metrics.counters), \
        {k: metrics.histogram_counts[k] for k in sorted(metrics.histogram_counts)}, \
        (pmetrics if port else rmetrics).render_text(metrics)


@pytest.mark.parametrize("case", list(CHAOS_CASES))
def test_reconcile_faults_match_the_reference(case):
    spec, schedule = CHAOS_CASES[case]
    got = _run_chaos(True, spec, schedule)
    want = _run_chaos(False, spec, schedule)
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        for key in w:
            assert g[key] == w[key], (case, i, key)
    assert got[1] == want[1] and len(got[1]) == len(schedule)
    assert got[2] == want[2] and got[3] == want[3]
    # the launch delays are wall-clock seconds: their buckets and sums
    # differ between runs, their counts may not
    got_text, want_text = (
        re.sub(r"(_(sum|bucket)(\{[^}]*\})?) \S+", r"\1 S", t)
        for t in (got[4], want[4]))
    assert got_text == want_text.replace("kind TPUJob", "kind TorchJob")
    assert "tpu_on_k8s_jobs_restarted_total" in got[4]
    if case == "64x8-master-63-workers":
        final = got[0][-1]
        assert len(final["Pod"]) == 64
        assert got[2]["restarted"] >= 64        # one pod, then the slice
