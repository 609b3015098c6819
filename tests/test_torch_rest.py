"""The port's REST client and API server (``client/rest.py``,
``client/apiserver.py``) against the reference on the CPU.

* ``tests/test_rest_conformance.py`` runs against the port whole, through
  ``test_torch_api.reference_cases``.
* The cases of ``tests/test_rest_backend.py`` that need no later slice run
  here in the GPU flavour: typed CRUD, the status subresource, label
  selection across namespaces, finalizer patches and graceful delete,
  owner cascade, watch delivery, pod logs and events, and Lease leader
  election with fencing over the wire. Three of its cases run in other
  files: ``test_full_tpujob_lifecycle_over_rest`` and
  ``test_build_cluster_backend_selection``, which drive the operator's
  entry point, in ``tests/test_torch_main.py``, and
  ``test_aimaster_cli_runs_against_rest`` in
  ``tests/test_torch_nodeagent.py``.
* The REST chaos sites (``rest.request``, ``rest.watch.connect``,
  ``rest.watch.event``, ``apiserver.request``, ``apiserver.watch``) surface
  their faults as the reference's ``tests/test_chaos.py`` pins them.
* Interop: the port's ``RestCluster`` against the reference's ``ApiServer``
  and the reference's ``RestCluster`` against the port's, for Pod, Service,
  Lease and PersistentVolume: one scripted create, get, list, patch,
  status update, delete and watch gives equal objects and frames in every
  pairing.

Every server and watch thread stops in its test's teardown.
"""
from __future__ import annotations

import datetime as dt
import queue
import threading
import time

import pytest

from test_torch_api import PORT_ACCELERATOR, reference_cases
from tpu_on_k8s.api import core as rcore
from tpu_on_k8s.client import apiserver as rapiserver
from tpu_on_k8s.client import rest as rrest
from tpu_on_k8s.controller import leaderelection as rle
from tpu_on_k8s.storage import providers as rproviders
from tpu_on_k8s.utils import serde as rserde
from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api import core as pcore
from tpu_on_k8s_torch.api.core import (
    Container,
    ObjectMeta,
    OwnerReference,
    Pod,
    PodSpec,
    PodTemplateSpec,
)
from tpu_on_k8s_torch.api.types import (
    GPUPolicy,
    TaskSpec,
    TaskType,
    TorchJob,
    TorchJobSpec,
)
from tpu_on_k8s_torch.client import apiserver as papiserver
from tpu_on_k8s_torch.client import rest as prest
from tpu_on_k8s_torch.client.cluster import (
    AlreadyExistsError,
    ApiError,
    ConflictError,
    ConflictRetriesExhausted,
    NotFoundError,
)
from tpu_on_k8s_torch.client.rest import RestCluster
from tpu_on_k8s_torch.client.testing import append_pod_log
from tpu_on_k8s_torch.controller import leaderelection as ple
from tpu_on_k8s_torch.controller.leaderelection import LeaderElector
from tpu_on_k8s_torch.storage import providers as pproviders
from tpu_on_k8s_torch.utils import conditions
from tpu_on_k8s_torch.utils import serde as pserde

# the fixtures ``server`` and ``rest`` come with the conformance cases
globals().update(reference_cases("test_rest_conformance"))


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    chaos.uninstall()


def _job(name, workers=2, topology="2x8"):
    template = PodTemplateSpec(
        spec=PodSpec(containers=[Container(name="torch", image="i")]))
    return TorchJob(
        metadata=ObjectMeta(name=name),
        spec=TorchJobSpec(
            tasks={TaskType.MASTER: TaskSpec(num_tasks=1, template=template),
                   TaskType.WORKER: TaskSpec(num_tasks=workers,
                                             template=template)},
            gpu_policy=GPUPolicy(accelerator=PORT_ACCELERATOR,
                                 topology=topology)))


# ---- tests/test_rest_backend.py in the GPU flavour ----------------------------

def test_rest_crud_roundtrip(rest):
    job = _job("crud")
    created = rest.create(job)
    assert created.metadata.uid and created.metadata.resource_version
    with pytest.raises(AlreadyExistsError):
        rest.create(job)

    got = rest.get(TorchJob, "default", "crud")
    assert got.spec.tasks[TaskType.WORKER].num_tasks == 2
    assert got.spec.gpu_policy.topology == "2x8"

    got.spec.tasks[TaskType.WORKER].num_tasks = 4
    updated = rest.update(got)
    assert updated.metadata.generation == got.metadata.generation + 1
    with pytest.raises(ConflictError):
        rest.update(got)

    assert rest.try_get(TorchJob, "default", "nope") is None
    with pytest.raises(NotFoundError):
        rest.get(TorchJob, "default", "nope")

    rest.delete(TorchJob, "default", "crud")
    assert rest.try_get(TorchJob, "default", "crud") is None


def test_rest_status_subresource_keeps_spec(rest):
    job = rest.create(_job("status"))
    job.spec.tasks[TaskType.WORKER].num_tasks = 99  # must NOT land
    conditions.mark_created(job)
    rest.update(job, subresource="status")
    back = rest.get(TorchJob, "default", "status")
    assert back.spec.tasks[TaskType.WORKER].num_tasks == 2
    assert any(c.type == "Created" for c in back.status.conditions)
    assert back.status.conditions[0].message == "TorchJob status is created."


def test_rest_list_label_selector_and_all_namespaces(rest):
    a = _job("sel-a")
    a.metadata.labels["team"] = "x"
    b = _job("sel-b")
    b.metadata.labels["team"] = "y"
    c = _job("sel-c")
    c.metadata.namespace = "other"
    c.metadata.labels["team"] = "x"
    for j in (a, b, c):
        rest.create(j)
    assert {j.metadata.name for j in rest.list(TorchJob, "default")} == {
        "sel-a", "sel-b"}
    assert {j.metadata.name
            for j in rest.list(TorchJob, "default", {"team": "x"})} == {"sel-a"}
    assert {j.metadata.name for j in rest.list(TorchJob, None, {"team": "x"})
            } == {"sel-a", "sel-c"}


def test_rest_patch_finalizers_and_graceful_delete(rest):
    rest.create(Pod(metadata=ObjectMeta(name="p", namespace="default")))
    rest.patch_meta(Pod, "default", "p",
                    labels={"l": "1"}, annotations={"a": "b"},
                    add_finalizers=[constants.FINALIZER_PREEMPT_PROTECTOR])
    rest.delete(Pod, "default", "p")
    pinned = rest.get(Pod, "default", "p")
    assert pinned.metadata.deletion_timestamp is not None
    assert pinned.metadata.labels["l"] == "1"
    assert pinned.metadata.finalizers == [
        "distributed.torch.io/preempt-protector"]
    rest.patch_meta(Pod, "default", "p",
                    remove_finalizers=[constants.FINALIZER_PREEMPT_PROTECTOR])
    assert rest.try_get(Pod, "default", "p") is None


def test_rest_cascade_gc_via_owner_reference(rest):
    job = rest.create(_job("owner"))
    rest.create(Pod(metadata=ObjectMeta(
        name="owned", namespace="default",
        owner_references=[OwnerReference(
            api_version=job.api_version, kind=job.kind,
            name=job.metadata.name, uid=job.metadata.uid, controller=True)])))
    rest.delete(TorchJob, "default", "owner")
    assert rest.try_get(Pod, "default", "owned") is None


def test_rest_watch_delivers_after_registration(rest):
    events = []
    done = threading.Event()

    def cb(event):
        events.append((event.type, event.kind, event.obj.metadata.name))
        if event.type == "DELETED":
            done.set()

    rest.watch(cb)
    rest.create(_job("watched"))
    rest.delete(TorchJob, "default", "watched")
    assert done.wait(5), f"events so far: {events}"
    assert ("ADDED", "TorchJob", "watched") in events
    assert ("DELETED", "TorchJob", "watched") in events


def test_rest_pod_log_and_events(rest):
    rest.create(Pod(metadata=ObjectMeta(name="logged", namespace="default")))
    append_pod_log(rest, "default", "logged", "[elastic-metrics] latency=0.5")
    append_pod_log(rest, "default", "logged", "[elastic-metrics] latency=0.4")
    assert rest.read_pod_log("default", "logged", tail=1) == [
        "[elastic-metrics] latency=0.4"]
    obj = rest.create(_job("evented"))
    rest.record_event(obj, "Normal", "Tested", "hello")
    assert ("default/evented", "Normal", "Tested", "hello") in rest.events


def test_leader_election_conflict_and_fencing_over_rest(server):
    a, b = RestCluster(server.url), RestCluster(server.url)
    states = {"a": [], "b": []}
    ea = LeaderElector(a, "elector-a", lease_seconds=0.6, renew_seconds=0.1,
                       on_started_leading=lambda: states["a"].append("lead"),
                       on_stopped_leading=lambda: states["a"].append("stop"))
    eb = LeaderElector(b, "elector-b", lease_seconds=0.6, renew_seconds=0.1,
                       on_started_leading=lambda: states["b"].append("lead"),
                       on_stopped_leading=lambda: states["b"].append("stop"))
    try:
        ea.start()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not ea.is_leader:
            time.sleep(0.02)
        assert ea.is_leader
        eb.start()
        time.sleep(0.5)  # contention window: b must NOT co-lead
        assert not eb.is_leader
        ea.stop()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not eb.is_leader:
            time.sleep(0.02)
        assert eb.is_leader
        assert states["a"] and states["a"][0] == "lead"
        assert states["b"] and states["b"][-1] == "lead"
    finally:
        ea.stop()
        eb.stop()
        a.close()
        b.close()


# ---- the REST chaos sites --------------------------------------------------------

def test_rest_request_faults_surface_typed(rest):
    with chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_REST_REQUEST, chaos.on_call(1),
            chaos.HttpError(503))]):
        with pytest.raises(ApiError, match="503"):
            rest.list(TorchJob)
    with chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_REST_REQUEST, chaos.on_call(1), chaos.Conflict())]):
        with pytest.raises(ConflictError):
            rest.list(TorchJob)
    # one connection-level fault takes the stale-keep-alive retry and is
    # absorbed; both attempts faulted, the failure propagates
    with chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_REST_REQUEST, chaos.on_call(1),
            chaos.ConnectionResetFault())]):
        assert rest.list(TorchJob) == []
    with chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_REST_REQUEST, chaos.on_call(1, 2),
            chaos.TimeoutFault())]):
        with pytest.raises(OSError):
            rest.list(TorchJob)


def test_apiserver_side_injection(rest):
    with chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_APISERVER_REQUEST, chaos.on_call(1),
            chaos.HttpError(500))]):
        with pytest.raises(ApiError, match="500"):
            rest.list(TorchJob)
    with chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_APISERVER_REQUEST, chaos.on_call(1),
            chaos.Conflict())]):
        with pytest.raises(ConflictError):
            rest.list(TorchJob)
    with chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_APISERVER_REQUEST, chaos.on_call(1),
            chaos.ConnectionResetFault())]):
        assert rest.list(TorchJob) == []


def _mk(name):
    return Pod(metadata=ObjectMeta(name=name),
               spec=PodSpec(containers=[Container(name="c", image="i")]))


def _wait_for(pred, timeout=20):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.05)
    return pred()


def test_apiserver_watch_drop_resumes(rest):
    seen = []
    rest.watch(lambda ev: seen.append(ev.obj.metadata.name), kinds=["Pod"])
    inj = chaos.FaultInjector([chaos.FaultRule(
        chaos.SITE_APISERVER_WATCH, chaos.on_call(1), chaos.WatchDrop())])
    with inj:
        for i in range(3):
            rest.create(_mk(f"w{i}"))
        assert _wait_for(lambda: inj.fired_total() >= 1
                         and len(set(seen)) >= 3), inj.counts()
    assert {f"w{i}" for i in range(3)} <= set(seen)


def test_client_watch_drop_and_refused_dials_recover(rest):
    """A stream dropped after a frame (``rest.watch.event``) and the two
    redials after it refused (``rest.watch.connect``): the informer backs
    off, redials from its last revision and every pod arrives."""
    rest.WATCH_BACKOFF_INITIAL = 0.05
    seen = []
    inj = chaos.FaultInjector([
        chaos.FaultRule(chaos.SITE_REST_WATCH_EVENT,
                        chaos.Trigger(at=(1,), match={"kind": "Pod"}),
                        chaos.WatchDrop()),
        chaos.FaultRule(chaos.SITE_REST_WATCH_CONNECT,
                        chaos.Trigger(at=(2, 3), match={"kind": "Pod"}),
                        chaos.ConnectionResetFault())])
    with inj:
        rest.watch(lambda ev: seen.append(ev.obj.metadata.name),
                   kinds=["Pod"])
        for i in range(4):
            rest.create(_mk(f"p{i}"))
        assert _wait_for(lambda: inj.fired_total() == 3), inj.counts()
    assert _wait_for(lambda: {f"p{i}" for i in range(4)} <= set(seen))
    assert inj.events == [
        "seq=1 watch_drop", "seq=2 connection_reset",
        "seq=3 connection_reset"]


class _Counter:
    def __init__(self):
        self.counters = {}

    def inc(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n


def test_conflict_retries_exhausted_typed_and_counted(rest):
    rest.metrics = _Counter()
    rest.create(TorchJob(metadata=ObjectMeta(name="c")))
    with chaos.FaultInjector([chaos.FaultRule(
            chaos.SITE_REST_REQUEST,
            chaos.Trigger(every=1, match={"method": "PUT"}),
            chaos.Conflict())]):
        with pytest.raises(ConflictRetriesExhausted) as ei:
            rest.update_with_retry(TorchJob, "default", "c", lambda j: None,
                                   attempts=3)
    assert isinstance(ei.value, ConflictError)
    assert rest.metrics.counters["conflict_retries"] == 3
    with pytest.raises(ValueError, match="attempts"):
        rest.update_with_retry(TorchJob, "default", "c", lambda j: None,
                               attempts=0)


def test_watch_backoff_decorrelated_jitter(rest):
    import random

    rest._backoff_rng = random.Random(7)
    ref = rrest.RestCluster("http://127.0.0.1:1")
    ref._backoff_rng = random.Random(7)
    prev = rest.WATCH_BACKOFF_INITIAL
    for _ in range(50):
        nxt = rest._next_backoff(prev)
        assert nxt == ref._next_backoff(prev)
        assert rest.WATCH_BACKOFF_INITIAL <= nxt <= rest.WATCH_BACKOFF_MAX
        prev = nxt


# ---- interop: each package's client against the other's server -------------------

_RENEW = dt.datetime(2026, 7, 30, 11, 0, 5, 250000, tzinfo=dt.timezone.utc)


def _pkg(port: bool):
    """(core, leaderelection, providers, serde, apiserver, rest) of one
    package: the core kinds' classes are the same shapes in both."""
    if port:
        return pcore, ple, pproviders, pserde, papiserver, prest
    return rcore, rle, rproviders, rserde, rapiserver, rrest


def _objects(port: bool):
    core, le, providers, _, _, _ = _pkg(port)
    return [
        core.Pod(metadata=core.ObjectMeta(name="p", labels={"a": "1"}),
                 spec=core.PodSpec(containers=[core.Container(
                     name="c", image="i", env=[core.EnvVar(
                         name="W", value_from=core.EnvVarSource(
                             field_path="metadata.annotations['w']"))])],
                     volumes=[core.Volume(name="v", nfs_server="10.0.0.5",
                                          nfs_path="/x")])),
        core.Service(metadata=core.ObjectMeta(name="s"),
                     spec=core.ServiceSpec(cluster_ip="None",
                                           selector={"a": "1"},
                                           ports=[core.ServicePort(
                                               name="n", port=80,
                                               target_port=8080)])),
        le.Lease(metadata=core.ObjectMeta(name="l", namespace="default"),
                 holder="me", renew_time=_RENEW, lease_seconds=15.0),
        providers.PersistentVolume(
            metadata=core.ObjectMeta(name="pv", namespace=""),
            spec=providers.PersistentVolumeSpec(
                capacity_gi=20, host_path="/data", node_name="node-7",
                claim_ref="default/c")),
    ]


def _norm(serde, obj):
    d = serde.to_dict(obj, drop_none=False, wire=True)
    meta = d["metadata"]
    for k in ("creationTimestamp", "deletionTimestamp"):
        meta[k] = meta.get(k) is not None
    return d


def _script(client_port: bool, server_port: bool):
    """One scripted session of a package's client against a package's
    server: every answer and every watch frame, as wire dicts."""
    core, _, _, serde, _, rest_mod = _pkg(client_port)
    srv = _pkg(server_port)[4].ApiServer().start()
    client = rest_mod.RestCluster(srv.url)
    frames = queue.Queue()
    out = []
    try:
        client.watch(lambda e: frames.put(
            (e.type, e.kind, e.obj.metadata.name,
             e.obj.metadata.resource_version)),
            kinds=["Pod", "Service", "Lease", "PersistentVolume"])
        objs = _objects(client_port)
        for obj in objs:
            ns = obj.metadata.namespace
            cls = type(obj)
            out.append(_norm(serde, client.create(obj)))
            out.append(_norm(serde, client.get(cls, ns, obj.metadata.name)))
            out.append([_norm(serde, o) for o in client.list(cls)])
            out.append(_norm(serde, client.patch_meta(
                cls, ns, obj.metadata.name, labels={"b": "2"},
                annotations={"n": "x"}, add_finalizers=["a.io/f"])))
            cur = client.get(cls, ns, obj.metadata.name)
            if hasattr(cur, "status"):
                out.append(_norm(serde, client.update(cur,
                                                      subresource="status")))
            client.delete(cls, ns, obj.metadata.name)
            pinned = client.get(cls, ns, obj.metadata.name)
            out.append(_norm(serde, pinned))
            out.append(_norm(serde, client.patch_meta(
                cls, ns, obj.metadata.name, remove_finalizers=["a.io/f"])))
            out.append(client.try_get(cls, ns, obj.metadata.name))
        # ADDED, the patch, the delete's stamp, the drain, DELETED; and a
        # status update where the kind has a status
        want = sum(5 + hasattr(o, "status") for o in objs)
        seen = []
        deadline = time.monotonic() + 20
        while len(seen) < want and time.monotonic() < deadline:
            try:
                seen.append(frames.get(timeout=0.2))
            except queue.Empty:
                continue
    finally:
        client.close()
        srv.stop()
    # per-kind order is the stream's; kinds interleave across streams
    return out, sorted(seen, key=lambda f: (f[1], f[3]))


@pytest.fixture(scope="module")
def reference_session():
    return _script(client_port=False, server_port=False)


@pytest.mark.parametrize("client_port, server_port", [
    (True, False), (False, True), (True, True)],
    ids=["port-client-ref-server", "ref-client-port-server", "port-port"])
def test_interop_sessions_equal_the_reference(reference_session,
                                              client_port, server_port):
    """Create, get, list, metadata and finalizer patches, a status update, a
    finalizer-pinned delete and its drain, and the watch frames of all four
    kinds: equal to the reference client against the reference server."""
    want_out, want_frames = reference_session
    got_out, got_frames = _script(client_port, server_port)
    assert len(want_frames) == 21
    assert got_frames == want_frames
    assert got_out == want_out
