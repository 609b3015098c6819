"""The port's operator-plane API (``tpu_on_k8s_torch/api``, ``gang/topology``,
``utils/serde``, ``utils/conditions``, ``utils/resources``, ``features``)
against the reference on the CPU.

The map between the two lives here and the other operator-plane test files
import it. ``REF_TO_PORT`` pairs every value the two ``api/constants.py``
modules both name where the values differ (``distributed.tpu.io`` →
``distributed.torch.io``, ``TPU_PROCESS_ID`` → ``RANK`` ...), plus the
constants the GPU flavour renames (``RENAMED``); ``DROPPED`` lists the
reference's names with no GPU counterpart and ``SPLIT`` the coordinator
address that becomes MASTER_ADDR and MASTER_PORT. ``to_port_wire`` maps a
reference wire dict onto the port's (field names, API groups, kinds, env
names, the slice binding by host count) and ``to_ref_wire`` maps back;
``reference_cases`` runs a reference test module's cases against the port.

Here: the cases of ``tests/test_api_types.py`` with each accelerator and
topology mapped by host count, the registry round trip of
``tests/test_wire_roundtrip.py`` over the port's kinds, a seeded
differential wire round trip of every reference kind through the map and
the port's codec, and seeded specs defaulted by both packages.
"""
from __future__ import annotations

import dataclasses
import datetime as dt
import enum
import re
import sys
import types
import typing
from pathlib import Path
from typing import get_args, get_origin

import numpy as np
import pytest

import tpu_on_k8s.api.constants as RC
import tpu_on_k8s_torch.api.constants as PC
from tpu_on_k8s.api import core as rcore
from tpu_on_k8s.api import defaults as rdefaults
from tpu_on_k8s.api import types as rtypes
from tpu_on_k8s.client import resources as rresources
from tpu_on_k8s.gang import topology as rtopology
from tpu_on_k8s.utils import serde as rserde
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import (
    Container,
    ContainerPort,
    ObjectMeta,
    PodSpec,
    PodTemplateSpec,
)
from tpu_on_k8s_torch.api.defaults import set_defaults_torchjob
from tpu_on_k8s_torch.api.types import (
    DAGCondition,
    ElasticPolicy,
    GPUPolicy,
    JobConditionType,
    RestartPolicy,
    SchedulingPolicy,
    TaskSpec,
    TaskType,
    TorchJob,
    TorchJobSpec,
)
from tpu_on_k8s_torch.client import resources
from tpu_on_k8s_torch.features import features
from tpu_on_k8s_torch.gang import topology
from tpu_on_k8s_torch.utils import conditions
from tpu_on_k8s_torch.utils import resources as resmath
from tpu_on_k8s_torch.utils import serde

TESTS = Path(__file__).resolve().parent

# ---- the map ----------------------------------------------------------------

#: reference constant -> the port's name for it
RENAMED = {"KIND_TPUJOB": "KIND_TORCHJOB", "RESOURCE_TPU": "RESOURCE_GPU",
           "NODE_SELECTOR_TPU_ACCELERATOR": "NODE_SELECTOR_GPU_ACCELERATOR"}
#: reference constants with no GPU counterpart
DROPPED = ("ENV_PJRT_DEVICE", "ENV_TPU_WORKER_ID", "ENV_TPU_WORKER_HOSTNAMES",
           "ENV_MEGASCALE_COORDINATOR", "ENV_MEGASCALE_NUM_SLICES",
           "ENV_MEGASCALE_SLICE_ID", "ENV_LIBTPU_INIT_ARGS",
           "LIBTPU_PERF_ARGS", "NODE_SELECTOR_TPU_TOPOLOGY",
           "ENV_JAX_COMPILATION_CACHE_DIR", "COMPILE_CACHE_VOLUME",
           "DEFAULT_COMPILE_CACHE_DIR")
#: the coordinator's host:port becomes two variables
SPLIT = {"ENV_COORDINATOR_ADDRESS": ("ENV_MASTER_ADDR", "ENV_MASTER_PORT")}
#: spec fields the GPU flavour renames (snake_case and wire camelCase)
FIELDS = {"tpu_policy": "gpu_policy", "tpuPolicy": "gpuPolicy"}
#: the reference accelerator whose host counts the port's table carries
REF_ACCELERATOR = "tpu-v5-lite-podslice"
PORT_ACCELERATOR = "nvidia-h100-80gb"
#: values outside ``api/constants.py`` that the GPU flavour renames: the
#: elastic rendezvous backend (torchrun has no ``xla``), the gang
#: scheduler's name, the engine's reason for an unschedulable slice and the
#: ModelVersion controller's label on the objects it makes
VALUES = {"xla": "c10d", "tpu-slice": "gpu-slice",
          "InvalidTPUPolicy": "InvalidGPUPolicy",
          "model.distributed.tpu.io/model-version-name":
              "model.distributed.torch.io/model-version-name"}


def _constants(mod) -> dict:
    return {n: v for n, v in vars(mod).items() if n.isupper()}


def _build_map() -> dict:
    ref, port = _constants(RC), _constants(PC)
    out = {}
    for name, value in ref.items():
        if name in DROPPED or name in SPLIT:
            continue
        mine = port[RENAMED.get(name, name)]
        if mine != value:
            out[value] = mine
    out[REF_ACCELERATOR] = PORT_ACCELERATOR
    out.update(VALUES)
    return out


REF_TO_PORT = _build_map()
PORT_TO_REF = {v: k for k, v in REF_TO_PORT.items()}
# substrings: the API group (in apiVersions, label keys, routes), the job
# kind's lower-case stem (the job-name label, the port name, the plural) and
# the gang admission's fallback node names
_SUBSTR = [(RC.API_GROUP, PC.API_GROUP), ("tpujob", "torchjob"),
           ("tpu-node-", "gpu-node-")]


def port_topology(accelerator: str, topo: str) -> str:
    """The port's topology with the host count (and, on one host, the chip
    count) of a reference slice."""
    hosts = rtopology.hosts_per_slice(accelerator, topo)
    if hosts == 1:
        out = f"1x{rtopology.chips_in_topology(topo)}"
    else:
        out = f"{hosts}x{topology.chips_per_host(PORT_ACCELERATOR)}"
    topology.validate_slice(PORT_ACCELERATOR, out)
    return out


def ref_topology(topo: str) -> str:
    """The inverse of ``port_topology`` over ``REF_ACCELERATOR``."""
    hosts = topology.hosts_per_slice(PORT_ACCELERATOR, topo)
    chips = topology.chips_in_topology(topo)
    for t in rtopology.legal_topologies(REF_ACCELERATOR):
        if rtopology.hosts_per_slice(REF_ACCELERATOR, t) == hosts and (
                hosts > 1 or rtopology.chips_in_topology(t) == chips):
            return t
    raise KeyError(f"{topo} has no {REF_ACCELERATOR} counterpart")


def _map_str(s: str, exact: dict, substr) -> str:
    if s in exact:
        return exact[s]
    for a, b in substr:
        s = s.replace(a, b)
    return s


def _map_wire(x, exact, substr, fields, policy):
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            key = fields.get(k, _map_str(k, exact, substr)) \
                if isinstance(k, str) else k
            if k in fields and isinstance(v, dict):
                out[key] = policy(v)
            else:
                out[key] = _map_wire(v, exact, substr, fields, policy)
        return out
    if isinstance(x, list):
        return [_map_wire(v, exact, substr, fields, policy) for v in x]
    if isinstance(x, str):
        return _map_str(x, exact, substr)
    return x


def _port_policy(p: dict) -> dict:
    out = dict(p)
    acc = p.get("accelerator", rtypes.TPUPolicy.accelerator)
    out["accelerator"] = REF_TO_PORT.get(acc, acc)
    if "topology" in p:
        out["topology"] = port_topology(acc, p["topology"])
    return out


def _ref_policy(p: dict) -> dict:
    out = dict(p)
    if "accelerator" in p:
        out["accelerator"] = PORT_TO_REF[p["accelerator"]]
    if "topology" in p:
        out["topology"] = ref_topology(p["topology"])
    return out


def to_port_wire(d):
    """A reference wire (or snake_case) dict as the port speaks it."""
    return _map_wire(d, REF_TO_PORT, _SUBSTR, FIELDS, _port_policy)


def to_ref_wire(d):
    """The inverse of ``to_port_wire``."""
    return _map_wire(d, PORT_TO_REF, [(b, a) for a, b in _SUBSTR],
                     {v: k for k, v in FIELDS.items()}, _ref_policy)


def port_kind(kind: str) -> str:
    return REF_TO_PORT.get(kind, kind)


# identifiers of the reference's tests that the port names otherwise (string
# literals stay: the core kinds' data is the same in both packages)
_SOURCE_RENAMES = [(r"\btpu_on_k8s\.", "tpu_on_k8s_torch."),
                   (r"\bset_defaults_tpujob\b", "set_defaults_torchjob"),
                   (r"\bcontroller\.tpujob\b", "controller.torchjob"),
                   (r"\bsetup_tpujob_controller\b", "setup_torchjob_controller"),
                   (r"\bKIND_TPUJOB\b", "KIND_TORCHJOB"),
                   (r"\bRESOURCE_TPU\b", "RESOURCE_GPU"),
                   (r"(?<![\"'])\bTPUJob", "TorchJob"),
                   (r"\bTPUPolicy\b", "GPUPolicy"),
                   (r"\btpu_policy\b", "gpu_policy")]


#: the load driver, the fuzz driver and the three report tools as the port
#: names them, for a reference case that drives ``tools/serve_load.py``
#: (the port's ``main`` runs on the card unless a case's flags add
#: ``--device cpu``), ``tools/fuzz_run.py`` or the reports over a twin's
#: dumps
TOOLS = [(r"\bfrom tools import serve_load\b",
          "from tpu_on_k8s_torch import serve_load"),
         (r"\bfrom tools import slo_report, trace_report, why_report\b",
          "from tpu_on_k8s_torch.obs import slo_report, trace_report, "
          "why_report"),
         (r"\btools\.serve_load\b", "tpu_on_k8s_torch.serve_load"),
         (r"\btools\.trace_report\b", "tpu_on_k8s_torch.obs.trace_report"),
         (r"\btools\.why_report\b", "tpu_on_k8s_torch.obs.why_report"),
         (r"\btools\.slo_report\b", "tpu_on_k8s_torch.obs.slo_report"),
         (r"\btools\.fuzz_run\b", "tpu_on_k8s_torch.fuzz_run")]


def reference_cases(ref: str, *, only=None, skip=(), subs=()) -> dict:
    """The test functions, test classes and fixtures of ``tests/<ref>.py``,
    run against the port: the reference's source with its ``tpu_on_k8s``
    imports resolved in ``tpu_on_k8s_torch`` and the renamed identifiers of
    the GPU flavour applied, line for line, so a failure points at the
    reference's line. ``subs`` are further rewrites within a line, each a
    ``(pattern, replacement)`` pair or a function of the source (a
    reference slice's literals mapped by host count, ``slice_literals``).
    ``only``/``skip`` choose the cases by name; a ``Class.method`` name in
    ``skip`` drops that method of a test class. The module itself stays in
    ``sys.modules`` as ``_port_<ref>``, for its helpers. A test file does
    ``globals().update(reference_cases(...))``."""
    path = TESTS / f"{ref}.py"
    src = path.read_text()
    for rewrite in (*_SOURCE_RENAMES, *subs):
        new = rewrite(src) if callable(rewrite) else re.sub(*rewrite, src)
        assert new.count("\n") == src.count("\n"), rewrite
        src = new
    mod = types.ModuleType(f"_port_{ref}")
    mod.__file__ = str(path)
    sys.modules[mod.__name__] = mod
    exec(compile(src, str(path), "exec"), mod.__dict__)
    for name in skip:
        cls, _, meth = name.partition(".")
        if meth:
            delattr(getattr(mod, cls), meth)
    out = {}
    for name, obj in vars(mod).items():
        is_case = name.startswith(("test_", "Test"))
        is_fixture = hasattr(obj, "_fixture_function_marker") or hasattr(
            obj, "_pytestfixturefunction")
        if not (is_case or is_fixture):
            continue
        if is_case and ((only is not None and name not in only)
                        or name in skip):
            continue
        out[name] = obj
    return out


def reference_functions(ref: str, names, namespace: dict,
                        subs=()) -> dict:
    """Module-level functions (or test classes) of ``tests/<ref>.py``,
    each one's source mapped to the port as ``reference_cases`` maps a
    whole module (line numbers kept, ``subs`` applied), and compiled into
    ``namespace``, which supplies their module globals. For a reference
    module whose own imports reach what the port has not yet (a later
    slice's modules): only the named functions run. Returns
    ``namespace``."""
    import ast

    path = TESTS / f"{ref}.py"
    src = path.read_text()
    nodes = {n.name: n for n in ast.parse(src).body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    for name in names:
        node = nodes[name]
        seg = "\n" * (node.lineno - 1) + ast.get_source_segment(src, node)
        for rewrite in (*_SOURCE_RENAMES, *subs):
            seg = rewrite(seg) if callable(rewrite) else re.sub(*rewrite,
                                                                 seg)
        exec(compile(seg, str(path), "exec"), namespace)
    return namespace


def slice_literals(src: str) -> str:
    """A reference test's slice literals in the port: the accelerator
    ``"tpu-v5-lite-podslice"`` and each quoted topology of it mapped by host
    count (``port_topology``), and ``google.com/tpu`` as ``nvidia.com/gpu``.
    Counts of chips are left alone (4 a TPU host, 8 a GPU host): a case
    that asserts one needs its own rewrite or a twin."""
    legal = set(rtopology.legal_topologies(REF_ACCELERATOR))
    src = src.replace(f'"{REF_ACCELERATOR}"', f'"{PORT_ACCELERATOR}"')
    src = src.replace(f'"{RC.RESOURCE_TPU}"', f'"{PC.RESOURCE_GPU}"')
    return re.sub(r'"(\d+x\d+)"', lambda m: (
        f'"{port_topology(REF_ACCELERATOR, m.group(1))}"'
        if m.group(1) in legal else m.group(0)), src)


def test_the_map_covers_every_constant():
    """Every reference constant is kept, renamed, split or dropped, and the
    port names nothing the map does not account for."""
    ref, port = _constants(RC), _constants(PC)
    kept = {RENAMED.get(n, n) for n in ref if n not in DROPPED
            and n not in SPLIT}
    split = {m for pair in SPLIT.values() for m in pair}
    assert kept | split == set(port)
    assert not split & kept
    assert set(DROPPED) <= set(ref) and set(SPLIT) <= set(ref)
    # injective, so that to_ref_wire inverts to_port_wire
    assert len(PORT_TO_REF) == len(REF_TO_PORT)
    assert REF_TO_PORT[RC.API_GROUP] == "distributed.torch.io"
    assert REF_TO_PORT[RC.KIND_TPUJOB] == "TorchJob"
    assert REF_TO_PORT[RC.ENV_PROCESS_ID] == "RANK"
    assert REF_TO_PORT[RC.ENV_NUM_PROCESSES] == "WORLD_SIZE"
    assert REF_TO_PORT[RC.RESOURCE_TPU] == "nvidia.com/gpu"
    assert REF_TO_PORT[RC.DEFAULT_CONTAINER_NAME] == "torch"
    assert PC.ENV_MASTER_ADDR == "MASTER_ADDR"
    assert PC.ENV_MASTER_PORT == "MASTER_PORT"


def test_the_env_is_what_train_distributed_reads():
    """The operator's rendezvous names are torchrun's four variables, the
    ones ``train/distributed.py`` joins a world from."""
    from tpu_on_k8s_torch.train.distributed import TORCHRUN_ENV
    assert set(TORCHRUN_ENV) == {PC.ENV_MASTER_ADDR, PC.ENV_MASTER_PORT,
                                 PC.ENV_PROCESS_ID, PC.ENV_NUM_PROCESSES}


@pytest.mark.parametrize("topo", rtopology.legal_topologies(REF_ACCELERATOR))
def test_topology_map_is_a_bijection_on_the_reference_default(topo):
    mine = port_topology(REF_ACCELERATOR, topo)
    assert topology.hosts_per_slice(PORT_ACCELERATOR, mine) == \
        rtopology.hosts_per_slice(REF_ACCELERATOR, topo)
    assert ref_topology(mine) == topo


def test_default_slice_is_the_reference_default_mapped():
    ref = {"tpuPolicy": rserde.to_dict(rtypes.TPUPolicy(), wire=True)}
    assert to_port_wire(ref) == {
        "gpuPolicy": serde.to_dict(GPUPolicy(), wire=True)}
    assert GPUPolicy().accelerator == PORT_ACCELERATOR


# ---- tests/test_api_types.py against the port ---------------------------------

def make_job(workers=2, master=True, elastic=None, accelerator=REF_ACCELERATOR,
             topo="4x4") -> TorchJob:
    """``test_api_types.make_job`` in the port: the reference slice mapped
    by host count."""
    tasks = {}
    if master:
        tasks[TaskType.MASTER] = TaskSpec(
            num_tasks=1,
            template=PodTemplateSpec(spec=PodSpec(containers=[
                Container(name="torch", image="img")])))
    tasks[TaskType.WORKER] = TaskSpec(
        num_tasks=workers,
        template=PodTemplateSpec(spec=PodSpec(containers=[
            Container(name="torch", image="img")])))
    return TorchJob(
        metadata=ObjectMeta(name="job1", namespace="ns1", uid="uid-1"),
        spec=TorchJobSpec(
            tasks=tasks, elastic_policy=elastic,
            gpu_policy=GPUPolicy(accelerator=PORT_ACCELERATOR,
                                 topology=port_topology(accelerator, topo))))


class TestSerde:
    def test_round_trip(self):
        job = make_job()
        job.status.start_time = dt.datetime(2026, 1, 1, tzinfo=dt.timezone.utc)
        data = serde.to_dict(job)
        back = serde.from_dict(TorchJob, data)
        assert back.metadata.name == "job1"
        assert back.spec.tasks[TaskType.WORKER].num_tasks == 2
        assert back.status.start_time == job.status.start_time
        assert serde.to_dict(back) == data

    def test_deep_copy_isolated(self):
        job = make_job()
        cp = serde.deep_copy(job)
        cp.spec.tasks[TaskType.WORKER].num_tasks = 99
        cp.metadata.labels["x"] = "y"
        assert job.spec.tasks[TaskType.WORKER].num_tasks == 2
        assert "x" not in job.metadata.labels

    def test_unknown_keys_ignored(self):
        data = serde.to_dict(make_job())
        data["spec"]["bogus_field"] = 1
        back = serde.from_dict(TorchJob, data)
        assert back.metadata.name == "job1"


class TestDefaults:
    def test_restart_policies(self):
        job = set_defaults_torchjob(make_job())
        assert job.spec.tasks[TaskType.MASTER].restart_policy is RestartPolicy.ON_EXIT_CODE
        assert job.spec.tasks[TaskType.WORKER].restart_policy is RestartPolicy.ON_FAILURE

    def test_string_task_keys_normalized(self):
        job = make_job()
        job.spec.tasks = {"worker": job.spec.tasks[TaskType.WORKER]}
        set_defaults_torchjob(job)
        assert TaskType.WORKER in job.spec.tasks

    def test_port_injected(self):
        job = set_defaults_torchjob(make_job())
        ports = job.spec.tasks[TaskType.MASTER].template.spec.containers[0].ports
        assert any(
            p.name == constants.DEFAULT_PORT_NAME == "torchjob-port"
            and p.container_port == constants.DEFAULT_COORDINATOR_PORT
            for p in ports)

    def test_dag_edges(self):
        job = set_defaults_torchjob(make_job())
        worker_dag = job.spec.tasks[TaskType.WORKER].dag_conditions
        assert worker_dag == [DAGCondition(upstream=TaskType.MASTER, on_phase="Running")]

    def test_min_members_populated(self):
        job = set_defaults_torchjob(make_job(workers=4, topo="4x4"))
        mm = job.spec.run_policy.scheduling_policy.min_members
        assert mm[TaskType.WORKER] == 4
        assert mm[TaskType.MASTER] == 1

    def test_elastic_clamps_workers(self):
        job = make_job(workers=1, elastic=ElasticPolicy(min_replicas=2, max_replicas=8))
        set_defaults_torchjob(job)
        assert job.spec.tasks[TaskType.WORKER].num_tasks == 2

    def test_elastic_snaps_to_legal_quanta(self):
        # No 3-host slice exists: min snaps up to 4, max 5 snaps down to 4.
        job = make_job(workers=1, elastic=ElasticPolicy(min_replicas=3, max_replicas=5))
        set_defaults_torchjob(job)
        ep = job.spec.elastic_policy
        assert (ep.min_replicas, ep.max_replicas) == (4, 4)
        assert job.spec.tasks[TaskType.WORKER].num_tasks == 4

    def test_min_members_full_gang_multislice(self):
        job = make_job(workers=8, topo="4x4")
        job.spec.gpu_policy.num_slices = 2
        set_defaults_torchjob(job)
        assert job.spec.run_policy.scheduling_policy.min_members[TaskType.WORKER] == 8

    def test_empty_template_gets_container(self):
        job = TorchJob(spec=TorchJobSpec(tasks={TaskType.WORKER: TaskSpec()}))
        set_defaults_torchjob(job)
        c = job.spec.tasks[TaskType.WORKER].template.spec.containers
        assert c and c[0].name == constants.DEFAULT_CONTAINER_NAME == "torch"


class TestConditions:
    def test_running_demotes_queuing(self):
        job = make_job()
        conditions.update_job_conditions(job.status, JobConditionType.QUEUING)
        conditions.update_job_conditions(job.status, JobConditionType.RUNNING)
        assert conditions.is_running(job.status)
        q = conditions.get_condition(job.status, JobConditionType.QUEUING)
        assert q.status == "False"

    def test_terminal_demotes_running(self):
        job = make_job()
        conditions.update_job_conditions(job.status, JobConditionType.RUNNING)
        conditions.update_job_conditions(job.status, JobConditionType.SUCCEEDED)
        assert conditions.is_succeeded(job.status)
        assert not conditions.is_running(job.status)
        assert conditions.is_finished(job.status)

    def test_idempotent_update_reports_no_change(self):
        job = make_job()
        assert conditions.update_job_conditions(job.status, JobConditionType.CREATED, "r", "m")
        assert not conditions.update_job_conditions(job.status, JobConditionType.CREATED, "r", "m")

    def test_needs_enqueue(self):
        job = make_job()
        conditions.mark_created(job)
        assert conditions.needs_coordinator_enqueue(job.status)
        conditions.update_job_conditions(job.status, JobConditionType.RUNNING)
        assert not conditions.needs_coordinator_enqueue(job.status)

    def test_gen_general_name(self):
        assert conditions.gen_general_name("j", TaskType.WORKER, 3) == "j-worker-3"


def _hosts(acc, topo):
    return topology.hosts_per_slice(PORT_ACCELERATOR, port_topology(acc, topo))


class TestTopology:
    """Each reference case on the port's H100 table, its slices mapped by
    host count: the numbers it pins hold unchanged."""

    def test_v5e_hosts(self):
        assert _hosts("tpu-v5-lite-podslice", "4x4") == 4
        assert _hosts("tpu-v5-lite-podslice", "2x4") == 2
        assert _hosts("tpu-v5-lite-podslice", "2x2") == 1
        assert _hosts("tpu-v5-lite-podslice", "16x16") == 64
        assert topology.hosts_per_slice(PORT_ACCELERATOR, "1x8") == 1
        assert topology.hosts_per_slice(PORT_ACCELERATOR, "64x8") == 64

    def test_v4_hosts(self):
        assert _hosts("tpu-v4-podslice", "2x2x2") == 2
        assert _hosts("tpu-v4-podslice", "4x4x4") == 16

    def test_legal_host_counts_monotone(self):
        counts = topology.legal_host_counts(PORT_ACCELERATOR)
        assert counts == sorted(set(counts))
        assert 1 in counts and 4 in counts
        assert counts == rtopology.legal_host_counts(REF_ACCELERATOR)

    def test_next_legal_up_down(self):
        assert topology.next_legal_host_count(PORT_ACCELERATOR, 4) == 8
        assert topology.next_legal_host_count(PORT_ACCELERATOR, 4, direction=-1) == 2
        assert topology.next_legal_host_count(PORT_ACCELERATOR, 64) is None

    def test_snap(self):
        assert topology.snap_host_count(PORT_ACCELERATOR, 3) == 4
        assert topology.snap_host_count(PORT_ACCELERATOR, 1000) == 64

    def test_topology_for_hosts(self):
        assert topology.topology_for_hosts(PORT_ACCELERATOR, 4) == \
            port_topology(REF_ACCELERATOR, "4x4") == "4x8"

    def test_validate_rejects_bogus(self):
        with pytest.raises(ValueError):
            topology.validate_slice(PORT_ACCELERATOR, "3x5")
        with pytest.raises(KeyError):
            topology.chips_per_host("tpu-v99")

    def test_malformed_topology(self):
        with pytest.raises(ValueError):
            topology.parse_topology("4xx4")


@pytest.mark.parametrize("hosts", range(0, 70))
def test_host_count_decisions_equal_the_reference(hosts):
    """Every snap, next-legal and smallest-topology decision the controllers
    make on a host count is the reference default's, through the map."""
    if hosts >= 1:
        assert topology.snap_host_count(PORT_ACCELERATOR, hosts) == \
            rtopology.snap_host_count(REF_ACCELERATOR, hosts)
    for d in (+1, -1):
        assert topology.next_legal_host_count(PORT_ACCELERATOR, hosts,
                                              direction=d) == \
            rtopology.next_legal_host_count(REF_ACCELERATOR, hosts,
                                            direction=d)
    mine = topology.topology_for_hosts(PORT_ACCELERATOR, hosts)
    ref = rtopology.topology_for_hosts(REF_ACCELERATOR, hosts)
    if ref is None:
        assert mine is None
    else:
        assert topology.hosts_per_slice(PORT_ACCELERATOR, mine) == \
            rtopology.hosts_per_slice(REF_ACCELERATOR, ref)


def test_mesh_shapes_follow_the_gpu_count():
    assert topology.slice_chips(PORT_ACCELERATOR, "4x8", 2) == 64
    assert topology.mesh_shape_for_slice(PORT_ACCELERATOR, "2x8",
                                         model=8) == {
        "data": 1, "fsdp": 2, "model": 8, "expert": 1}
    with pytest.raises(ValueError, match="16 chips"):
        topology.validate_mesh_for_slice(PORT_ACCELERATOR, "2x8",
                                         {"fsdp": 8})
    spec = topology.format_reshard_spec(3, 4, {"fsdp": 32, "data": 1})
    assert spec == rtopology.format_reshard_spec(3, 4, {"fsdp": 32})
    assert topology.parse_reshard_spec(spec) == (3, 4, {"fsdp": 32})


def test_job_requests_count_gpus():
    job = make_job(workers=2)
    for task in job.spec.tasks.values():
        task.template.spec.containers[0].resources.requests = {
            constants.RESOURCE_GPU: 8.0, "cpu": 4.0}
    assert resmath.job_requests(job) == {"nvidia.com/gpu": 24.0, "cpu": 12.0}


def test_feature_gates_name_the_torch_gate():
    gates = features.FeatureGates.parse("TorchLocalMasterAddr=false")
    assert not gates.enabled(features.LOCAL_MASTER_ADDR)
    assert gates.enabled(features.GANG_SCHEDULING)
    with pytest.raises(KeyError):
        gates.enabled("TPULocalMasterAddr")


# ---- the registry round trip of tests/test_wire_roundtrip.py -----------------

globals().update(reference_cases("test_wire_roundtrip"))


def test_registry_is_the_reference_registry_mapped():
    ref = {(port_kind(r.kind), _map_str(r.group, REF_TO_PORT, _SUBSTR),
            r.version, _map_str(r.plural, REF_TO_PORT, _SUBSTR),
            r.namespaced) for r in rresources.all_types()}
    mine = {(r.kind, r.group, r.version, r.plural, r.namespaced)
            for r in resources.all_types()}
    assert mine == ref
    assert resources.by_kind("TorchJob").collection_path("ns") == \
        "/apis/distributed.torch.io/v1alpha1/namespaces/ns/torchjobs"


# ---- seeded differential round trip -------------------------------------------

_BASE = dt.datetime(2026, 7, 30, 11, 0, 5, tzinfo=dt.timezone.utc)
_LABELS = [RC.LABEL_JOB_NAME, RC.LABEL_TASK_TYPE, RC.ANNOTATION_WORLD_SIZE,
           RC.ANNOTATION_CKPT_REQUESTED_VERSION, RC.LABEL_SERVING_IMAGE_HASH]
_KEYS = {"labels": _LABELS, "annotations": _LABELS,
         "node_selector": [RC.NODE_SELECTOR_TPU_ACCELERATOR],
         "requests": [RC.RESOURCE_TPU, "cpu"],
         "limits": [RC.RESOURCE_TPU, "memory"],
         "hard": [RC.RESOURCE_TPU], "used": [RC.RESOURCE_TPU]}
_STRINGS = {"finalizers": [RC.FINALIZER_PREEMPT_PROTECTOR],
            "name": [RC.DEFAULT_CONTAINER_NAME, RC.DEFAULT_PORT_NAME,
                     RC.ENV_PROCESS_ID, RC.ENV_NUM_PROCESSES],
            "kind": [RC.KIND_TPUJOB],
            "api_version": [f"{RC.API_GROUP}/{RC.API_VERSION}"]}


class _Seeded:
    """``test_wire_roundtrip._build`` with seeded values: every field set,
    strings drawn from the mapped constants or seeded tokens, the slice
    binding from the reference default's legal topologies."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def _str(self, name: str) -> str:
        pool = _STRINGS.get(name)
        if pool and self.rng.random() < 0.5:
            return str(self.rng.choice(pool))
        return f"s{int(self.rng.integers(0, 10**6))}"

    def value(self, tp, depth: int, name: str = ""):
        origin = get_origin(tp)
        if origin is typing.Union:
            args = [a for a in get_args(tp) if a is not type(None)]
            return self.value(args[0], depth, name)
        if origin is list:
            (elem,) = get_args(tp) or (str,)
            return [self.value(elem, depth + 1, name)
                    for _ in range(int(self.rng.integers(1, 3)))]
        if origin is dict:
            kt, vt = get_args(tp) or (str, str)
            out = {}
            for _ in range(int(self.rng.integers(1, 3))):
                pool = _KEYS.get(name)
                if kt is str and pool is not None:
                    key = str(self.rng.choice(pool))
                else:
                    key = self.value(kt, depth + 1, name)
                out[key] = self.value(vt, depth + 1, name)
            return out
        if tp is list:
            return [self._str(name)]
        if tp is dict:
            return {"k": "v"}
        if isinstance(tp, type):
            if dataclasses.is_dataclass(tp):
                return self.build(tp, depth + 1)
            if issubclass(tp, enum.Enum):
                return list(tp)[int(self.rng.integers(0, len(tp)))]
            if tp is bool:
                return bool(self.rng.integers(0, 2))
            if tp is int:
                return int(self.rng.integers(1, 1000))
            if tp is float:
                return float(self.rng.integers(1, 1000))
            if tp is str:
                return self._str(name)
            if tp is dt.datetime:
                return _BASE + dt.timedelta(
                    seconds=int(self.rng.integers(0, 10**6)),
                    microseconds=int(self.rng.integers(0, 10**6)))
        return None

    def build(self, cls, depth: int = 0):
        if depth > 6:
            return cls()
        kwargs = {}
        hints = typing.get_type_hints(cls)
        for f in dataclasses.fields(cls):
            if f.name in ("api_version", "kind"):
                continue
            kwargs[f.name] = self.value(hints[f.name], depth, f.name)
        if cls is rtypes.TPUPolicy:
            legal = rtopology.legal_topologies(REF_ACCELERATOR)
            kwargs.update(accelerator=REF_ACCELERATOR,
                          topology=str(self.rng.choice(legal)))
        return cls(**kwargs)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("rt", rresources.all_types(), ids=lambda r: r.kind)
def test_seeded_wire_round_trip_through_the_port_equals_the_reference(
        rt, seed):
    """A seeded reference object's wire dict, mapped onto the port, decoded
    and encoded by the port's codec and mapped back, is the reference's
    wire dict: every hook (volume sources, container state, Lease
    MicroTime, PV quantities, fieldRef env) speaks the same bytes."""
    obj = _Seeded(seed * 100 + len(rt.kind)).build(rt.cls)
    mine = resources.by_kind(port_kind(rt.kind))
    for drop_none in (False, True):
        wire = rserde.to_dict(obj, drop_none=drop_none, wire=True)
        back = serde.from_dict(mine.cls, to_port_wire(wire))
        again = serde.to_dict(back, drop_none=drop_none, wire=True)
        assert to_ref_wire(again) == wire
        # and the port's snake_case deep copy is the reference's, mapped
        assert serde.to_dict(serde.deep_copy(back), drop_none=drop_none) == \
            to_port_wire(rserde.to_dict(obj, drop_none=drop_none))


def _seeded_job(seed: int) -> rtypes.TPUJob:
    """A reference job spec from a seed: some task types, task counts from 0,
    restart policies, containers named or not, an elastic policy or none, a
    legal slice, scheduling floors given or not."""
    rng = np.random.default_rng(seed)
    kinds = [t for t in rtypes.TaskType if rng.random() < 0.7] or \
        [rtypes.TaskType.WORKER]
    tasks = {}
    for t in kinds:
        containers = []
        if rng.random() < 0.7:
            name = str(rng.choice(["", RC.DEFAULT_CONTAINER_NAME, "main"]))
            ports = [RC.DEFAULT_PORT_NAME] if rng.random() < 0.3 else []
            containers.append(rcore.Container(
                name=name, image="i",
                ports=[rcore.ContainerPort(name=p, container_port=9000)
                       for p in ports]))
        tasks[str(t.value).lower() if rng.random() < 0.2 else t] = \
            rtypes.TaskSpec(
                num_tasks=int(rng.integers(0, 10)),
                restart_policy=(None if rng.random() < 0.6 else
                                list(rtypes.RestartPolicy)[
                                    int(rng.integers(0, 4))]),
                template=rcore.PodTemplateSpec(
                    spec=rcore.PodSpec(containers=containers)))
    elastic = None
    if rng.random() < 0.6:
        elastic = rtypes.ElasticPolicy(
            min_replicas=int(rng.integers(0, 10)),
            max_replicas=int(rng.integers(0, 80)),
            nproc_per_node=int(rng.integers(0, 3)),
            rendezvous_backend=str(rng.choice(["", "xla", "c10d"])))
    run = rtypes.RunPolicy()
    if rng.random() < 0.4:
        run.scheduling_policy = rtypes.SchedulingPolicy(
            min_members={rtypes.TaskType.WORKER: int(rng.integers(1, 5))})
    return rtypes.TPUJob(
        metadata=rcore.ObjectMeta(name=f"job-{seed}"),
        spec=rtypes.TPUJobSpec(
            tasks=tasks, elastic_policy=elastic, run_policy=run,
            tpu_policy=rtypes.TPUPolicy(
                accelerator=REF_ACCELERATOR,
                topology=str(rng.choice(
                    rtopology.legal_topologies(REF_ACCELERATOR))),
                num_slices=int(rng.integers(1, 3)))))


@pytest.mark.parametrize("seed", range(24))
def test_defaults_equal_the_reference_on_seeded_specs(seed):
    """``set_defaults_torchjob`` on a seeded spec is ``set_defaults_tpujob``
    on the same spec, through the map: restart policies, the default
    container and port, the DAG edges, the elastic bounds snapped through
    the topology, and the gang floors."""
    ref = _seeded_job(seed)
    before = rserde.to_dict(ref, drop_none=False)
    mine = serde.from_dict(TorchJob, to_port_wire(before))
    rdefaults.set_defaults_tpujob(ref)
    set_defaults_torchjob(mine)
    assert serde.to_dict(mine, drop_none=False) == to_port_wire(
        rserde.to_dict(ref, drop_none=False))


def test_extract_meta_fields_and_scheduling_policy():
    from tpu_on_k8s_torch.api.types import extract_meta_fields
    job = set_defaults_torchjob(make_job())
    tasks, status, policy = extract_meta_fields(job)
    assert tasks is job.spec.tasks and status is job.status
    assert isinstance(policy, SchedulingPolicy)
    assert ContainerPort(name="torchjob-port", container_port=8476) in \
        job.spec.tasks[TaskType.WORKER].template.spec.containers[0].ports
