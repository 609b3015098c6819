"""The port's InferenceService controller (``controller/inferenceservice.py``)
against the reference on the CPU.

* ``tests/test_inferenceservice.py`` runs against the port through
  ``test_torch_api.reference_cases``, its slice literals mapped by host
  count: deploys from a Model's latest image, pending until one is
  published, multi-host gangs, the rolling rollout's surge / drain /
  delete order, the ready floor, failed and lost gangs, scale-down drains,
  and the decode and sharding policies that roll the fleet. Its first
  case asserts the TPU scheduling surface (the topology node selector and
  ``google.com/tpu``); its twin here asserts the GPU flavour: a whole
  host's ``nvidia.com/gpu`` (8), the accelerator selector alone, and no
  env or selector name that says TPU.
* ``decode_variant``'s cases of ``tests/test_speculative.py`` (the
  DecodePolicy wire round trip and its rollout identity) and
  ``tests/test_serve_shard.py::test_sharding_policy_identity_and_normalization``,
  their functions run against the port as they are written.
* A seeded differential: 30 InferenceServices, each on its own cluster in
  both packages, go through both reconcilers over a ``KubeletSim`` on one
  fake clock, with image, decode, sharding, model-pool and replica edits,
  a failed and a lost pod, and the drain deadlines passing. After every
  step the pods' names, labels, annotations, images and args, the events
  and the service's status are equal under ``to_port_wire``; every port
  pod carries the GPU flavour's resources, selector and env.
"""
from __future__ import annotations

import re
import sys

import numpy as np
import pytest

import tpu_on_k8s.api.constants as RC
from test_torch_api import (
    PORT_ACCELERATOR,
    REF_ACCELERATOR,
    port_topology,
    reference_cases,
    reference_functions,
    slice_literals,
    to_port_wire,
)
from tpu_on_k8s.api import core as rcore
from tpu_on_k8s.api import inference_types as rit
from tpu_on_k8s.api import model_types as rmt
from tpu_on_k8s.api import types as rtypes
from tpu_on_k8s.client import InMemoryCluster as RCluster
from tpu_on_k8s.client import KubeletSim as RSim
from tpu_on_k8s.controller import inferenceservice as rctl
from tpu_on_k8s.controller.runtime import Manager as RManager
from tpu_on_k8s.gang import topology as rtopology
from tpu_on_k8s.utils import serde as rserde
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api import core as pcore
from tpu_on_k8s_torch.api import inference_types as pit
from tpu_on_k8s_torch.api import model_types as pmt
from tpu_on_k8s_torch.client import InMemoryCluster as PCluster
from tpu_on_k8s_torch.client import KubeletSim as PSim
from tpu_on_k8s_torch.controller import inferenceservice as pctl
from tpu_on_k8s_torch.controller.runtime import Manager as PManager
from tpu_on_k8s_torch.utils import serde as pserde

#: the reference's case that asserts the TPU scheduling surface -> its twin
TWINS = {"test_deploys_replicas_from_model_latest_image":
         "test_deploys_replicas_with_the_gpu_scheduling_surface"}

globals().update(reference_cases("test_inferenceservice", skip=tuple(TWINS),
                                 subs=(slice_literals,)))
IS = sys.modules["_port_test_inferenceservice"]


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    for case in ("test_pending_without_image_then_deploys_when_model_publishes",
                 "test_multi_host_slice_is_one_gang",
                 "test_rolling_rollout_surge_drain_delete_order",
                 "test_ready_floor_respected_while_new_not_ready",
                 "test_failed_gang_recreated", "test_lost_gang_pod_is_recreated",
                 "test_scale_down_drains_surplus",
                 "test_decode_policy_change_rolls_the_fleet",
                 "test_sharding_policy_change_rolls_the_fleet",
                 "test_trivial_sharding_policy_is_not_a_rollout"):
        assert case in names, case
    for case, twin in TWINS.items():
        assert case not in names and twin in names


def _tpu_names(pod) -> list:
    """Every env, selector and resource name of a pod that says TPU."""
    names = [e.name for c in pod.spec.containers for e in c.env]
    names += list(pod.spec.node_selector)
    names += [r for c in pod.spec.containers
              for r in (*c.resources.requests, *c.resources.limits)]
    return [n for n in names if re.search("tpu", n, re.I)]


def assert_gpu_flavour(pod) -> None:
    """A replica pod of the GPU flavour: a whole host's GPUs requested and
    limited, the accelerator selector alone, PYTHONUNBUFFERED the only env,
    and its host index in the task-index label."""
    [c] = pod.spec.containers
    assert c.resources.requests[constants.RESOURCE_GPU] == 8
    assert c.resources.limits[constants.RESOURCE_GPU] == 8
    assert pod.spec.node_selector == {
        constants.NODE_SELECTOR_GPU_ACCELERATOR: PORT_ACCELERATOR}
    assert [(e.name, e.value) for e in c.env] == [
        (constants.ENV_PYTHONUNBUFFERED, "1")]
    assert constants.LABEL_TASK_INDEX in pod.metadata.labels
    assert _tpu_names(pod) == []


def test_deploys_replicas_with_the_gpu_scheduling_surface():
    """The reference's first case with the GPU flavour's scheduling
    surface in place of the TPU one; every other assertion kept."""
    cluster, manager, sim, clock = IS.make_env()
    IS.make_model(cluster)
    IS.make_svc(cluster, replicas=2)
    manager.run_until_idle()
    pods = IS.svc_pods(cluster)
    assert len(pods) == 2                       # 1x4 = 1 host
    h = pctl.image_hash("reg.local/m1:v1")
    for p in pods:
        assert p.spec.containers[0].image == "reg.local/m1:v1"
        assert p.metadata.labels[constants.LABEL_SERVING_IMAGE_HASH] == h
        assert constants.ANNOTATION_GANG_GROUP_NAME in p.metadata.annotations
        assert_gpu_flavour(p)
        assert p.metadata.labels[constants.LABEL_TASK_INDEX] == "0"
        assert any(r.kind == "InferenceService"
                   for r in p.metadata.owner_references)
    svc = cluster.get(pit.InferenceService, "default", "svc")
    assert svc.status.phase is pit.ServicePhase.PROGRESSING
    assert svc.status.replicas == 2 and svc.status.ready_replicas == 0

    sim.run_all("default")
    manager.run_until_idle()
    svc = cluster.get(pit.InferenceService, "default", "svc")
    assert svc.status.phase is pit.ServicePhase.READY
    assert svc.status.ready_replicas == 2
    assert svc.status.current_image == "reg.local/m1:v1"
    assert svc.status.canary_weight == 1.0


def test_multi_host_gang_pods_carry_their_host_index_only_in_a_label():
    """A 4-host replica (``4x8``): the reference tells each host its index
    through ``TPU_WORKER_ID``; the GPU flavour writes no such env, and the
    hosts are told apart by ``task-index`` 0-3 and their pod names."""
    cluster, manager, sim, clock = IS.make_env()
    IS.make_model(cluster)
    IS.make_svc(cluster, replicas=1, topology="4x8")
    manager.run_until_idle()
    pods = IS.svc_pods(cluster)
    assert sorted(p.metadata.labels[constants.LABEL_TASK_INDEX]
                  for p in pods) == ["0", "1", "2", "3"]
    for p in pods:
        assert_gpu_flavour(p)
        assert p.metadata.name.endswith(
            f"-h{p.metadata.labels[constants.LABEL_TASK_INDEX]}")


# ---- decode_variant: the reference's cases as written ---------------------------

def test_decode_policy_yaml_and_wire_roundtrip():
    """``tests/test_speculative.py``'s DecodePolicy case: its wire and YAML
    round trip and ``decode_variant``'s rollout identity."""
    yaml = pytest.importorskip("yaml")
    reference_functions(
        "test_speculative", ["test_decode_policy_yaml_and_wire_roundtrip"],
        {"yaml": yaml})["test_decode_policy_yaml_and_wire_roundtrip"]()


def test_sharding_policy_identity_and_normalization():
    """``tests/test_serve_shard.py``'s ShardingPolicy identity case."""
    name = "test_sharding_policy_identity_and_normalization"
    reference_functions("test_serve_shard", [name], {})[name]()


@pytest.mark.parametrize("seed", range(4))
def test_decode_variant_equals_the_reference(seed):
    """Seeded decode, sharding and pool policies: the rollout identity and
    its image hash are the reference's, string for string."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        img = f"reg.local/m{int(rng.integers(3))}:v{int(rng.integers(5))}"
        d = None if rng.random() < 0.3 else dict(
            draft_model=["", "d", "gpt2-draft"][int(rng.integers(3))],
            spec_k=int(rng.integers(-1, 10)),
            int8_weights=bool(rng.random() < 0.5))
        s = None if rng.random() < 0.3 else dict(
            data=int(rng.integers(-1, 3)), model=int(rng.integers(-1, 5)),
            expert=int(rng.integers(0, 3)),
            rules=["serving", "bogus", "serving"][int(rng.integers(3))])
        pooled = bool(rng.random() < 0.3)
        want = rctl.decode_variant(
            img, None if d is None else rit.DecodePolicy(**d),
            None if s is None else rit.ShardingPolicy(**s), pooled=pooled)
        got = pctl.decode_variant(
            img, None if d is None else pit.DecodePolicy(**d),
            None if s is None else pit.ShardingPolicy(**s), pooled=pooled)
        assert got == want
        assert pctl.image_hash(got) == rctl.image_hash(want)


# ---- the seeded differential ------------------------------------------------------

class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


#: the edits the script draws from
EDITS = ("image", "decode", "sharding", "replicas", "models", "model_image",
         "fail", "lose", "advance")


def make_spec(seed: int) -> dict:
    """One service's description and its edit script, from a seed."""
    rng = np.random.default_rng(seed)
    topos = [t for t in rtopology.legal_topologies(REF_ACCELERATOR)
             if rtopology.hosts_per_slice(REF_ACCELERATOR, t) <= 4]
    return dict(
        seed=seed, topology=topos[int(rng.integers(len(topos)))],
        replicas=int(rng.integers(0, 4)),
        pinned=bool(rng.random() < 0.4),
        rollout=dict(max_surge=int(rng.integers(0, 3)),
                     max_unavailable=int(rng.integers(0, 2)),
                     canary_weight=float(rng.choice([0.0, 0.1, 0.25])),
                     drain_seconds=float(rng.choice([0.0, 2.0, 10.0]))),
        decode=(dict(int8_weights=True) if rng.random() < 0.2 else None),
        models=bool(rng.random() < 0.2),
        edits=[(EDITS[int(rng.integers(len(EDITS)))], int(rng.integers(1000)))
               for _ in range(int(rng.integers(5, 9)))])


def ref_service(spec: dict) -> rit.InferenceService:
    models = ([rit.ModelRef(name="a", model_name="m1"),
               rit.ModelRef(name="b", image="reg.local/b:v1")]
              if spec["models"] else [])
    return rit.InferenceService(
        metadata=rcore.ObjectMeta(name=f"s{spec['seed']}",
                                  uid=f"svc-{spec['seed']:05d}"),
        spec=rit.InferenceServiceSpec(
            model_name="" if spec["pinned"] else "m1",
            image="reg.local/pin:v1" if spec["pinned"] else "",
            replicas=spec["replicas"],
            tpu_policy=rtypes.TPUPolicy(accelerator=REF_ACCELERATOR,
                                        topology=spec["topology"]),
            rollout=rit.RolloutPolicy(**spec["rollout"]),
            decode=(None if spec["decode"] is None
                    else rit.DecodePolicy(**spec["decode"])),
            models=models))


class Side:
    """One package's reconciler on its own cluster, read back as wire
    dicts in the port's vocabulary."""

    def __init__(self, port: bool, spec: dict) -> None:
        self.port, self.spec = port, spec
        self.it, self.mt, self.core, self.serde = (
            (pit, pmt, pcore, pserde) if port else (rit, rmt, rcore, rserde))
        self.cluster = (PCluster if port else RCluster)()
        self.manager = (PManager if port else RManager)()
        self.clock = FakeClock()
        (pctl if port else rctl).setup_inferenceservice_controller(
            self.cluster, self.manager, clock=self.clock)
        self.sim = (PSim if port else RSim)(self.cluster)
        self.cluster.create(self.mt.Model(
            metadata=self.core.ObjectMeta(name="m1"),
            status=self.mt.ModelStatus(latest_version_name="mv-v1",
                                       latest_image="reg.local/m1:v1")))
        svc = ref_service(spec)
        if port:
            svc = pserde.from_dict(pit.InferenceService, to_port_wire(
                rserde.to_dict(svc, drop_none=False, wire=True)))
        self.cluster.create(svc)
        self.name = svc.metadata.name

    def pods(self) -> list:
        return sorted(self.cluster.list(self.core.Pod, "default"),
                      key=lambda p: p.metadata.name)

    def edit(self, kind: str, arg: int) -> None:
        it = self.it

        def mutate(s) -> None:
            if kind == "image":
                if s.spec.image:
                    s.spec.image = f"reg.local/pin:v{arg % 5 + 2}"
                else:
                    s.spec.model_name = "m2" if arg % 2 else "m1"
            elif kind == "decode":
                s.spec.decode = (None if arg % 3 == 0 else it.DecodePolicy(
                    int8_weights=bool(arg % 2), draft_model=(
                        "d" if arg % 3 == 1 else ""), spec_k=arg % 6))
            elif kind == "sharding":
                s.spec.sharding = (None if arg % 3 == 0 else
                                   it.ShardingPolicy(model=arg % 4 + 1))
            elif kind == "replicas":
                s.spec.replicas = arg % 4
            elif kind == "models":
                s.spec.models = ([] if arg % 3 == 0 else
                                 [it.ModelRef(name="a", model_name="m1"),
                                  it.ModelRef(name=f"c{arg % 2}",
                                              image=f"reg.local/c:v{arg}")])

        if kind in ("image", "decode", "sharding", "replicas", "models"):
            self.cluster.update_with_retry(it.InferenceService, "default",
                                           self.name, mutate)
        elif kind == "model_image":
            name = "m2" if arg % 2 else "m1"

            def publish(m) -> None:
                m.status.latest_image = f"reg.local/{name}:v{arg % 7}"
            if self.cluster.try_get(self.mt.Model, "default", name) is None:
                self.cluster.create(self.mt.Model(
                    metadata=self.core.ObjectMeta(name=name)))
            self.cluster.update_with_retry(self.mt.Model, "default", name,
                                           publish, subresource="status")
        elif kind in ("fail", "lose"):
            pods = [p for p in self.pods()
                    if p.metadata.deletion_timestamp is None]
            if pods:
                victim = pods[arg % len(pods)].metadata.name
                if kind == "fail":
                    self.sim.run_pod("default", victim)
                    self.sim.terminate_pod("default", victim, exit_code=137,
                                           reason="OOMKilled")
                else:
                    self.cluster.delete(self.core.Pod, "default", victim)
        elif kind == "advance":
            self.clock.t += float(arg % 12)

    def snapshot(self) -> dict:
        pods = []
        for p in self.pods():
            [c] = p.spec.containers
            pods.append(dict(name=p.metadata.name,
                             labels=dict(p.metadata.labels),
                             annotations=dict(p.metadata.annotations),
                             image=c.image, args=list(c.args),
                             phase=str(p.status.phase)))
            if self.port:
                assert_gpu_flavour(p)
        svc = self.cluster.try_get(self.it.InferenceService, "default",
                                   self.name)
        out = dict(pods=pods,
                   events=[list(e[1:]) for e in self.cluster.events],
                   status=self.serde.to_dict(svc.status, drop_none=False,
                                             wire=True))
        return out if self.port else to_port_wire(out)


def run_script(side: Side) -> list:
    snaps = []
    side.manager.run_until_idle()
    snaps.append(side.snapshot())
    side.sim.run_all("default")
    side.manager.run_until_idle()
    snaps.append(side.snapshot())
    for kind, arg in side.spec["edits"]:
        side.edit(kind, arg)
        side.manager.run_until_idle()
        snaps.append(side.snapshot())
        side.sim.run_all("default")
        side.manager.run_until_idle()
        snaps.append(side.snapshot())
    side.clock.t += 30.0           # every drain deadline passes
    side.manager.run_until_idle()
    side.sim.run_all("default")
    side.manager.run_until_idle()
    snaps.append(side.snapshot())
    return snaps


SEEDS = list(range(30))


@pytest.mark.parametrize("seed", SEEDS)
def test_reconcilers_agree_on_seeded_services(seed):
    spec = make_spec(seed)
    got = run_script(Side(True, spec))
    want = run_script(Side(False, spec))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, spec)


def test_the_differential_reaches_rollouts_drains_and_gangs():
    """The seeded services cover what the reconciler does: multi-host
    gangs, drains, a reaped replica, the model pool, and a rollout."""
    reasons, hosts = set(), set()
    for seed in SEEDS:
        spec = make_spec(seed)
        hosts.add(rtopology.hosts_per_slice(REF_ACCELERATOR, spec["topology"]))
        side = Side(True, spec)
        run_script(side)
        reasons |= {e[2] for e in side.cluster.events}
    assert {"ReplicaCreated", "ReplicaDraining", "ReplicaRemoved",
            "ModelPoolResolved"} <= reasons
    assert {1, 2, 4} <= hosts
    assert port_topology(REF_ACCELERATOR, "4x4") == "4x8"
    assert RC.NODE_SELECTOR_TPU_TOPOLOGY not in vars(constants).values()
