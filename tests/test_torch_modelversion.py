"""The port's ModelVersion controller (``controller/modelversion.py``)
against the reference on the CPU.

* ``tests/test_modelversion.py`` runs against the port through
  ``test_torch_api.reference_cases``: a finished job's ``ModelVersion`` →
  the ``Model`` that owns it → the PV and PVC from the storage provider →
  the ``dockerfile`` ConfigMap → the build pod → its phase →
  ``Model.status.latest_version_name``, for NFS, local and GCS storage.
* ``tests/test_modelversion_over_rest.py`` runs as it is over the port's
  ``ApiServer`` and ``RestCluster``, the controllers on a ``Manager`` wired
  by hand (``test_torch_elastic.HandWired``; the reference's case builds
  ``tpu_on_k8s.main.Operator``, which the port has not yet).
* The controller's objects are equal to the reference's under
  ``to_port_wire``, the version label ``model.distributed.torch.io/
  model-version-name`` among them.
"""
from __future__ import annotations

import torch

from test_torch_api import reference_cases, slice_literals, to_port_wire
from test_torch_elastic import HAND_WIRED, port_module

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

globals().update(reference_cases("test_modelversion", subs=(slice_literals,)))
reference_cases("test_elastic", only=(), subs=(slice_literals,))
globals().update(reference_cases(
    "test_modelversion_over_rest",
    subs=(slice_literals, *HAND_WIRED, port_module("test_elastic"))))


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestPipeline", "test_job_success_builds_model_image_over_rest"} <= names


def test_pipeline_objects_equal_the_reference():
    """One version through both packages' controllers: the Model, PV, PVC,
    ConfigMap, build pod, events and the statuses after the build pod
    succeeds are equal under ``to_port_wire``."""
    from tpu_on_k8s.api import core as rcore
    from tpu_on_k8s.api import model_types as rmodel
    from tpu_on_k8s.client import cluster as rcluster
    from tpu_on_k8s.client import testing as rtesting
    from tpu_on_k8s.controller import modelversion as rmv
    from tpu_on_k8s.controller import runtime as rruntime
    from tpu_on_k8s.storage import PersistentVolume as RPV
    from tpu_on_k8s.storage import PersistentVolumeClaim as RPVC
    from tpu_on_k8s.utils import serde as rserde
    from tpu_on_k8s_torch.api import core as pcore
    from tpu_on_k8s_torch.api import model_types as pmodel
    from tpu_on_k8s_torch.client import cluster as pcluster
    from tpu_on_k8s_torch.client import testing as ptesting
    from tpu_on_k8s_torch.controller import modelversion as pmv
    from tpu_on_k8s_torch.controller import runtime as pruntime
    from tpu_on_k8s_torch.storage import PersistentVolume as PPV
    from tpu_on_k8s_torch.storage import PersistentVolumeClaim as PPVC
    from tpu_on_k8s_torch.utils import serde as pserde

    assert pmv.LABEL_MODEL_VERSION == to_port_wire(rmv.LABEL_MODEL_VERSION) \
        == "model.distributed.torch.io/model-version-name"

    def run(core, model, cluster_mod, testing, mv, runtime, pv, pvc, serde):
        cluster = cluster_mod.InMemoryCluster()
        manager = runtime.Manager()
        mv.setup_modelversion_controller(cluster, manager)
        cluster.create(model.ModelVersion(
            metadata=core.ObjectMeta(name="mv1"),
            spec=model.ModelVersionSpec(
                model_name="m1", image_repo="reg.example/m1", image_tag="v1",
                storage=model.Storage(local_storage=model.LocalStorage(
                    path="/models", node_name="node-a")))))
        manager.run_until_idle()
        testing.KubeletSim(cluster).succeed_pod("default", "mv1-image-build")
        manager.run_until_idle()
        out = {}
        for cls in (model.Model, model.ModelVersion, core.ConfigMap,
                    core.Pod, pv, pvc):
            out[cls.__name__] = [
                serde.to_dict(o, drop_none=False, wire=True)
                for o in sorted(cluster.list(cls), key=lambda o: o.metadata.name)]
        out["events"] = [e.reason for e in cluster.list(core.Event, "default")]
        return out

    def stamps(x):
        if isinstance(x, dict):
            return {k: (v is not None) if k.endswith(("Timestamp", "Time"))
                    or k in ("uid", "resourceVersion")
                    else stamps(v) for k, v in x.items()}
        if isinstance(x, list):
            return [stamps(v) for v in x]
        return x

    want = run(rcore, rmodel, rcluster, rtesting, rmv, rruntime, RPV, RPVC,
               rserde)
    got = run(pcore, pmodel, pcluster, ptesting, pmv, pruntime, PPV, PPVC,
              pserde)
    assert got["ModelVersion"][0]["status"]["imageBuildPhase"] == "ImageBuildSucceeded"
    assert stamps(got) == stamps(to_port_wire(want))
