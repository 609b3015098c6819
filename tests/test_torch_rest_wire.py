"""The port's wire bytes and its TLS and token paths on the CPU.

* ``tests/test_golden_wire.py`` runs against the port through
  ``test_torch_api.reference_cases``: the core kinds' fixtures under
  ``tests/fixtures/wire/`` as they stand (Pod create, get and list, labels
  merge-patch, Lease, PersistentVolume, Service, watch frames, the 410
  re-list, quantity strings). Its four TPUJob cases run here in the GPU
  flavour on the same fixtures through ``to_port_wire``: the job's status
  PUT, its finalizer merge-patch, its DELETE and the graceful-delete
  response decode byte for byte.
* ``tests/test_tls_over_rest.py`` runs against the port whole: HTTPS with a
  self-signed CA, bearer tokens (missing, wrong, rotated on disk), mutual
  TLS, and kubeconfig credentials resolution.
"""
from __future__ import annotations

import json
from pathlib import Path

from test_torch_api import reference_cases, to_port_wire
from tpu_on_k8s.api import constants as RC
from tpu_on_k8s_torch.api.core import Pod
from tpu_on_k8s_torch.api.types import TaskType, TorchJob
from tpu_on_k8s_torch.client.rest import RestCluster
from tpu_on_k8s_torch.utils import serde

_JOB_CASES = ("test_merge_patch_requests", "test_status_put_request_bytes",
              "test_delete_request",
              "test_decode_list_and_graceful_delete_response")
_golden = reference_cases("test_golden_wire", skip=_JOB_CASES)
globals().update(_golden)
globals().update(reference_cases("test_tls_over_rest"))

FIXTURES = Path(__file__).parent / "fixtures" / "wire"


def fixture(name: str) -> dict:
    return json.loads((FIXTURES / name).read_text())


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"test_create_request_bytes", "test_lease_wire_is_coordination_v1",
            "test_watch_stream_frames", "test_lifecycle_over_tls_with_bearer_token",
            "test_kubeconfig_credentials_resolution"} <= names
    assert not set(_JOB_CASES) & set(_golden)


def job_fixture(name: str) -> dict:
    """A TPUJob-bearing fixture, mapped onto the port's wire."""
    return to_port_wire(fixture(name))


def test_the_job_fixtures_map_onto_the_port():
    fx = job_fixture("tpujob_status_put_request.json")
    assert fx["path"] == ("/apis/distributed.torch.io/v1alpha1/namespaces/"
                          "default/torchjobs/mnist/status")
    body = fx["body"]
    assert (body["apiVersion"], body["kind"]) == (
        "distributed.torch.io/v1alpha1", "TorchJob")
    assert body["spec"]["gpuPolicy"] == {
        "accelerator": "nvidia-h100-80gb", "topology": "2x8", "numSlices": 1}
    assert "tpuPolicy" not in body["spec"]
    assert body["metadata"]["finalizers"] == ["distributed.torch.io/job-gc"]


def test_merge_patch_requests(server):
    script, url = server
    fx = fixture("merge_patch_requests.json")
    lp, fp = fx["labels_patch"], to_port_wire(fx["finalizer_patch"])
    pod_body = fixture("pod_get_response.json")["body"]
    script.canned("PATCH", lp["path"], 200, pod_body)
    job_body = job_fixture("tpujob_status_put_request.json")["body"]
    script.canned("GET", fp["path"], 200, job_body)
    script.canned("PATCH", fp["path"], 200, job_body)

    cluster = RestCluster(url)
    cluster.patch_meta(Pod, "default", "mnist-worker-0",
                       labels={"distributed.tpu.io/slice": "pool-a-s0",
                               "stale-label": None})
    cluster.patch_meta(TorchJob, "default", "mnist",
                       add_finalizers=[to_port_wire(
                           f"{RC.API_GROUP}/job-gc")])

    method, path, ctype, body = script.requests[0]
    assert (method, path, ctype) == (lp["method"], lp["path"],
                                     lp["contentType"])
    assert body == lp["body"]
    method, path, ctype, body = script.requests[2]
    assert (method, path, ctype) == (fp["method"], fp["path"],
                                     fp["contentType"])
    assert body == fp["body"]
    assert isinstance(body["metadata"]["resourceVersion"], str)


def test_status_put_request_bytes(server):
    script, url = server
    fx = job_fixture("tpujob_status_put_request.json")
    script.canned("PUT", fx["path"], 200, fx["body"])
    cluster = RestCluster(url)
    job = serde.from_dict(TorchJob, fx["body"])
    cluster.update(job, subresource="status")
    method, path, ctype, body = script.requests[0]
    assert (method, path, ctype) == (fx["method"], fx["path"],
                                     fx["contentType"])
    assert body == fx["body"]


def test_delete_request(server):
    script, url = server
    fx = job_fixture("pod_delete_response.json")
    script.canned("DELETE", fx["request"]["path"], 200, fx["body"])
    cluster = RestCluster(url)
    cluster.delete(TorchJob, "default", "mnist")
    method, path, _, body = script.requests[0]
    assert (method, path) == (fx["request"]["method"], fx["request"]["path"])
    assert body is None, "DELETE must not carry a body"


def test_decode_list_and_graceful_delete_response():
    body = fixture("pod_list_response.json")["body"]
    assert int(body["metadata"]["resourceVersion"]) == 48300
    item = serde.from_dict(Pod, body["items"][0])
    assert item.status.is_ready()
    assert item.status.pod_ip == "10.8.0.4"

    del_body = job_fixture("pod_delete_response.json")["body"]
    job = serde.from_dict(TorchJob, del_body)
    assert job.metadata.deletion_timestamp is not None
    assert job.metadata.finalizers == ["distributed.torch.io/job-gc"]
    assert job.spec.tasks[TaskType.WORKER].num_tasks == 4
    assert job.spec.tasks[TaskType.WORKER].template.spec.containers[0].name \
        == "torch"
