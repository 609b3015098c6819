"""The port's ``driver_bench`` on the CPU against the reference's
``tools/driver_bench.py``.

* ``bench_config`` patched to ``tiny`` (512 positions) in both packages:
  ``bench_decode``, ``bench_continuous`` and ``bench_speculative`` give the
  reference's JSON keys, and the continuous bench the reference's
  ``served``, ``decode_steps`` and ``slot_utilization`` (the same seeded
  traffic through both packages' engines).
* ``bench_resnet50`` at batch 2 for one step gives a positive rate;
  ``bench_submit_to_first_step`` over the port's REST operator gives its
  samples.
* The port's sample is the reference's ``config/samples/mnist_cnn.yaml``
  under ``to_port_wire``, its command the port's ``train_mnist``.
* The flags are the reference's, with ``--device``.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from tpu_on_k8s_torch import driver_bench, serve_load
from tpu_on_k8s_torch.models.transformer import TransformerConfig

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def tiny(monkeypatch):
    """Both packages' ``bench_config`` patched to ``tiny`` at 512
    positions (the continuous bench's engine holds 512)."""
    import bench
    from tpu_on_k8s.models.transformer import TransformerConfig as RConfig

    monkeypatch.setattr(bench, "bench_config", lambda: dataclasses.replace(
        RConfig.tiny(), attn_impl="flash", max_seq_len=512))
    monkeypatch.setattr(serve_load, "bench_config",
                        lambda: dataclasses.replace(
                            TransformerConfig.tiny(), attn_impl="flash",
                            max_seq_len=512))


@pytest.fixture(scope="module")
def ref_bench():
    from tools import driver_bench as ref
    return ref


def test_decode_keys_equal_the_reference(tiny, ref_bench):
    kw = dict(batch=2, prompt_len=16, new_tokens=4)
    got = driver_bench.bench_decode(device="cpu", **kw)
    want = ref_bench.bench_decode(**kw)
    assert list(got) == list(want)
    assert got["value"] > 0 and got["device_kind"] == "cpu"


@pytest.fixture
def ref_stats(monkeypatch):
    """The reference's engine with a ``stats`` dict that reads a missing key
    as 0. Its ``bench_continuous`` resets ``stats`` to three keys before
    the timed region, and the engine's next prefill then fails on
    ``stats["prefill_positions"]`` (a ``KeyError`` at any size); the port
    zeroes every key instead. Nothing else changes."""
    import collections

    from tpu_on_k8s.models import serving as rserving

    class Engine(rserving.ContinuousBatchingEngine):
        @property
        def stats(self):
            return self._stats

        @stats.setter
        def stats(self, value):
            self._stats = collections.defaultdict(int, value)

    monkeypatch.setattr(rserving, "ContinuousBatchingEngine", Engine)


def test_continuous_serves_as_the_reference(tiny, ref_stats, ref_bench):
    kw = dict(n_requests=4, new_tokens=4)
    got = driver_bench.bench_continuous(device="cpu", **kw)
    want = ref_bench.bench_continuous(**kw)
    assert list(got) == list(want)
    for key in ("served", "decode_steps", "slot_utilization", "n_slots",
                "n_requests", "step_horizon"):
        assert got[key] == want[key], key
    assert got["served"] == 4


def test_speculative_keys_equal_the_reference(tiny, ref_bench):
    got = driver_bench.bench_speculative(new_tokens=11, device="cpu")
    want = ref_bench.bench_speculative(new_tokens=11)
    assert list(got) == list(want)
    assert got["acceptance_rate"] == want["acceptance_rate"] == 1.0
    assert got["tokens_per_target_forward"] == \
        want["tokens_per_target_forward"]


def test_resnet50_gives_a_positive_rate():
    got = driver_bench.bench_resnet50(batch=2, steps=1, device="cpu")
    assert got["metric"] == "resnet50_train_images_per_sec_per_chip"
    assert got["value"] > 0 and got["batch"] == 2


def test_submit_to_first_step_over_the_rest_operator():
    got = driver_bench.bench_submit_to_first_step(n_jobs=3)
    assert got["samples"] == 3 and got["value"] > 0 and got["p90"] is None
    assert got["metric"] == "job_submit_to_first_pod_ready_p50_seconds"


def test_the_sample_is_the_reference_sample_in_the_gpu_flavour():
    import yaml
    from test_torch_api import to_port_wire

    ref = yaml.safe_load((REPO / "config/samples/mnist_cnn.yaml")
                         .read_text())
    want = to_port_wire(ref)
    cmd = want["spec"]["tasks"]["Master"]["template"]["spec"][
        "containers"][0]["command"]
    assert cmd == ["python", "-m", "examples.train_mnist"]
    cmd[-1] = "tpu_on_k8s_torch.train_mnist"
    assert driver_bench.MNIST_CNN_SAMPLE == want


def _reference_flags() -> set:
    tree = ast.parse((REPO / "tools/driver_bench.py").read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "add_argument"}


def test_the_flags_are_the_reference_flags_and_device():
    port = {a for action in driver_bench.build_parser()._actions
            for a in action.option_strings if a not in ("-h", "--help")}
    assert port == _reference_flags() | {"--device"}


def test_main_writes_its_own_record_file(monkeypatch, tmp_path):
    monkeypatch.setattr(driver_bench, "bench_submit_to_first_step",
                        lambda: {"metric": "m", "value": 1.0})
    out = tmp_path / "BASELINE_torch.json"
    out.write_text('{"other": 1, "published": {"kept": 2}}')
    got = driver_bench.main(["--write", "--skip-resnet", "--skip-decode",
                             "--device", "cpu"], out=out)
    import json
    assert json.loads(out.read_text()) == {
        "other": 1, "published": {"kept": 2,
                                  "job_submit_to_first_pod_ready_p50": got[
                                      "job_submit_to_first_pod_ready_p50"]}}


def test_main_refuses_the_reference_combinations():
    for argv in (["--horizon", "2"], ["--speculative", "--cache-int8"],
                 ["--draft-layers", "2"]):
        with pytest.raises(SystemExit):
            driver_bench.main(argv + ["--device", "cpu"])


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        driver_bench.main(["--skip-submit"])
