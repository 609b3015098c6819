"""The PyTorch port as a package: what it imports, where it runs, and what
``chip_smoke.py`` does on a machine without a CUDA card."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_on_k8s_torch import resolve_device
from tpu_on_k8s_torch.models import decode, params as pparams
from tpu_on_k8s_torch.models.transformer import TransformerConfig
from tpu_on_k8s_torch.ops import _build

# tiny shapes: one intra-op thread, so that parallel test workers do not
# oversubscribe the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "orbax", "tpu_on_k8s")


def _port_files():
    return sorted((REPO / "tpu_on_k8s_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_the_scan_sees_the_whole_port():
    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {"chip_smoke.py", "tpu_on_k8s_torch/models/decode.py",
            "tpu_on_k8s_torch/ops/flash_attention.py",
            "tpu_on_k8s_torch/ops/int8_matmul.py",
            "tpu_on_k8s_torch/ops/quantization.py",
            "tpu_on_k8s_torch/models/convert.py",
            "tpu_on_k8s_torch/generate.py",
            "tpu_on_k8s_torch/models/serving.py",
            "tpu_on_k8s_torch/models/layouts.py",
            "tpu_on_k8s_torch/metrics.py",
            "tpu_on_k8s_torch/chaos.py",
            "tpu_on_k8s_torch/serve/cli.py",
            "tpu_on_k8s_torch/serve/gateway.py",
            "tpu_on_k8s_torch/serve/kvstore.py",
            "tpu_on_k8s_torch/serve/fleet.py",
            "tpu_on_k8s_torch/serve/disagg.py",
            "tpu_on_k8s_torch/serve/modelpool.py",
            "tpu_on_k8s_torch/coordinator/policy.py",
            "tpu_on_k8s_torch/autoscale/signals.py",
            "tpu_on_k8s_torch/obs/ledger.py",
            "tpu_on_k8s_torch/train_llama.py",
            "tpu_on_k8s_torch/train/trainer.py",
            "tpu_on_k8s_torch/train/optimizer.py",
            "tpu_on_k8s_torch/data/loader.py",
            "tpu_on_k8s_torch/models/vision.py",
            "tpu_on_k8s_torch/models/bert.py",
            "tpu_on_k8s_torch/train/vision.py",
            "tpu_on_k8s_torch/train/mlm.py",
            "tpu_on_k8s_torch/train_resnet.py",
            "tpu_on_k8s_torch/train_mnist.py",
            "tpu_on_k8s_torch/train_bert.py",
            "tpu_on_k8s_torch/parallel/ring.py",
            "tpu_on_k8s_torch/parallel/ulysses.py",
            "tpu_on_k8s_torch/parallel/pipeline.py"} <= names
    # the operator plane's subpackages
    assert set(OPERATOR_MODULES) <= names


#: the operator plane's modules (its API, gang topology and scheduler,
#: feature gates, cluster client, controller runtime, job controller,
#: elasticity and serving control plane, coordinator and capacity broker,
#: batch lane, trace export, storage, utilities and the entry point)
OPERATOR_MODULES = tuple(
    f"tpu_on_k8s_torch/{m}.py" for m in (
        "api/__init__", "api/constants", "api/core", "api/crr",
        "api/defaults", "api/inference_types", "api/model_types",
        "api/types", "client/__init__", "client/apiserver", "client/cluster",
        "client/kubeconfig", "client/resources", "client/rest",
        "client/testing", "controller/__init__", "controller/config",
        "controller/dag", "controller/engine", "controller/expectations",
        "controller/failover", "controller/hostnetwork",
        "controller/leaderelection", "controller/runtime",
        "controller/torchjob", "controller/elastic", "controller/autoscaler",
        "controller/loopkernel", "controller/modelversion",
        "controller/inferenceservice", "controller/fleetautoscaler",
        "coordinator/__init__", "coordinator/types", "coordinator/queue",
        "coordinator/policy", "coordinator/plugins", "coordinator/core",
        "coordinator/broker", "serve/batchlane", "obs/export", "main",
        "features/__init__", "features/features",
        "gang/__init__", "gang/scheduler", "gang/topology",
        "storage/__init__", "storage/providers", "utils/concurrent",
        "utils/conditions", "utils/flowcontrol", "utils/logging",
        "utils/resources", "utils/serde"))


def test_copied_modules_import_without_prometheus_client():
    """The card's machine has no prometheus_client and no PyYAML: the
    metrics module (and the engine and CLI that import it) load without it,
    and the scrape body is ``render_text``'s; every operator-plane module
    imports with both hidden (kubeconfig reads YAML only when it resolves a
    file) and initialises no CUDA state."""
    mods = [m[:-3].replace("/", ".").removesuffix(".__init__")
            for m in OPERATOR_MODULES]
    code = (
        "import sys; sys.modules['prometheus_client'] = None\n"
        "sys.modules['yaml'] = None\n"
        f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
        "import torch\nassert not torch.cuda.is_initialized()\n"
        "from tpu_on_k8s_torch.client import kubeconfig\n"
        "assert kubeconfig.resolve({'HOME': '/nonexistent'}).mode == 'none'\n"
        "from tpu_on_k8s_torch import metrics, serve\n"
        "from tpu_on_k8s_torch.models import serving\n"
        "assert metrics._prom is None\n"
        "m = metrics.ServingMetrics(); m.inc('tokens_emitted', 4)\n"
        "body = metrics.exposition(m)\n"
        "assert body == metrics.render_text(m)\n"
        "assert 'tpu_on_k8s_serving_tokens_emitted_total 4.0' in body\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_serve_package_keeps_the_cli_entry_point():
    """The serving CLI moved into the ``serve`` package: ``serve.main``
    still resolves, as ``from tpu_on_k8s_torch import serve`` callers
    use it, and so does the plane beside it."""
    from tpu_on_k8s_torch import serve
    from tpu_on_k8s_torch.serve import cli
    assert serve.main is cli.main
    assert {"ServingGateway", "ServingFleet", "DisaggFleet",
            "FleetPrefixStore", "ModelPool", "main"} <= set(serve.__all__)


@pytest.mark.parametrize("flags, served", [
    (["--gateway"], "served 6/6 requests (0 rejected, 0 expired)"),
    (["--replicas", "2", "--rollout-demo"],
     "fleet served 6/6 requests (0 rejected)")],
    ids=["gateway", "replicas"])
def test_serve_module_runs_the_serving_plane_on_the_cpu(flags, served):
    """``python -m tpu_on_k8s_torch.serve --gateway`` serves its synthetic
    traffic through the gateway and drains; ``--replicas 2
    --rollout-demo`` through a fleet rolled to a second tree under load."""
    res = subprocess.run(
        [sys.executable, "-m", "tpu_on_k8s_torch.serve", "--config", "tiny",
         "--device", "cpu", "--n-requests", "6", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr
    assert served in res.stdout
    if "--rollout-demo" in flags:
        assert "'complete']" in res.stdout


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = TransformerConfig.tiny()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        pparams.init_params(cfg, torch.Generator())
    params = pparams.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        decode.decode_model(cfg, params)
    with pytest.raises(RuntimeError, match="cuda"):
        decode.generate(cfg, params, torch.zeros(1, 4, dtype=torch.int32), 2)
    from tpu_on_k8s_torch import generate as cli
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--config", "tiny"])
    from tpu_on_k8s_torch import train_llama
    with pytest.raises(RuntimeError, match="cuda"):
        train_llama.main(["--config", "tiny", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        pparams.load_model(cfg, params)
    out = decode.generate(cfg, params, torch.zeros(1, 4, dtype=torch.int32),
                          2, device="cpu")
    assert out.shape == (1, 2)


def test_resolve_device_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    for src in _build.CSRC.iterdir():
        shutil.copy(src, tmp_path)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in _build.sources()}
    with open(tmp_path / "flash_common.cuh", "a") as f:
        f.write("\n// an edit\n")
    assert all(_build.library_path(n) != p for n, p in before.items())


def _run_chip_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_cuda(no_cuda):
    res = _run_chip_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo it
    cannot import the port, card or no card."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    res = _run_chip_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_build_is_keyed_by_the_sources_and_needs_nvcc(monkeypatch, tmp_path):
    assert _build.sources() == ["flash_bwd", "flash_fwd", "int8_matmul",
                                "quantization"]
    for name in _build.sources():
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    if not all(_build.library_path(n).exists() for n in _build.sources()):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build_all()
