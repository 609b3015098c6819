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
            "tpu_on_k8s_torch/chaos_soak.py",
            "tpu_on_k8s_torch/reshard_soak.py",
            "tpu_on_k8s_torch/attn_micro.py",
            "tpu_on_k8s_torch/perf_sweep.py",
            "tpu_on_k8s_torch/step_breakdown.py",
            "tpu_on_k8s_torch/longcontext_proof.py",
            "tpu_on_k8s_torch/driver_bench.py",
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
    # the operator plane's subpackages, the load driver's slice and the
    # digital twin's
    assert set(OPERATOR_MODULES) <= names
    assert set(LOAD_MODULES) <= names
    assert set(SIM_MODULES) <= names


#: the load driver and what it brought: the seeded traffic, the two
#: reports it folds into its summaries
LOAD_MODULES = tuple(
    f"tpu_on_k8s_torch/{m}.py" for m in (
        "serve_load", "sim/__init__", "sim/traffic", "obs/trace_report",
        "obs/why_report"))


#: the digital twin, its calibration and fuzzer, the SLO report and the
#: drivers that run them
SIM_MODULES = tuple(
    f"tpu_on_k8s_torch/{m}.py" for m in (
        "sim/clock", "sim/devices", "sim/scenario", "sim/calibrate",
        "sim/twin", "sim/fuzz/__init__", "sim/fuzz/oracle", "sim/fuzz/mutate",
        "sim/fuzz/shrink", "sim/fuzz/corpus", "sim/fuzz/search",
        "obs/slo_report", "twin_soak", "broker_soak", "multimodel_soak",
        "fuzz_run"))


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



# ---- the twin's determinism gate -------------------------------------------
# The rules of the reference's analyzer pass (``tools/analyze/passes/
# determinism.py``), which scans the reference's package only, over the
# port's ``sim/``: every artifact of the twin and the fuzzer is a pure
# function of the scenario, so nothing there reads a wall clock or draws
# ambient entropy, and directory listings are sorted.

_WALL_CLOCK = {"time.time", "time.monotonic", "time.perf_counter",
               "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns"}
_RANDOM_DRAWS = {"random", "randint", "randrange", "choice", "choices",
                 "shuffle", "sample", "uniform", "gauss", "betavariate",
                 "expovariate", "getrandbits", "randbytes", "triangular",
                 "normalvariate", "vonmisesvariate"}
_NP_RANDOM_OK = {"default_rng", "RandomState", "Generator", "SeedSequence",
                 "PCG64", "Philox"}
_LISTINGS = {"os.listdir", "os.scandir", "glob.glob", "glob.iglob"}


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return ".".join([node.id, *reversed(parts)])
    return None


def determinism_findings(src: str) -> list:
    """``(line, what)`` for each wall-clock read, ambient draw, unsorted
    listing or set iteration in ``src``."""
    tree = ast.parse(src)
    parents = {c: p for p in ast.walk(tree) for c in ast.iter_child_nodes(p)}

    def sorted_wrapped(node):
        parent = parents.get(node)
        while isinstance(parent, ast.Call) and node in parent.args:
            name = _dotted(parent.func)
            if name == "sorted":
                return True
            if name not in ("list", "tuple"):
                return False
            node, parent = parent, parents.get(parent)
        return False

    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in (
                "time", "random", "secrets", "uuid"):
            out.append((node.lineno, f"from {node.module} import"))
        if isinstance(node, ast.For) and (
                isinstance(node.iter, (ast.Set, ast.SetComp))
                or (isinstance(node.iter, ast.Call) and _dotted(
                    node.iter.func) in ("set", "frozenset"))):
            out.append((node.lineno, "set iteration"))
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func) or ""
        root, leaf = name.split(".")[0], name.rsplit(".", 1)[-1]
        parts = name.split(".")
        if (name in _WALL_CLOCK
                or (root in ("datetime", "date")
                    and leaf in ("now", "utcnow", "today"))
                or name in ("uuid.uuid1", "uuid.uuid4", "os.urandom")
                or root == "secrets"
                or (root == "random" and len(parts) > 1
                    and (leaf in _RANDOM_DRAWS
                         or (leaf == "Random" and not node.args
                             and not node.keywords)))
                or (root in ("np", "numpy") and len(parts) >= 3
                    and parts[1] == "random" and leaf not in _NP_RANDOM_OK)
                or ((name in _LISTINGS or (isinstance(node.func, ast.Attribute)
                                           and node.func.attr == "iterdir"))
                    and not sorted_wrapped(node))):
            out.append((node.lineno, name))
    return out


SIM_FILES = sorted((REPO / "tpu_on_k8s_torch" / "sim").rglob("*.py"))


@pytest.mark.parametrize("path", SIM_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_sim_reads_no_wall_clock_and_no_ambient_entropy(path):
    assert determinism_findings(path.read_text()) == []


@pytest.mark.parametrize("planted", [
    "import time\nt = time.perf_counter()",
    "import datetime\nd = datetime.datetime.now()",
    "import random\nx = random.random()",
    "import random\nr = random.Random()",
    "import numpy as np\nx = np.random.rand(3)",
    "import os\nnames = os.listdir('.')",
    "for x in {1, 2}:\n    pass",
    "import uuid\nu = uuid.uuid4()",
    "from time import monotonic"])
def test_the_determinism_gate_catches_a_planted_read(planted):
    assert determinism_findings(planted)
    assert not determinism_findings(
        "import random\nimport os\nimport numpy as np\n"
        "r = random.Random(7)\ng = np.random.default_rng(3)\n"
        "names = sorted(os.listdir('.'))")


def test_copied_modules_import_without_prometheus_client():
    """The card's machine has no prometheus_client and no PyYAML: the
    metrics module (and the engine and CLI that import it) load without it,
    and the scrape body is ``render_text``'s; every operator-plane module
    load-driver and twin module imports with both hidden (kubeconfig reads YAML
    only when it resolves a file) and initialises no CUDA state."""
    mods = [m[:-3].replace("/", ".").removesuffix(".__init__")
            for m in OPERATOR_MODULES + LOAD_MODULES + SIM_MODULES]
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
