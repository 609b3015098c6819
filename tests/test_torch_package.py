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
            "tpu_on_k8s_torch/train_llama.py",
            "tpu_on_k8s_torch/train/trainer.py",
            "tpu_on_k8s_torch/train/optimizer.py",
            "tpu_on_k8s_torch/data/loader.py"} <= names


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
