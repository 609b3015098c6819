"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``build/<name>-<hash>.so``, where the hash covers the source, the shared
headers (``csrc/*.cuh``) and the compiler flags: an edited source builds
anew, an unchanged one is loaded from the build directory. The build happens
on first use (``load``); ``build_all`` compiles every source at once, one
nvcc process each, all started together. nvcc's report (``-Xptxas=-v``:
registers, shared memory, spills per kernel) is kept beside the library as
``<name>-<hash>.log``.

Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# --split-compile=0: each source's kernels are compiled in parallel, a
# thread a core, as the sources are (one nvcc each); the flash sources hold
# one kernel per head dim and dtype
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
              "--split-compile=0")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def sources() -> List[str]:
    """The name of every kernel source, ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` (default: every source) whose library
    does not exist yet, one nvcc process per source, all running at once.
    Raises with nvcc's output if any build fails. Returns name → library."""
    names = list(sources() if names is None else names)
    out = {name: library_path(name) for name in names}
    todo = [name for name in names if not out[name].exists()]
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        # compile to a private name, then rename: a reader never sees a
        # half-written library
        tmp = out[name].with_name(f".{out[name].name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[name].with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; raises with
    nvcc's output if the build fails. Returns the library's path."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, building it first if
    needed (one library per process, kept for its lifetime)."""
    return ctypes.CDLL(str(build(name)))
