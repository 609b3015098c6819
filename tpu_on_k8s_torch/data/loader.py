"""Shard-aware deterministic data loading for SPMD training.

Wraps the native C++ pipeline (`tpu_on_k8s_torch/data/native/dataloader.cpp` —
threaded batch assembly, bounded prefetch queue, mmap'd records) behind a
NumPy-facing ``DataLoader``. The shared library is compiled on first use with
the baked-in g++ (no pip); when no compiler is available a pure-Python
fallback runs the *same* keyed-Feistel permutation bit-exactly, so batch
order is identical either way — what every SPMD host needs to agree on.

Dataset format: a flat binary file of fixed-size records. ``write_records``
produces it from a NumPy array; anything that can mmap flat records
(tokenized corpora, packed examples) works.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).parent / "native"
_SRC = _NATIVE_DIR / "dataloader.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def _build_lib() -> Optional[ctypes.CDLL]:
    so = _NATIVE_DIR / "build" / "libtkdata.so"
    so.parent.mkdir(exist_ok=True)
    if not so.exists() or so.stat().st_mtime < _SRC.stat().st_mtime:
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
               "-o", str(so), str(_SRC), "-lpthread"]
        try:
            # the module lock serializes this one-time, bounded g++ build
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    lib = ctypes.CDLL(str(so))
    lib.tk_open.restype = ctypes.c_void_p
    lib.tk_open.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.tk_num_records.restype = ctypes.c_int64
    lib.tk_num_records.argtypes = [ctypes.c_void_p]
    lib.tk_close.argtypes = [ctypes.c_void_p]
    lib.tk_loader_start.restype = ctypes.c_void_p
    lib.tk_loader_start.argtypes = [ctypes.c_void_p] + [ctypes.c_int64] * 5 + \
        [ctypes.c_int32] * 3
    lib.tk_batches_per_epoch.restype = ctypes.c_int64
    lib.tk_batches_per_epoch.argtypes = [ctypes.c_void_p]
    lib.tk_next.restype = ctypes.c_int32
    lib.tk_next.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.tk_loader_stop.argtypes = [ctypes.c_void_p]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    with _lock:
        if _lib is None and not _lib_failed:
            _lib = _build_lib()
            _lib_failed = _lib is None
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


# ---------------------------------------------------------------------------
# the Feistel permutation, mirrored bit-exactly from dataloader.cpp
# ---------------------------------------------------------------------------

def _mix(x: int, key: int) -> int:
    x = (x ^ key) & 0xFFFFFFFF
    x = (x * 0x9E3779B1) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA77) & 0xFFFFFFFF
    x ^= x >> 13
    return x


def feistel_permutation(m: int, seed: int, epoch: int) -> "_Feistel":
    """Keyed bijection over [0, m) — identical output to the C++ pipeline."""
    return _Feistel(m, seed, epoch)


class _Feistel:
    def __init__(self, m: int, seed: int, epoch: int):
        self.m = m
        bits = 1
        while (1 << bits) < m:
            bits += 1
        self.half_bits = (bits + 1) // 2
        seed64 = seed & 0xFFFFFFFFFFFFFFFF
        self.keys = [
            _mix(((seed64 ^ (seed64 >> 32)) + r * 0x1000193) & 0xFFFFFFFF,
                 ((epoch & 0xFFFFFFFF) * 0x01000193 + 0x811C9DC5 + r) & 0xFFFFFFFF)
            for r in range(4)
        ]

    def __call__(self, x: int) -> int:
        if self.m <= 1:
            return 0
        mask = (1 << self.half_bits) - 1
        while True:
            left, right = x >> self.half_bits, x & mask
            for key in self.keys:
                left, right = right, left ^ (_mix(right & 0xFFFFFFFF, key) & mask)
            x = (left << self.half_bits) | right
            if x < self.m:
                return x


# ---------------------------------------------------------------------------
# dataset + loader
# ---------------------------------------------------------------------------

def write_records(path: str, array: np.ndarray) -> None:
    """Persist [n, ...] array as flat fixed-size records (C-contiguous)."""
    np.ascontiguousarray(array).tofile(path)


class FixedRecordDataset:
    """mmap'd flat file of fixed-size records."""

    def __init__(self, path: str, record_shape: Sequence[int], dtype=np.int32):
        self.path = str(path)
        self.record_shape = tuple(record_shape)
        self.dtype = np.dtype(dtype)
        self.record_bytes = int(np.prod(self.record_shape)) * self.dtype.itemsize
        size = os.path.getsize(self.path)
        if size == 0 or size % self.record_bytes != 0:
            raise ValueError(
                f"{path}: size {size} is not a multiple of record "
                f"size {self.record_bytes}")
        self.n_records = size // self.record_bytes


class DataLoader:
    """Deterministic, shard-aware, prefetching batch iterator.

    Native path: C++ worker threads assemble batches off-thread and the
    Python side copies each ready batch out of the bounded queue. Fallback
    path: same permutation evaluated in Python over a np.memmap. Both yield
    bit-identical batch streams for a given (seed, shard, num_shards).
    """

    def __init__(self, dataset: FixedRecordDataset, batch_size: int,
                 shard_id: int = 0, num_shards: int = 1, seed: int = 0,
                 shuffle: bool = True, num_workers: int = 2,
                 prefetch: int = 4, force_python: bool = False,
                 start_batch: int = 0):
        if start_batch < 0:
            raise ValueError(f"start_batch must be >= 0, got {start_batch}")
        self.ds = dataset
        self.batch_size = batch_size
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.seed = seed
        self.shuffle = shuffle
        self.per_shard = dataset.n_records // num_shards
        if self.per_shard < batch_size:
            raise ValueError(
                f"shard has {self.per_shard} records < batch {batch_size}")
        self.batches_per_epoch = self.per_shard // batch_size
        # tickets are absolute (epoch = ticket // batches_per_epoch), so a
        # checkpointed position resumes the exact stream in O(1) — the
        # data loop replays nothing and skips nothing after preemption
        self._ticket = start_batch
        self._native = None
        self._handle = None
        lib = None if force_python else _get_lib()
        if lib is not None:
            handle = lib.tk_open(dataset.path.encode(), dataset.record_bytes)
            if handle:
                loader = lib.tk_loader_start(
                    handle, batch_size, shard_id, num_shards, seed,
                    start_batch, 1 if shuffle else 0, num_workers,
                    prefetch)
                if loader:
                    self._native = lib
                    self._handle = handle
                    self._loader = loader
        if self._native is None:
            self._mm = np.memmap(dataset.path, dtype=self.ds.dtype, mode="r")
            self._mm = self._mm.reshape(dataset.n_records, -1)

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def _next_python(self) -> np.ndarray:
        epoch = self._ticket // self.batches_per_epoch
        batch_idx = self._ticket % self.batches_per_epoch
        perm = _Feistel(self.per_shard, self.seed, epoch)
        out = np.empty((self.batch_size,) + self.ds.record_shape, self.ds.dtype)
        flat = out.reshape(self.batch_size, -1)
        for j in range(self.batch_size):
            local = batch_idx * self.batch_size + j
            if self.shuffle:
                local = perm(local)
            flat[j] = self._mm[local * self.num_shards + self.shard_id]
        return out

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._native is not None:
            out = np.empty((self.batch_size,) + self.ds.record_shape,
                           self.ds.dtype)
            ok = self._native.tk_next(
                self._loader, out.ctypes.data_as(ctypes.c_char_p))
            if not ok:
                # loader stopped (concurrent close()) — the buffer was never
                # written; surfacing it as a batch would be garbage data
                raise StopIteration
        else:
            out = self._next_python()
        self._ticket += 1
        return out

    def state(self) -> dict:
        """Checkpointable position + stream identity; restore with
        ``DataLoader.resume(dataset, state)`` (which validates the
        identity so a mismatched restore fails loudly)."""
        return {"ticket": self._ticket, "seed": self.seed,
                "shard_id": self.shard_id, "num_shards": self.num_shards,
                "batch_size": self.batch_size, "shuffle": self.shuffle,
                "n_records": self.ds.n_records}

    @classmethod
    def resume(cls, dataset: FixedRecordDataset, state: dict,
               **kwargs) -> "DataLoader":
        """A loader continuing the exact stream a ``state()`` snapshot
        recorded. The identity fields (seed/shard/batch size) come FROM
        the state; overriding them with different values raises — a
        silent mismatch would resume a different permutation and corrupt
        the training stream."""
        if ("n_records" in state
                and dataset.n_records != state["n_records"]):
            # a re-packed/grown corpus changes the permutation domain —
            # every batch from the ticket on would silently differ
            raise ValueError(
                f"dataset has {dataset.n_records} records but the "
                f"checkpoint recorded {state['n_records']}")
        for k in ("seed", "shard_id", "num_shards", "batch_size",
                  "shuffle"):
            if k in kwargs and kwargs[k] != state[k]:
                raise ValueError(
                    f"resume {k}={kwargs[k]} contradicts the checkpointed "
                    f"{k}={state[k]}")
            kwargs[k] = state[k]
        return cls(dataset, start_batch=state["ticket"], **kwargs)

    def close(self) -> None:
        if self._native is not None:
            self._native.tk_loader_stop(self._loader)
            self._native.tk_close(self._handle)
            self._native = None

    def __del__(self):
        try:
            self.close()
        # __del__ at interpreter teardown: raising would only print noise
        except Exception:
            pass
