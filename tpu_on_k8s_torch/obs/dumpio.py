"""Dump-file I/O shared by every canonical-artifact reader/writer:
transparent ``.gz`` support with DETERMINISTIC compression (the
counterpart of ``tpu_on_k8s/obs/dumpio.py``).

Ledger dumps of a long run are large as plain JSON, so the ledger's
writer and loader route through ``open_dump``: any path ending in
``.gz`` is gzipped transparently, everything else is untouched plain
text.

The subtlety this module exists for: ``gzip.open`` embeds the CURRENT
WALL TIME in the member header (RFC 1952 MTIME), which would break the
byte-identical-across-runs property of two seeded runs' dumps. Writes
therefore pin ``mtime=0`` and embed no filename — the compressed bytes
are a pure function of the payload.
"""
from __future__ import annotations

import gzip
import io


class _GzTextWriter(io.TextIOWrapper):
    """Text writer onto a deterministic gzip member: ``mtime=0``, no
    embedded filename. Closes the underlying file too (``GzipFile``
    deliberately leaves a caller-supplied fileobj open)."""

    def __init__(self, path: str) -> None:
        self._raw = open(path, "wb")
        try:
            self._gz = gzip.GzipFile(filename="", mode="wb",
                                     fileobj=self._raw, mtime=0)
        except BaseException:
            self._raw.close()
            raise
        super().__init__(self._gz, encoding="utf-8", newline="")

    def close(self) -> None:
        try:
            super().close()
        finally:
            self._raw.close()


def is_gz(path: str) -> bool:
    return str(path).endswith(".gz")


def open_dump(path: str, mode: str = "r"):
    """Open a dump file for text ``"r"`` or ``"w"``, honoring ``.gz``.
    Returns a context-manager file object either way, so call sites are
    one-line swaps for ``open(path, mode)``."""
    p = str(path)
    if mode not in ("r", "w"):
        raise ValueError(f"open_dump supports text 'r'/'w', got {mode!r}")
    if not is_gz(p):
        return open(p, mode)
    if mode == "w":
        return _GzTextWriter(p)
    return gzip.open(p, "rt", encoding="utf-8")
