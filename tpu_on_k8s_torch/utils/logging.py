"""One key=value structured logger: a copy of ``tpu_on_k8s/utils/logging.py``
(``KeyValueFormatter``, ``get_logger``, ``configure``, ``kv``), which the
port may not import. Built on stdlib logging, under the same ``tpu_on_k8s``
logger root, so one handler configuration serves both packages."""
from __future__ import annotations

import logging
import sys
from typing import Any

_ROOT = "tpu_on_k8s"


class KeyValueFormatter(logging.Formatter):
    """`ts level component msg key=value ...` — grep/loki-friendly."""

    def format(self, record: logging.LogRecord) -> str:
        base = (f"{self.formatTime(record, '%Y-%m-%dT%H:%M:%S')} "
                f"{record.levelname.lower()} {record.name} {record.getMessage()}")
        extras = getattr(record, "kv", None)
        if extras:
            base += " " + " ".join(f"{k}={v}" for k, v in extras.items())
        return base


def get_logger(component: str = "") -> logging.Logger:
    name = f"{_ROOT}.{component}" if component else _ROOT
    return logging.getLogger(name)


def configure(level: int = logging.INFO, stream=None) -> logging.Logger:
    """Idempotent root setup; returns the framework root logger."""
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(KeyValueFormatter())
        root.addHandler(handler)
        root.propagate = False
    return root


def kv(logger: logging.Logger, level: int, msg: str, **fields: Any) -> None:
    """Structured emit: ``kv(log, logging.INFO, "scaled", job="j", hosts=8)``."""
    logger.log(level, msg, extra={"kv": fields})
