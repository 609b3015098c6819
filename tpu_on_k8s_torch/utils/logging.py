"""One key=value structured logger: a copy of ``get_logger`` and ``kv``
from ``tpu_on_k8s/utils/logging.py``, which the port may not import. Built
on stdlib logging, under the same ``tpu_on_k8s`` logger root, so one
handler configuration serves both packages."""
from __future__ import annotations

import logging
from typing import Any

_ROOT = "tpu_on_k8s"


def get_logger(component: str = "") -> logging.Logger:
    name = f"{_ROOT}.{component}" if component else _ROOT
    return logging.getLogger(name)


def kv(logger: logging.Logger, level: int, msg: str, **fields: Any) -> None:
    """Structured emit: ``kv(log, logging.INFO, "scaled", job="j", hosts=8)``."""
    logger.log(level, msg, extra={"kv": fields})
