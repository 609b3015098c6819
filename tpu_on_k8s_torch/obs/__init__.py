"""Observability for the training loop: a copy of the parts of
``tpu_on_k8s/obs/`` the loop reads (``trace``: spans and the tracer;
``account``: the training goodput ledger)."""
from tpu_on_k8s_torch.obs.account import (  # noqa: F401
    TrainingAccountant,
    goodput_from_spans,
)
from tpu_on_k8s_torch.obs.trace import NOOP, Span, Tracer, ensure  # noqa: F401
