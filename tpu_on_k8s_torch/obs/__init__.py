"""Observability: a copy of the parts of ``tpu_on_k8s/obs/`` the port
reads (``trace``: spans and the tracer; ``account``: the serving and
training goodput ledgers; ``slo``: the SLO engine, declarative
``SLOSpec`` objectives evaluated over sliding windows into multi-window
error-budget burn rates and typed ``ok/warn/page/exhausted`` budget
states; ``ledger``: the decision ledger the control loops record through,
with ``dumpio``'s deterministic dump files)."""
from tpu_on_k8s_torch.obs.account import (  # noqa: F401
    ServingAccountant,
    TrainingAccountant,
    goodput_from_spans,
)
from tpu_on_k8s_torch.obs.ledger import (  # noqa: F401
    LEDGER_FORMAT,
    DecisionLedger,
    DecisionRecord,
    HorizonRecord,
    load_ledger,
)
from tpu_on_k8s_torch.obs.slo import (  # noqa: F401
    BUDGET_EXHAUSTED,
    BUDGET_OK,
    BUDGET_PAGE,
    BUDGET_WARN,
    SLOEngine,
    SLOEvaluator,
    SLOSpec,
    SLOStatus,
)
from tpu_on_k8s_torch.obs.trace import NOOP, Span, Tracer, ensure  # noqa: F401
