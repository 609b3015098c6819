"""Observability: a copy of the parts of ``tpu_on_k8s/obs/`` the port
reads (``trace``: spans and the tracer; ``account``: the serving and
training goodput ledgers; ``slo``: the SLO engine, declarative
``SLOSpec`` objectives evaluated over sliding windows into multi-window
error-budget burn rates and typed ``ok/warn/page/exhausted`` budget
states; ``ledger``: the decision ledger the control loops record through,
with ``dumpio``'s deterministic dump files; ``export``: Chrome
trace-event / Perfetto rendering and the ``FlightRecorder`` crash ring
buffer)."""
from tpu_on_k8s_torch.obs.account import (  # noqa: F401
    ServingAccountant,
    TrainingAccountant,
    goodput_from_spans,
)
from tpu_on_k8s_torch.obs.export import (  # noqa: F401
    FlightRecorder,
    dump_chrome_trace,
    load_trace,
    to_chrome_trace,
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
from tpu_on_k8s_torch.obs.trace import (  # noqa: F401
    NOOP,
    NOOP_SPAN,
    STATUS_ERROR,
    STATUS_OK,
    TRACE_FORMAT,
    Span,
    Tracer,
    ensure,
)
