"""The port's operator entry point (``tpu_on_k8s_torch/main.py``: the flags,
``build_cluster``, ``build_restarter``, ``build_runtime``, ``Operator`` and
``main``) against the reference's oracles on the CPU.

The reference's cases run against the port through
``test_torch_api.reference_cases``:

* ``tests/test_main.py`` (5: the port range, a job run to success through
  the coordinator, the feature gate that drops it, flow control);
* ``tests/test_resilience.py`` (5: a retryable worker death recovered, the
  threaded manager, structured logging under the ``tpu_on_k8s`` logger
  root both packages share, the profiling helpers; the job label is the
  port's ``LABEL_JOB_NAME``);
* ``tests/test_rest_backend.py``'s ``test_build_cluster_backend_selection``
  and ``test_full_tpujob_lifecycle_over_rest`` (the whole operator over
  HTTP; its two asserts on the TPU env read the torch.distributed env
  the GPU flavour writes in their place: ``WORLD_SIZE`` 3 and ``RANK`` 1,
  the rank shifted past the master);
* ``tests/test_leaderelection.py``'s
  ``test_operator_leader_elect_flag_gates_controllers``;
* ``tests/test_crr_over_rest.py``'s ``test_build_restarter_selects_by_backend``
  and ``test_node_agent_only_flag_parses``, and ``tests/test_nodeagent_cri.py``'s
  ``test_build_runtime_selection``;
* both cases of ``tests/test_hostnetwork_spot_over_rest.py``.

Here too: ``python -m tpu_on_k8s_torch.main --once`` in a subprocess, and
the broker's wiring: ``--broker-capacity-chips`` builds one
``CapacityBroker`` on the operator's ledger and registry and hands it to
both autoscalers, whose services and elastic jobs become its bidders.
"""
from __future__ import annotations

import logging
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_api import reference_cases, slice_literals
from tpu_on_k8s_torch.api import constants

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

#: the reference's job-name label literal, as the port names it
JOB_LABEL = (r'"tpujob\.distributed\.tpu\.io/job-name"',
             f'"{constants.LABEL_JOB_NAME}"')
#: the reference's asserts on the TPU env of a worker, as the torch env
TORCH_ENV = (
    (r'assert env\.get\("PJRT_DEVICE"\) == "TPU"',
     f'assert env.get("{constants.ENV_NUM_PROCESSES}") == "3"'),
    (r'assert env\.get\("TPU_WORKER_ID"\) == "1"',
     f'assert env.get("{constants.ENV_PROCESS_ID}") == "1"'),
)

globals().update(reference_cases("test_main", subs=(slice_literals,)))
#: the logger root both packages share (``utils/logging.py``), which the
#: import map would otherwise rename inside the reference's string literal
LOGGER_ROOT = (r'"tpu_on_k8s_torch\.elastic"', '"tpu_on_k8s.elastic"')

globals().update(reference_cases("test_resilience",
                                 subs=(slice_literals, JOB_LABEL,
                                       LOGGER_ROOT)))
globals().update(reference_cases(
    "test_rest_backend", only=("test_build_cluster_backend_selection",
                               "test_full_tpujob_lifecycle_over_rest"),
    subs=(slice_literals, *TORCH_ENV)))
globals().update(reference_cases(
    "test_leaderelection", only=("test_operator_leader_elect_flag_gates_controllers",)))
globals().update(reference_cases(
    "test_crr_over_rest", only=("test_build_restarter_selects_by_backend",
                                "test_node_agent_only_flag_parses"),
    subs=(slice_literals,)))
globals().update(reference_cases(
    "test_nodeagent_cri", only=("test_build_runtime_selection",)))
globals().update(reference_cases("test_hostnetwork_spot_over_rest",
                                 subs=(slice_literals,)))


@pytest.fixture(autouse=True)
def _framework_logger_restored():
    """``configure`` is idempotent on the ``tpu_on_k8s`` logger root, which
    both packages share: each case here starts from a root without handlers
    and leaves it as it found it, so a reference case run later in the same
    process configures its own stream."""
    root = logging.getLogger("tpu_on_k8s")
    saved = (list(root.handlers), root.level, root.propagate)
    root.handlers = []
    yield
    root.handlers, root.level, root.propagate = saved[0], saved[1], saved[2]


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"test_parse_port_range", "test_operator_runs_job_to_success",
            "test_feature_gate_flag_disables_coordinator",
            "test_token_bucket_limits",
            "test_flowcontrol_recorder_coalesces_per_object",
            "test_chaos_retryable_worker_death_recovers",
            "test_threaded_manager_processes_jobs",
            "test_structured_logging_format",
            "test_profiling_annotations_run", "test_profiler_trace_writes",
            "test_build_cluster_backend_selection",
            "test_full_tpujob_lifecycle_over_rest",
            "test_operator_leader_elect_flag_gates_controllers",
            "test_build_restarter_selects_by_backend",
            "test_node_agent_only_flag_parses",
            "test_build_runtime_selection",
            "test_hostnetwork_ports_allocate_and_release_over_rest",
            "test_spot_task_spec_round_trips_and_applies_over_rest"} <= names


def test_once_runs_as_a_module():
    """``python -m tpu_on_k8s_torch.main --once``: the in-memory backend
    pumped to quiescence, with and without the broker."""
    for extra in ([], ["--broker-capacity-chips", "64"]):
        out = subprocess.run(
            [sys.executable, "-m", "tpu_on_k8s_torch.main", "--once",
             "--cluster-backend", "memory", *extra],
            cwd=REPO, capture_output=True, text=True, timeout=120,
            env={"PATH": "/usr/bin:/bin", "HOME": "/nonexistent",
                 "PYTHONPATH": str(REPO)})
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "quiescent after 0 reconciles"


def test_broker_flag_wires_one_market_into_both_autoscalers():
    from tpu_on_k8s_torch.coordinator.broker import CapacityBroker
    from tpu_on_k8s_torch.main import Operator, build_parser

    off = Operator(build_parser().parse_args(["--cluster-backend", "memory"]))
    assert off.broker is None and off.broker_metrics is None
    assert off.autoscaler.broker is None and off.fleetautoscaler.broker is None
    op = Operator(build_parser().parse_args(
        ["--cluster-backend", "memory", "--broker-capacity-chips", "48",
         "--broker-period-seconds", "2.5"]))
    assert isinstance(op.broker, CapacityBroker)
    assert op.broker.capacity == 48 and op.broker.period_s == 2.5
    assert op.broker.ledger is op.ledger
    assert op.autoscaler.broker is op.broker
    assert op.fleetautoscaler.broker is op.broker
    assert op.ledger.metrics is op.ledger_metrics
    op.broker.run_once()
    assert op.broker_metrics.gauges[("capacity_chips", "")] == 48
    assert op.broker_metrics.gauges[("free_chips", "")] == 48
