"""The port's node agent (``client/nodeagent.py``), its CRI runtime
(``client/cri.py``), the control plane's chaos scenarios and the AIMaster
CLI against the reference on the CPU (the CRR protocol end to end over REST
is in ``tests/test_torch_crr.py``).

The reference's test modules run against the port through
``test_torch_api.reference_cases``:

* ``tests/test_nodeagent_cri.py``, but ``test_build_runtime_selection``,
  which tests the operator's entry point (``main.build_runtime``) and runs
  in ``tests/test_torch_main.py``, and ``test_daemonset_manifest_names_the_real_runtime``,
  which reads the reference's deployment files under ``config/nodeagent/``
  (the port has no deployment files);
* from ``tests/test_chaos.py``, ``test_injected_pod_kill_triggers_failover``
  and ``test_injected_slice_preemption_recovers_whole_slice`` with the
  port's ``pod_kill`` and ``slice_preemption``, on the port's ``Operator``
  over an in-memory cluster;
* from ``tests/test_rest_backend.py``, ``test_aimaster_cli_runs_against_rest``
  against ``tpu_on_k8s_torch.aimaster.main``.
"""
from __future__ import annotations

import torch

from test_torch_api import reference_cases, slice_literals
from test_torch_elastic import AGENT

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

#: the reference's chaos package is one module in the port
SCENARIOS = (r"from tpu_on_k8s_torch\.chaos import scenarios",
             "from tpu_on_k8s_torch import chaos as scenarios")
#: the cases that test the operator's entry point or the reference's
#: deployment files, and why each is not run here
NOT_HERE = {
    "test_build_runtime_selection":
        "main.build_runtime, the operator's entry: in test_torch_main.py",
    "test_daemonset_manifest_names_the_real_runtime":
        "reads the reference's config/nodeagent/ deployment files",
}

globals().update(reference_cases("test_nodeagent_cri", skip=tuple(NOT_HERE)))
globals().update(reference_cases(
    "test_chaos", only=("test_injected_pod_kill_triggers_failover",
                        "test_injected_slice_preemption_recovers_whole_slice"),
    subs=(slice_literals, SCENARIOS, *AGENT)))
globals().update(reference_cases(
    "test_rest_backend", only=("test_aimaster_cli_runs_against_rest",),
    subs=(slice_literals,
          (r"from examples import aimaster",
           "from tpu_on_k8s_torch import aimaster"))))


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert not set(NOT_HERE) & names
    assert {"test_cri_stops_latest_attempt_not_a_stale_exited_one",
            "test_injected_pod_kill_triggers_failover",
            "test_injected_slice_preemption_recovers_whole_slice",
            "test_aimaster_cli_runs_against_rest"} <= names

