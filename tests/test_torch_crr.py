"""The CRR protocol end to end over REST (``controller/failover.py``'s
``CRRRestarter``, ``client/nodeagent.py``, the elastic rescale through it)
against the reference on the CPU.

``tests/test_crr_over_rest.py`` runs against the port through
``test_torch_api.reference_cases``, but ``test_build_restarter_selects_by_backend``
and ``test_node_agent_only_flag_parses``, which test the operator's entry
point (``main.build_restarter``, ``--node-agent-only``; the coordinator's
slice). Its two end-to-end cases, ``test_inplace_failover_via_crr_over_rest``
and ``test_elastic_rescale_via_crr_over_rest``, run on a ``Manager`` wired by
hand (``test_torch_elastic.HandWired``) beside their own node agent, kubelet
and user connections.
"""
from __future__ import annotations

import torch

from test_torch_api import reference_cases, slice_literals
from test_torch_elastic import HAND_WIRED

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)

#: the cases that test the operator's entry point, not run here
NOT_HERE = ("test_build_restarter_selects_by_backend",
            "test_node_agent_only_flag_parses")

globals().update(reference_cases(
    "test_crr_over_rest", skip=NOT_HERE, subs=(slice_literals, *HAND_WIRED)))


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert not set(NOT_HERE) & names
    assert {"test_inplace_failover_via_crr_over_rest",
            "test_elastic_rescale_via_crr_over_rest",
            "test_node_agent_honors_crr_and_reports_phase",
            "test_whole_slice_failure_reconciles_in_one_roundtrip"} <= names
