"""The load driver's speculative, paged and disaggregated modes against the
reference's, on the CPU: ``test_torch_serve_load.check_virtual_mode``
(both drivers' ``main`` on the carried tiny weights, the Makefile's soak
flags at fewer requests; summaries, the printed line and the trace dumps
equal, byte for byte) for ``--spec``, ``--paged`` and ``--disagg``, with
each mode's headline: greedy token identity against the control arm and
the cost-model TPOT win (spec), 4x peak concurrency at the same KV bytes
with recompute and copy positions down (paged), both wins and every
handoff adopted (disagg). The autoscale and SLO modes, the soaks and the
host-clock modes are in ``test_torch_serve_load.py``. Tolerances: none.
"""
from __future__ import annotations

import pytest
import torch

from test_torch_serve_load import check_virtual_mode, planes, weights  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["spec", "paged", "disagg"])
def test_virtual_clock_mode_matches_the_reference(mode, weights, tmp_path,
                                                  capsys, monkeypatch):
    got = check_virtual_mode(mode, tmp_path, capsys, monkeypatch)
    if mode == "spec":
        assert got["token_identical"] and got["tpot_p95_win"]
        assert got["acceptance_rate"] == 1.0 and got["spec_rounds"] > 0
    elif mode == "paged":
        assert got["token_identical"] and got["concurrency_ratio"] >= 4.0
        assert got["recompute_down"] and got["copy_down"]
    else:
        assert got["tpot_p95_win"] and got["recompute_win"]
        assert got["handoffs_adopted"] == got["handoffs_enqueued"] > 0
        assert got["ttft_critical_path"]["decomposed"] == got["served"]
