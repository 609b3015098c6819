"""The port's SLO engine (``obs/slo.py``), its accountants
(``obs/account.py``), ``metrics.SLOMetrics`` and the fleet autoscaler's SLO
wiring against the reference on the CPU.

``tests/test_slo.py`` runs against the port through
``test_torch_api.reference_cases``: the burn-rate math, the window
boundary, the budget states' hysteresis and staleness, the engine, the
serving and training accountants, the signal layer's max-age, the
``spec.slo`` → ``status.slo`` plane through the ``FleetAutoscaler`` tick,
the API's normalization and serde, and the ``SLOMetrics`` exposition
(its ``tpu_on_k8s.metrics.metrics`` module is the port's ``metrics``). Its
one JAX case, ``test_train_loop_integration_preempt_resume`` (a jitted
step through the JAX ``TrainLoop``), runs here on a torch step through
the port's ``TrainLoop`` with every assertion kept.

A seeded differential drives both packages' ``SLOEngine`` over random
latency and outcome streams on one fake clock: every evaluation's
statuses, the event logs and their ``page_onsets`` must be equal.
"""
from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from test_torch_api import reference_cases, slice_literals
from test_torch_checkpoint import _toy_train
from tpu_on_k8s.obs import slo as rslo
from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.metrics import SLOMetrics, TrainMetrics
from tpu_on_k8s_torch.obs import TrainingAccountant
from tpu_on_k8s_torch.obs import slo as pslo
from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
from tpu_on_k8s_torch.train.loop import TrainLoop

torch.set_num_threads(1)

#: the reference's metrics module is the port's ``metrics``
METRICS = (r"tpu_on_k8s_torch\.metrics\.metrics\b", "tpu_on_k8s_torch.metrics")
#: the reference's JAX case -> its twin here
TWINS = {"TestTrainingAccountant.test_train_loop_integration_preempt_resume":
         "test_train_loop_integration_preempt_resume_on_torch"}

globals().update(reference_cases("test_slo", skip=tuple(TWINS),
                                 subs=(slice_literals, METRICS)))


def test_the_reference_cases_are_collected_here():
    names = set(globals())
    assert {"TestBurnMath", "TestBudgetStates", "TestEngine",
            "TestServingAccountant", "TestTrainingAccountant",
            "TestSignalStaleWindow", "TestFleetAutoscalerSLO", "TestAPI",
            "TestSLOMetricsExposition"} <= names
    for case, twin in TWINS.items():
        cls, meth = case.split(".")
        assert not hasattr(globals()[cls], meth), case
        assert twin in names, twin
    assert hasattr(TestTrainingAccountant,
                   "test_scripted_preemption_trace_hand_computed")


def test_train_loop_integration_preempt_resume_on_torch():
    """The reference's live twin of the hand-computed trace, on a torch
    step: the port's ``TrainLoop`` through ``train_preemption`` with a
    failed preemption save; the accountant sees the replayed steps as
    waste."""
    step_fn, init_state, _ = _toy_train()

    def batches_from(start):
        i = start
        while True:
            rng = np.random.default_rng((7, i))
            yield (torch.from_numpy(rng.normal(size=(8, 4)).astype(
                np.float32)), torch.from_numpy(rng.normal(
                    size=(8, 2)).astype(np.float32)))
            i += 1

    steps, preempt_at, every = 14, 9, 3
    metrics = TrainMetrics()
    acct = TrainingAccountant(metrics=metrics)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        inj = chaos.train_preemption(preempt_at, fail_save=True,
                                     seed=7).injector()
        loop = TrainLoop(step_fn, init_state(), batches_from(1),
                         log_every=1, checkpoint_manager=mgr,
                         checkpoint_every=every, accountant=acct)
        with inj:
            first = loop.run(steps)
        assert first.preempted and first.steps == preempt_at - 1
        restored, _gen, step = mgr.restore(init_state())
        assert step == 6
        acct.resume(step)
        TrainLoop(step_fn, restored, batches_from(step + 1),
                  log_every=1, checkpoint_manager=mgr,
                  checkpoint_every=every,
                  accountant=acct).run(steps - step)
        mgr.close()
    s = acct.summary()
    assert s["preemptions"] == 1
    assert s["waste_s"]["replay"] > 0
    assert s["steps_accounted"] == steps
    assert 0 < s["goodput_fraction"] < 1
    assert metrics.gauges["goodput_fraction"] == pytest.approx(
        s["goodput_fraction"])


# ---- a seeded differential of the two engines --------------------------------

class _Clock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _specs(mod, rng):
    """Three objectives with seeded targets and burn windows (a latency
    objective of each kind and an availability one)."""
    out = []
    window = float(rng.uniform(40, 120))
    for name, objective in (("ttft", "ttft_p95"), ("tpot", "tpot_p99"),
                            ("avail", "availability")):
        fast_short = float(rng.uniform(0.5, 2.0))
        out.append(mod.SLOSpec(
            name=name, objective=objective,
            target=(float(rng.uniform(0.95, 0.999))
                    if objective == "availability"
                    else float(rng.uniform(0.05, 0.5))),
            window_s=window, fast_short_s=fast_short,
            fast_long_s=fast_short * float(rng.uniform(2, 6)),
            slow_short_s=float(rng.uniform(5, 15)),
            slow_long_s=float(rng.uniform(15, window)),
            page_burn=float(rng.uniform(2, 15)),
            warn_burn=float(rng.uniform(0.5, 2)),
            hysteresis=float(rng.uniform(0, 0.5)),
            stale_after_s=float(rng.uniform(3, 10))))
    return out


def _drive(mod, seed):
    rng = np.random.default_rng(seed)
    clock = _Clock()
    metrics = SLOMetrics() if mod is pslo else None
    engine = mod.SLOEngine(_specs(mod, rng), clock=clock, service="ns/svc",
                           metrics=metrics)
    seen = []
    for _ in range(400):
        clock.t += float(rng.exponential(0.25))
        if rng.random() < 0.05:          # a dark stretch: staleness
            clock.t += float(rng.uniform(5, 20))
        burst = rng.random() < 0.15
        for _ in range(int(rng.integers(0, 6))):
            kind = ("ttft", "tpot", "queue_wait")[int(rng.integers(0, 3))]
            scale = 0.6 if burst else 0.01
            engine.observe_latency(kind, float(rng.exponential(scale)))
            engine.observe_outcome(bool(rng.random() > (0.3 if burst
                                                         else 0.001)))
        if rng.random() < 0.5:
            statuses = engine.evaluate()
            seen.append(({n: dataclasses.astuple(s)
                          for n, s in statuses.items()},
                         engine.paging(statuses)))
    return seen, list(engine.event_log), mod.page_onsets(engine.event_log)


@pytest.mark.parametrize("seed", range(8))
def test_slo_engine_states_match_the_reference(seed):
    ref_seen, ref_log, ref_onsets = _drive(rslo, seed)
    seen, log, onsets = _drive(pslo, seed)
    assert seen == ref_seen
    assert log == ref_log
    assert onsets == ref_onsets
    # the stream is rich enough to cross states and go stale
    assert any(st[9] for snap, _ in seen for st in snap.values())
    assert ref_log
