"""The closed autoscaling loop of the port against the JAX package's, on the
CPU.

``tests/test_autoscale.py``'s acceptance loop, ``_drive_burst`` (a seeded
bursty trace through a ``ServingFleet`` and a ``FleetAutoscaler`` on a
fake clock, a tick every second fleet step), runs through both packages:
the reference's own function over JAX engines, and the same function run
against the port (``test_torch_autoscale``'s mapping) over the port's
engines, both at the reference's tiny fp32 model (the JAX engines come
from ``test_torch_serve_gateway``'s ``JaxEngines`` pool, built once and
restored between fleets, so that a JAX fleet does not compile its
programs for every replica). At seeds 0, 3, 7 and 8, with and without
``autoscale_under_crash(replica="replica-1", crash_at=3,
outage_at=(2, 3, 4))``, the two runs must agree exactly: the
``decision_log`` line for line, the executed transitions with their
virtual times, every request's final state and tokens, the rejections,
the fleet's ``stats`` and retired replicas, the chaos event log and the
``AutoscaleMetrics`` counters and gauges. Tolerances: none.
"""
from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

import test_autoscale as ref
from test_torch_api import reference_cases
from test_torch_autoscale import SUBS
from test_torch_serve_gateway import make_setup, port_config

torch.set_num_threads(1)

reference_cases("test_autoscale", only=(), subs=SUBS)
#: ``tests/test_autoscale.py`` run against the port, for ``_drive_burst``
PORT = sys.modules["_port_test_autoscale"]


@pytest.fixture(scope="module")
def planes():
    return make_setup({"v1": 1})


def _jax_factory(planes):
    def factory(cfg, params, n_slots=2):
        def make(name):
            return planes.jax.engine("v1", n_slots=n_slots)
        return make
    return factory


def _view(mod, env, injector) -> dict:
    fleet = env["fleet"]
    svc = env["cluster"].get(mod.InferenceService, "default", "svc")
    return {
        "decision_log": list(env["scaler"].decision_log),
        "transitions": env["transitions"],
        "rids": env["rids"],
        "rejected": env["rejected"],
        "results": {rid: (res.state.value, np.asarray(res.tokens).tolist())
                    for rid, res in env["results"].items()},
        "stats": dict(fleet.stats),
        "retired": [dict(r) for r in fleet.retired],
        "chaos": None if injector is None else list(injector.events),
        "counters": dict(env["metrics"].counters),
        "gauges": dict(env["metrics"].gauges),
        "service": (svc.spec.replicas, svc.status.desired_replicas,
                    svc.status.autoscale_message),
    }


@pytest.mark.parametrize("crash", [False, True], ids=["plain", "crash"])
@pytest.mark.parametrize("seed", [0, 3, 7, 8])
def test_drive_burst_matches_the_reference(planes, monkeypatch, seed, crash):
    monkeypatch.setattr(ref, "_factory", _jax_factory(planes))

    def scenario(mod):
        if not crash:
            return None
        return mod.autoscale_under_crash(
            replica="replica-1", crash_at=3, outage_at=(2, 3, 4)).injector()

    jinj = scenario(ref.scenarios)
    try:
        want = _view(ref, ref._drive_burst(
            planes.cfg, planes.jax.trees["v1"], seed=seed, injector=jinj),
            jinj)
    finally:
        planes.jax.release()
    pinj = scenario(PORT.scenarios)
    got = _view(PORT, PORT._drive_burst(
        port_config(planes.cfg), planes.port.trees["v1"], seed=seed,
        injector=pinj), pinj)
    assert got["decision_log"] == want["decision_log"]
    assert got["transitions"] == want["transitions"]
    assert got == want
    # the loop scaled up and came back down, and under the scenario the
    # crash landed and the outage was held as stale
    dirs = ["u" if n > o else "d" for _, o, n in got["transitions"]]
    assert "u" in dirs and dirs[-1] == "d"
    if crash:
        assert got["stats"]["ejected"] == 1
        assert any("stale_signal" in line for line in got["decision_log"])


def test_the_card_phase_loop_on_its_cpu_twin():
    """``chip_smoke.py`` phase 15's loop (``fleet_burst``: the burst at
    phase 6 (c)'s prompt lengths, replicas of 8 slots x 1024 positions,
    the InferenceService CRD plane on the same cluster, ``status.slo`` and
    the replica pods checked after every tick) at its CPU twin, the tiny
    config with gpt2_small's vocabulary and 1024 positions: (a) the
    reference's burst gates hold; (b) under ``autoscale_under_crash`` the
    crash lands, the outage holds as stale and no request is lost, and the
    loop holds at 4 replicas with 3 ready, since its first scale went
    1 -> 4 in one step before the crash (the state the card's run is held
    to, through this twin's decision log)."""
    import dataclasses

    import chip_smoke
    from tpu_on_k8s_torch import chaos
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.transformer import TransformerConfig

    cfg = dataclasses.replace(
        TransformerConfig.tiny(), max_seq_len=chip_smoke.FLEET_MAX_LEN,
        vocab_size=chip_smoke.GPT2_HF_CONFIG["vocab_size"],
        dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                         dtype=torch.float32)
    a = chip_smoke.fleet_burst(cfg, params, "cpu",
                               seed=chip_smoke.FLEET_SEED)
    chip_smoke.burst_gates("(a)", a, crash=False)
    assert [(o, n) for _, o, n in a["transitions"]] == [(1, 4), (4, 2),
                                                        (2, 1)]
    assert a["ticks"]["slo_checked"] == a["ticks"]["n"] > 60
    inj = chaos.autoscale_under_crash(
        replica="replica-1", crash_at=3, outage_at=(2, 3, 4),
        seed=chip_smoke.FLEET_CRASH_SEED).injector()
    b = chip_smoke.fleet_burst(cfg, params, "cpu",
                               seed=chip_smoke.FLEET_CRASH_SEED, injector=inj)
    chip_smoke.burst_gates("(b)", b, crash=True)
    assert [(o, n) for _, o, n in b["transitions"]] == [(1, 4)]
    ready = [n for n, r in b["fleet"].replicas.items() if r.routable]
    assert b["svc"].spec.replicas == 4 and len(ready) == 3
    assert b["scaler"].decision_log[-1].endswith("reason=steady")
