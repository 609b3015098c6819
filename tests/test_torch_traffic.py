"""The port's seeded traffic (``tpu_on_k8s_torch/sim/traffic.py``) and the
chaos names the load driver's slice adds (``SITE_REGISTRY``,
``last_event_seq``, ``FaultInjector.last_seq``) against the reference, on
the CPU.

``build_workload`` and ``build_diurnal_trace`` are numpy only: one seeded
``np.random.default_rng`` must give the reference's arrays bit for bit, at
several seeds, with shared prefixes, bursts, deadlines, tenants and a model
mix. The reference's ``tests/test_sim.py::TestDiurnalTrace`` runs against
the port (``test_torch_api.reference_functions``: the rest of that module
reaches the twin's later slice). ``SITE_REGISTRY``'s keys are the port's
``SITE_*`` names and each row is the reference's; ``last_event_seq`` reads
the reference's after the same seeded scenario. Tolerances: none.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import tpu_on_k8s.chaos as rchaos
import tpu_on_k8s.chaos.faults as rfaults
import tpu_on_k8s.sim as rsim
import tpu_on_k8s.sim.traffic as rtraffic
import tpu_on_k8s_torch.chaos as pchaos
import tpu_on_k8s_torch.sim as psim
import tpu_on_k8s_torch.sim.traffic as ptraffic
from test_torch_api import reference_functions

TestDiurnalTrace = reference_functions(
    "test_sim", ["TestDiurnalTrace"],
    {"np": np, "pytest": pytest,
     "build_diurnal_trace": psim.build_diurnal_trace,
     "DiurnalProfile": psim.DiurnalProfile,
     "TenantMix": psim.TenantMix})["TestDiurnalTrace"]

#: build_workload's keyword sets: the soak traces of every driver mode
WORKLOADS = {
    "default": dict(),
    "deadlines": dict(rate=3.0, deadline_s=2.5, deadline_fraction=0.4,
                      tenants=("a", "b", "c", "d")),
    "shared": dict(prompt_lens=(4, 12), new_tokens=(4, 8), shared_prefixes=2,
                   shared_prefix_len=8, shared_fraction=0.8),
    "burst": dict(rate=1.0, burst_start=6, burst_len=10, burst_rate=6.0,
                  vocab_size=32768),
    "bench_trace": dict(rate=1.5, prompt_lens=(8, 64), shared_prefixes=2,
                        shared_prefix_len=128, shared_fraction=0.8,
                        burst_start=6, burst_len=10, burst_rate=6.0,
                        vocab_size=32768),
}


def _arrivals(mod, seed, n, kw):
    return [dataclasses.asdict(a) for a in
            mod.build_workload(np.random.default_rng(seed), n, **kw)]


@pytest.mark.parametrize("seed", [0, 7, 2468])
@pytest.mark.parametrize("kind", list(WORKLOADS))
def test_build_workload_matches_the_reference(kind, seed):
    want = _arrivals(rtraffic, seed, 48, WORKLOADS[kind])
    got = _arrivals(ptraffic, seed, 48, WORKLOADS[kind])
    assert len(got) == len(want) == 48
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if k == "prompt":
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k
    # the generator leaves the rng where the reference's does: the gateway
    # mode's warm-up draws from it next
    r, p = np.random.default_rng(seed), np.random.default_rng(seed)
    rtraffic.build_workload(r, 12, **WORKLOADS[kind])
    ptraffic.build_workload(p, 12, **WORKLOADS[kind])
    assert r.integers(0, 1 << 30) == p.integers(0, 1 << 30)


def _diurnal_kw(mod, models: bool):
    kw = dict(profile=mod.DiurnalProfile(base_rate=5.0, amplitude=0.5,
                                         period_s=120.0, peak_at_s=60.0,
                                         bursts=((30.0, 10.0, 3.0),)),
              tenants=mod.TenantMix(names=("a", "b"), weights=(3.0, 1.0)),
              duration_s=300.0, tick_s=0.5, prompt_lens=(4, 24),
              new_tokens=(4, 16))
    if models:
        kw["models"] = mod.ModelMix.zipf(6)
    return kw


@pytest.mark.parametrize("models", [False, True], ids=["single", "zipf"])
@pytest.mark.parametrize("seed", [0, 7, 97])
def test_build_diurnal_trace_matches_the_reference(seed, models):
    want = rtraffic.build_diurnal_trace(np.random.default_rng(seed),
                                        **_diurnal_kw(rtraffic, models))
    got = ptraffic.build_diurnal_trace(np.random.default_rng(seed),
                                       **_diurnal_kw(ptraffic, models))
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
        else:
            assert a == b, f.name
    assert got.n == want.n > 0 and got.n_ticks == want.n_ticks
    assert got.tenant_counts() == want.tenant_counts()
    assert got.model_counts() == want.model_counts()
    assert [got.model_of(j) for j in range(0, got.n, 97)] == \
        [want.model_of(j) for j in range(0, want.n, 97)]
    mine = _diurnal_kw(ptraffic, models)["profile"]
    theirs = _diurnal_kw(rtraffic, models)["profile"]
    for t in (0.0, 35.0, 59.9, 250.0):
        assert ptraffic.diurnal_rate(mine, t) == \
            rtraffic.diurnal_rate(theirs, t)


@pytest.mark.parametrize("bad", [
    lambda m: m.TenantMix(names=("a",), weights=(1.0, 2.0)),
    lambda m: m.TenantMix(names=("a", "b"), weights=(-1.0, 2.0)),
    lambda m: m.ModelMix(names=(), weights=()),
    lambda m: m.ModelMix.zipf(0),
    lambda m: m.DiurnalProfile(amplitude=1.5),
    lambda m: m.DiurnalProfile(base_rate=0.0),
    lambda m: m.build_diurnal_trace(np.random.default_rng(0),
                                    profile=m.DiurnalProfile(),
                                    duration_s=0.0)])
def test_invalid_traffic_raises_as_the_reference(bad):
    with pytest.raises(ValueError) as want:
        bad(rtraffic)
    with pytest.raises(ValueError) as got:
        bad(ptraffic)
    assert str(got.value) == str(want.value)


def test_sim_exports_the_traffic_names_only():
    """The package's traffic names are the traffic module's own. Since the
    twin's slice the package exports the reference's whole list (the clock,
    the devices, the scenario and the twin), and ``ModelMix`` beside it."""
    traffic = {"Arrival", "ArrivalTrace", "DiurnalProfile", "ModelMix",
               "TenantMix", "build_diurnal_trace", "build_workload",
               "diurnal_rate"}
    assert set(psim.__all__) == set(rsim.__all__) | {"ModelMix"}
    assert traffic <= set(psim.__all__)
    for name in traffic:
        assert getattr(psim, name) is getattr(ptraffic, name)


# ---- chaos: the site catalog and the injector's high-water mark -------------

def _sites(mod) -> dict:
    return {n: v for n, v in vars(mod).items()
            if n.startswith("SITE_") and n != "SITE_REGISTRY"}


def test_site_registry_covers_every_site_as_the_reference():
    sites = _sites(pchaos)
    assert set(pchaos.SITE_REGISTRY) == set(sites.values())
    assert sites == _sites(rfaults)
    assert pchaos.SITE_REGISTRY == rfaults.SITE_REGISTRY
    for site, (where, faults, recovery) in pchaos.SITE_REGISTRY.items():
        assert where and recovery
        for name in faults:
            assert issubclass(getattr(pchaos, name), pchaos.Fault), name


def _scenario(mod):
    """A seeded schedule over three sites, fired in one fixed order; the
    high-water mark read after each call."""
    rules = [mod.FaultRule(mod.SITE_SERVE_STEP, mod.Trigger(at=(2, 5)),
                           mod.EngineCrash(), note="crash"),
             mod.FaultRule(mod.SITE_FLEET_REPLICA, mod.Trigger(
                 prob=0.4, match={"replica": "replica-1"}),
                 mod.ReplicaCrash()),
             mod.FaultRule(mod.SITE_KV_HANDOFF, mod.Trigger(every=3),
                           mod.HandoffLoss())]
    marks = [mod.last_event_seq()]
    inj = mod.FaultInjector(rules, seed=11, name="seq")
    with inj:
        marks.append(mod.last_event_seq())
        for i in range(24):
            site = (mod.SITE_SERVE_STEP, mod.SITE_FLEET_REPLICA,
                    mod.SITE_KV_HANDOFF)[i % 3]
            fault, seq = mod.fire_seq(site, replica=f"replica-{i % 2}")
            marks.append((type(fault).__name__ if fault else None, seq,
                          mod.last_event_seq(), inj.last_seq))
    marks.append(mod.last_event_seq())
    return marks, list(inj.events), inj.last_seq


def test_last_event_seq_matches_the_reference():
    got, want = _scenario(pchaos), _scenario(rchaos)
    assert got == want
    marks, events, last = got
    assert marks[0] == marks[1] == marks[-1] == 0
    assert last == len(events) > 3
