"""The port's load driver (``tpu_on_k8s_torch/serve_load.py``) against the
reference's (``tools/serve_load.py``), on the CPU.

Both drivers' ``main`` run on the same flags over the same weights: the
tiny fp32 model the JAX package initialises, carried across with
``from_jax_params`` (``test_torch_serve_gateway.make_setup``); each
``main``'s own initialiser is patched to hand it that tree, since the
reference's ``jax.random.key(0)`` init cannot be reproduced in torch. The
flags are the Makefile's soak targets' at a smaller ``--n-requests``; the
port's run adds ``--device cpu``.

* The virtual-clock modes (``--autoscale`` with ``--ledger-out`` and an
  SLO page, ``--slo`` with ``--slo-out``, ``--spec``, ``--paged``,
  ``--disagg``, each with ``--trace-out`` where the mode takes it): the
  summaries, the printed JSON line, the ``*_SOAK_OK`` line, the decision
  ledger and SLO dumps (read through ``to_ref_wire``, the API-group map)
  and the trace dumps (byte for byte) equal the reference's. One engine
  step advances ``--step-dt``, and TTFT, queue wait, cooldowns, burns and
  the cost-model TPOT all read that clock, so an engine that steps
  otherwise shows as a difference; nothing is rounded away. The port's
  ``main`` twice gives the same bytes.
* The host-clock modes (the gateway, ``--replicas`` with ``--soak
  --crash-replica 1 --crash-step 5``) read ``time.monotonic``: there the
  outcome counts, each request's tokens and final state, the summary's
  keys and the per-replica states and routing equal the reference's.
  Latencies are compared where both packages' ``run_load`` /
  ``run_fleet_load`` get the same stepped fake clock.
* The port's ``obs/trace_report`` and ``obs/why_report`` give the
  reference tools' reports on the same port-written dumps.

Tolerances: none.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import tools.serve_load as ref
import tools.trace_report as rtrace_report
import tools.why_report as rwhy_report
import tpu_on_k8s.models.transformer as jtransformer
import tpu_on_k8s.serve as jserve
import tpu_on_k8s_torch.models.params as pparams_mod
import tpu_on_k8s_torch.serve as pserve
import tpu_on_k8s_torch.serve_load as port
from test_torch_api import REF_ACCELERATOR, to_ref_wire
from test_torch_serve_gateway import FakeClock, make_setup, port_config
from tpu_on_k8s.obs.export import load_trace as rload_trace
from tpu_on_k8s_torch.obs import trace_report as ptrace_report
from tpu_on_k8s_torch.obs import why_report as pwhy_report
from tpu_on_k8s_torch.obs.export import load_trace as pload_trace

torch.set_num_threads(1)

#: the virtual-clock modes: the Makefile's soak flags at fewer requests
#: (the autoscale trace is the why-demo's: an SLO page grants the
#: scale-up its cooldown bypass, so the ledger holds a page chain)
VIRTUAL = {
    "autoscale": ["--autoscale", "--n-requests", "40",
                  "--rate", "1.0", "--burst-start", "6", "--burst-len", "10",
                  "--burst-rate", "6.0", "--autoscale-slo", "0.3",
                  "--autoscale-slo-window", "0.8", "--flap-guard", "2.0",
                  "--seed", "2468", "--ledger-out", "ledger.json",
                  "--trace-out", "trace.json"],
    "slo": ["--slo", "--n-requests", "40", "--rate", "0.4",
            "--n-slots", "8", "--prompt-min", "4", "--prompt-max", "12",
            "--new-min", "4", "--new-max", "10", "--slo-target-ttft", "0.2",
            "--slo-regress-step", "60", "--slo-window", "60",
            "--trace-out", "trace.json", "--slo-out", "slo.json",
            "--seed", "9753"],
    "spec": ["--spec", "--n-requests", "12", "--rate", "2.0",
             "--prompt-min", "4", "--prompt-max", "12", "--new-min", "6",
             "--new-max", "16", "--seed", "7531", "--trace-out",
             "trace.json"],
    "paged": ["--paged", "--n-requests", "32", "--seed", "3141"],
    "disagg": ["--disagg", "--n-requests", "12",
               "--prefix-bucket", "8", "--prompt-min", "4",
               "--prompt-max", "12", "--new-min", "4", "--new-max", "8",
               "--decode-replicas", "2", "--shared-prefixes", "2",
               "--shared-fraction", "0.8", "--seed", "8642",
               "--trace-out", "trace.json"],
}
DUMPS = ("trace.json", "ledger.json", "slo.json")
GATEWAY = ["--n-requests", "16", "--rate", "3.0", "--seed", "5"]
FLEET = ["--replicas", "2", "--soak", "--n-requests", "24", "--rate", "2.0",
         "--prefix-bucket", "8", "--crash-replica", "1", "--crash-step", "5",
         "--seed", "4321"]


@pytest.fixture(scope="module")
def planes():
    return make_setup({"v1": 0})


@pytest.fixture
def weights(planes, monkeypatch):
    """Each ``main`` initialises the carried tree: the reference's flax
    ``init`` and the port's ``init_params`` return the fixture's weights
    (the config is the tiny fp32 one both drivers build)."""
    jtree, ptree = planes.jax.trees["v1"], planes.port.trees["v1"]
    init = jtransformer.Transformer.init

    def carried(self, *args, **kw):
        # main's ``model.init(key, probe)`` with its [1, 8] probe; every
        # other init (the engines' cache shapes) is flax's own
        if len(args) == 2 and not kw and getattr(args[1], "shape",
                                                 None) == (1, 8):
            return {"params": jtree}
        return init(self, *args, **kw)

    monkeypatch.setattr(jtransformer.Transformer, "init", carried)
    monkeypatch.setattr(pparams_mod, "init_params",
                        lambda cfg, gen, dev, dtype=None: ptree)
    return planes


def _run(main, flags, where: Path, capsys, monkeypatch):
    """``main(flags)`` in ``where`` (the dumps' relative paths land
    there): (summary, stdout, stderr)."""
    where.mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(where)
    capsys.readouterr()
    summary = main(flags)
    out = capsys.readouterr()
    return summary, out.out, out.err


def _both(flags, tmp_path, capsys, monkeypatch, main_r=None, main_p=None):
    want = _run(main_r or ref.main, flags, tmp_path / "ref", capsys,
                monkeypatch)
    got = _run(main_p or port.main, flags + ["--device", "cpu"],
               tmp_path / "port", capsys, monkeypatch)
    return want, got


def _soak_line(err: str) -> str:
    lines = [x for x in err.splitlines() if "_SOAK_" in x]
    assert len(lines) == 1, err
    return lines[0]


def _virtual(summary: dict) -> dict:
    """A virtual-clock summary without ``wall_s`` (the paged probe's
    host-clock reading beside its counters)."""
    return {k: v for k, v in summary.items() if k != "wall_s"}


def _json_line(out: str) -> dict:
    return _virtual(json.loads(out.splitlines()[-1]))


def check_virtual_mode(mode, tmp_path, capsys, monkeypatch):
    """Both drivers' ``main`` on ``VIRTUAL[mode]``: summaries, the printed
    line and the dumps equal under the map."""
    flags = VIRTUAL[mode]
    (want, want_out, _), (got, got_out, _) = _both(
        flags, tmp_path, capsys, monkeypatch)
    assert to_ref_wire(_virtual(got)) == _virtual(want)
    assert to_ref_wire(_json_line(got_out)) == _json_line(want_out)
    assert _json_line(got_out) == json.loads(json.dumps(_virtual(got)))
    for name in DUMPS:
        mine, theirs = tmp_path / "port" / name, tmp_path / "ref" / name
        assert mine.exists() == theirs.exists() == (name in flags), name
        if not mine.exists():
            continue
        if name == "trace.json":
            assert mine.read_bytes() == theirs.read_bytes()
        else:
            assert to_ref_wire(json.loads(mine.read_text())) == \
                json.loads(theirs.read_text())
    return got


@pytest.mark.parametrize("mode", ["autoscale", "slo"])
def test_virtual_clock_mode_matches_the_reference(mode, weights, tmp_path,
                                                  capsys, monkeypatch):
    got = check_virtual_mode(mode, tmp_path, capsys, monkeypatch)
    if mode == "autoscale":
        assert got["scale_ups"] >= 1 and got["ledger_page_chains"] >= 1
        assert any("reason=slo_page" in line for line in got["decisions"])
    else:
        assert got["burn_page_step"] is not None
        assert got["page_exemplars"]


@pytest.mark.parametrize("mode", list(VIRTUAL))
def test_the_soak_replays_byte_for_byte(mode, weights, tmp_path, capsys,
                                        monkeypatch):
    """The port's ``main --soak`` twice: the same printed line (less the
    paged probe's ``wall_s``) and dumps, and the reference's
    ``*_SOAK_OK seed=N`` line."""
    flags = VIRTUAL[mode] + ["--soak", "--device", "cpu"]
    runs = [_run(port.main, flags, tmp_path / str(i), capsys, monkeypatch)
            for i in range(2)]
    seed = flags[flags.index("--seed") + 1]
    for summary, out, err in runs:
        assert summary["soak_ok"] is True
        assert _soak_line(err) == f"{mode.upper()}_SOAK_OK seed={seed}"
    assert _json_line(runs[0][1]) == _json_line(runs[1][1])
    for name in DUMPS:
        if name in flags:
            assert (tmp_path / "0" / name).read_bytes() == \
                (tmp_path / "1" / name).read_bytes()


def test_the_autoscale_ledger_resolves_a_page_chain(weights, tmp_path,
                                                    capsys, monkeypatch):
    """The autoscale trace's page chain, and both report tools' reports on
    the port-written dumps: the port's copies give the reference tools'
    reports."""
    flags = list(VIRTUAL["autoscale"])
    # the why-demo's 160 requests, cut to the fewest that still re-page
    # after the scale-down and close a chain with a live burn recovery
    flags[flags.index("--n-requests") + 1] = "120"
    got, _, _ = _run(port.main, flags + ["--device", "cpu"], tmp_path,
                     capsys, monkeypatch)
    assert got["ledger_complete_page_chains"] >= 1
    assert got["scale_ups"] >= 1 and got["slo_event_log"]
    spans_p = pload_trace(str(tmp_path / "trace.json"))
    spans_r = rload_trace(str(tmp_path / "trace.json"))
    assert spans_p == spans_r
    for top in (1, 3):
        assert ptrace_report.build_report(spans_p, top=top) == \
            rtrace_report.build_report(spans_r, top=top)
    assert ptrace_report.render(ptrace_report.build_report(spans_p)) == \
        rtrace_report.render(rtrace_report.build_report(spans_r))
    doc_p = pwhy_report.load_ledger(str(tmp_path / "ledger.json"))
    doc_r = rwhy_report.load_ledger(str(tmp_path / "ledger.json"))
    for at in (None, 1.0, 5.0):
        assert pwhy_report.build_report(doc_p, spans_p, at=at) == \
            rwhy_report.build_report(doc_r, spans_r, at=at)
    assert pwhy_report.merged_timeline(spans_p, doc_p) == \
        rwhy_report.merged_timeline(spans_r, doc_r)
    argv = [str(tmp_path / "ledger.json"), "--trace",
            str(tmp_path / "trace.json"), "--check", "--page"]
    assert pwhy_report.main(argv) == rwhy_report.main(argv) == 0
    out = capsys.readouterr()
    half = len(out.out) // 2
    assert out.out[:half] == out.out[half:]
    assert "WHY_CHECK_OK" in out.err
    assert ptrace_report.main([str(tmp_path / "trace.json"), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == \
        rtrace_report.build_report(spans_r, top=3)


# ---- the host-clock modes ---------------------------------------------------

def _recording(monkeypatch, cls, store: dict) -> None:
    """``cls.result`` also records each result it hands out (state and
    tokens), warm-up requests included."""
    orig = cls.result

    def result(self, rid):
        res = orig(self, rid)
        if res is not None:
            store[rid] = (res.state.value, np.asarray(res.tokens).tolist())
        return res

    monkeypatch.setattr(cls, "result", result)


#: summary keys that read the host's clock
WALL = ("value", "wall_s", "ttft_ms_p50", "ttft_ms_p95", "ttft_ms_p99",
        "tpot_ms_p50", "tpot_ms_p99", "queue_wait_ms_p50",
        "queue_wait_ms_p95", "queue_wait_ms_p99")


def _off_clock(summary: dict) -> dict:
    out = {k: v for k, v in summary.items() if k not in WALL}
    if "per_replica" in out:
        out["per_replica"] = {n: _off_clock(r)
                              for n, r in out["per_replica"].items()}
    return out


def test_gateway_mode_matches_the_reference(weights, tmp_path, capsys,
                                            monkeypatch):
    """The gateway mode's ``main``: warm-up drawn from the trace's rng
    after ``build_workload``, then ``run_load``."""
    results = {"ref": {}, "port": {}}
    _recording(monkeypatch, jserve.ServingGateway, results["ref"])
    _recording(monkeypatch, pserve.ServingGateway, results["port"])
    (want, _, _), (got, got_out, _) = _both(GATEWAY, tmp_path, capsys,
                                            monkeypatch)
    assert got.keys() == want.keys()
    assert _off_clock(got) == _off_clock(want)
    assert results["port"] == results["ref"] and len(results["ref"]) == 16
    assert got["served"] == 16 and got["tokens"] > 0
    for k in WALL:
        if k in want:
            assert (got[k] is None) == (want[k] is None), k
    assert json.loads(got_out.splitlines()[-1]) == got


def test_fleet_soak_matches_the_reference(weights, tmp_path, capsys,
                                          monkeypatch):
    """``--replicas 2 --soak`` with replica-1 crashed at its fifth step:
    the ejection, the replays, every request's tokens and the soak line."""
    results = {"ref": {}, "port": {}}
    _recording(monkeypatch, jserve.ServingFleet, results["ref"])
    _recording(monkeypatch, pserve.ServingFleet, results["port"])
    (want, _, want_err), (got, _, got_err) = _both(FLEET, tmp_path, capsys,
                                                   monkeypatch)
    assert got.keys() == want.keys()
    assert _off_clock(got) == _off_clock(want)
    assert results["port"] == results["ref"] and len(results["ref"]) == 24
    assert {n: (r["routed"], r["state"])
            for n, r in got["per_replica"].items()} == \
        {n: (r["routed"], r["state"]) for n, r in want["per_replica"].items()}
    assert got["ejected"] == 1 and got["soak_ok"] is True
    assert _soak_line(got_err) == _soak_line(want_err) == \
        "FLEET_SOAK_OK seed=4321"


def _stepped(obj, clock: FakeClock, dt: float = 0.05) -> None:
    """``obj.step`` advances ``clock`` by ``dt`` before each step."""
    step = obj.step

    def stepped():
        clock.advance(dt)
        return step()

    obj.step = stepped


def test_run_load_on_a_stepped_clock_matches_the_reference(planes):
    """``run_load`` on both packages' gateways, each over its engine, with
    one stepped fake clock for the gateway and the throughput: the whole
    summary, latencies included, equals the reference's."""
    def scenario(plane, mod):
        clock = FakeClock()
        eng = plane.engine(n_slots=2)
        gw = plane.serve.ServingGateway(
            eng, plane.serve.AdmissionConfig(max_queue_depth=4),
            metrics=plane.metrics.ServingMetrics(), clock=clock)
        _stepped(gw, clock)
        trace = mod.build_workload(np.random.default_rng(7), 10, rate=3.0,
                                   vocab_size=256)
        return mod.run_load(gw, trace, time_fn=clock)

    try:
        want = scenario(planes.jax, ref)
    finally:
        planes.jax.release()
    got = scenario(planes.port, port)
    assert got == want
    assert got["ttft_ms_p50"] is not None and got["wall_s"] > 0


def test_run_fleet_load_on_a_stepped_clock_matches_the_reference(planes):
    """``run_fleet_load`` through both packages' two-replica fleets on one
    stepped fake clock: the summary with its per-replica TTFT and queue
    wait equals the reference's."""
    def scenario(plane, mod):
        clock = FakeClock()
        S = plane.serve
        fleet = S.ServingFleet(
            lambda name: plane.engine(n_slots=2), 2,
            admission=S.AdmissionConfig(max_queue_depth=8),
            probe=S.ProbeConfig(slow_start_steps=1),
            router=S.Router(prefix_bucket_len=8), clock=clock)
        for _ in range(3):
            fleet.step()
        _stepped(fleet, clock)
        trace = mod.build_workload(np.random.default_rng(7), 12, rate=3.0,
                                   vocab_size=256, shared_prefixes=2,
                                   shared_prefix_len=8, shared_fraction=0.6)
        return mod.run_fleet_load(fleet, trace, time_fn=clock)

    try:
        want = scenario(planes.jax, ref)
    finally:
        planes.jax.release()
    got = scenario(planes.port, port)
    assert got == want
    assert set(got["per_replica"]) == {"replica-0", "replica-1"}


# ---- the driver's own surface -----------------------------------------------

class _Parsed(Exception):
    """Carries the parser ``main`` built out of ``main``."""


def _actions(parser) -> dict:
    return {a.option_strings[0]: (a.default, a.type, type(a).__name__)
            for a in parser._actions if a.option_strings[0] != "-h"}


def test_flags_are_the_references_with_the_gpu_flavour(monkeypatch):
    """Every flag of the reference's parser with its default, type and
    action; ``--accelerator`` on the GPU host type and ``--device`` added
    (default ``cuda``)."""
    def grab(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as caught:
        ref.main([])
    monkeypatch.undo()
    want = _actions(caught.value.args[0])
    got = _actions(port.build_parser())
    assert got.pop("--device") == ("cuda", None, "_StoreAction")
    assert want.pop("--accelerator")[0] == REF_ACCELERATOR
    assert got.pop("--accelerator")[0] == "nvidia-h100-80gb"
    assert got == want


def test_bench_config_is_the_references_field_for_field():
    from bench import bench_config

    want, got = bench_config(), port.bench_config()
    for f in dataclasses.fields(want):
        if f.name in ("dtype", "param_dtype"):
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.int8_impl == "xla" and got.attn_impl == "flash"
    assert got.head_dim == 64 and got.dtype == torch.bfloat16


def test_the_card_is_the_default_and_the_cpu_only_when_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port.main(["--n-requests", "1"])


def test_the_tiny_config_is_the_references(planes):
    cfg = dataclasses.replace(
        port.TransformerConfig.tiny(), dtype=torch.float32, max_seq_len=64)
    assert cfg == port_config(planes.cfg)
