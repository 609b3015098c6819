"""The port's trace export (``obs/export.py``: ``to_chrome_trace``,
``dump_chrome_trace``, ``load_trace``, ``FlightRecorder``) and the metrics
exposition of every metrics class the port has (``LedgerMetrics`` and
``BrokerMetrics`` among them) against the reference on the CPU.

The reference's ``tests/test_obs.py`` runs against the port through
``test_torch_api.reference_cases``: ``TestTracer``, ``TestExport`` (the
dump round trip, the Chrome trace's shape, the flight recorder's bounded
ring and its sequence-numbered dumps), ``TestTraceReport`` (the
reference's ``tools/trace_report.py`` decomposing the port's spans),
``TestExposition`` and ``TestOpenMetricsExemplars``, over the reference's
whole class list (the digital twin's ``SimMetrics`` among them). Not run
here: ``TestGatewaySpans`` (the serving plane's spans, held against the
JAX plane in the serve test files) and the docs and ``tools.analyze``
cases (the analyzer scans the reference's package). ``TestServeLoadTraceAcceptance`` runs on the port's
load driver and its ``obs/trace_report`` copy (``test_torch_api.TOOLS``,
applied to that class alone, so ``TestTraceReport`` keeps the reference's
tool), with ``--device cpu`` on its flags.

Here too: the same spans through both packages' exporters give the same
Chrome trace, byte for byte, and the same flight-recorder dump; a
recorder's dump of the port is read by the reference's ``load_trace``;
and the reference's ``tools/why_report.py`` resolves the chains of a
decision ledger that the port's capacity broker and its lanes wrote.
"""
from __future__ import annotations

import json
import re

from test_torch_api import TOOLS, reference_cases
from test_torch_autoscale import METRICS
from tpu_on_k8s.obs import export as rexport
from tpu_on_k8s.obs import trace as rtrace
from tpu_on_k8s_torch.obs import export as pexport
from tpu_on_k8s_torch.obs import trace as ptrace


def _load_driver_on_port(src: str) -> str:
    """``TestServeLoadTraceAcceptance`` (the module's last class) on the
    port's load driver and report, its flags on the CPU."""
    at = src.index("class TestServeLoadTraceAcceptance")
    tail = src[at:]
    for pattern, repl in TOOLS:
        tail = re.sub(pattern, repl, tail)
    tail = tail.replace('flags = ["--disagg",',
                        'flags = ["--device", "cpu", "--disagg",', 1)
    return src[:at] + tail


globals().update(reference_cases(
    "test_obs", only=("TestTracer", "TestExport", "TestTraceReport",
                      "TestExposition", "TestOpenMetricsExemplars",
                      "TestServeLoadTraceAcceptance"),
    subs=(METRICS, _load_driver_on_port)))


def test_the_reference_cases_are_collected_here():
    import sys

    names = set(globals())
    assert {"TestTracer", "TestExport", "TestTraceReport", "TestExposition",
            "TestOpenMetricsExemplars",
            "TestServeLoadTraceAcceptance"} <= names
    classes = sys.modules["_port_test_obs"]._ALL_CLASSES
    from tpu_on_k8s_torch.metrics import (BrokerMetrics, LedgerMetrics,
                                          SimMetrics)
    assert LedgerMetrics in classes and BrokerMetrics in classes
    assert SimMetrics in classes
    assert len(classes) == 14


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _traced(trace_mod, recorder=None):
    """A seeded span tree: requests with children, events, errors."""
    clock = _Clock()
    tr = trace_mod.Tracer(clock, recorder=recorder)
    for rid in range(6):
        root = tr.start("request", rid=rid, tenant=f"t{rid % 2}")
        q = tr.start("queue", parent=root, attempt=0)
        clock.t += 0.125 * (rid + 1)
        q.finish()
        p = tr.start("prefill", parent=root, attempt=0)
        clock.t += 0.5
        root.event("first_token", tokens=1)
        if rid == 3:
            p.finish("error")
            root.event("replay", n=1)
        else:
            p.finish()
        clock.t += 0.25
        if rid != 5:
            root.finish("done")             # request 5 stays open
    return tr


def test_chrome_trace_is_the_references_byte_for_byte(tmp_path):
    rt, pt = _traced(rtrace), _traced(ptrace)
    assert rt.export() == pt.export()
    assert pexport.to_chrome_trace(pt.spans) == rexport.to_chrome_trace(
        rt.spans)
    rp, pp = tmp_path / "r.json", tmp_path / "p.json"
    rexport.dump_chrome_trace(rt.spans, str(rp))
    pexport.dump_chrome_trace(pt.spans, str(pp))
    assert rp.read_bytes() == pp.read_bytes()
    doc = json.loads(pp.read_text())
    finished = [s for s in pt.export() if s["end"] is not None]
    assert sum(e["ph"] == "X" for e in doc["traceEvents"]) == len(finished)
    # a tracer's dump of the port loads in both packages
    pt.dump(str(tmp_path / "spans.json"))
    assert rexport.load_trace(str(tmp_path / "spans.json")) == \
        pexport.load_trace(str(tmp_path / "spans.json")) == pt.export()


def test_flight_recorder_dumps_equal_the_references(tmp_path):
    dumps = {}
    for name, tmod, emod in (("ref", rtrace, rexport),
                             ("port", ptrace, pexport)):
        rec = emod.FlightRecorder(capacity=5, directory=str(tmp_path / name))
        tr = _traced(tmod, recorder=rec)
        paths = [tr.crash_dump("engine_crash"), rec.dump("retry exhausted!")]
        dumps[name] = [(p.rsplit("/", 1)[1], open(p, "rb").read())
                       for p in paths]
        assert rec.dumps == paths and len(rec.snapshot()) == 5
    assert dumps["port"] == dumps["ref"]
    assert [n for n, _ in dumps["port"]] == [
        "flightrec-0001-engine_crash.json",
        "flightrec-0002-retry-exhausted-.json"]
    doc = json.loads(dumps["port"][0][1])
    assert rexport.load_trace(str(tmp_path / "port" / dumps["port"][0][0])) \
        == doc["spans"]


def test_why_report_reads_the_port_brokers_ledger(tmp_path):
    """The reference's causal-query tool over a ledger the port's broker
    wrote: a serving lane's refused scale-up climbs harvest then preempt,
    and each victim's record carries the requester's page trigger."""
    from tools import why_report
    from tpu_on_k8s_torch.coordinator.broker import (
        KIND_BATCH, KIND_SERVING, KIND_TRAINING, PRIORITY_BATCH,
        PRIORITY_SERVING, PRIORITY_TRAINING, Bid, CapacityBroker)
    from tpu_on_k8s_torch.metrics import BrokerMetrics, LedgerMetrics
    from tpu_on_k8s_torch.obs.ledger import DecisionLedger

    clock = _Clock()
    led = DecisionLedger(clock, metrics=LedgerMetrics())
    broker = CapacityBroker(8, ledger=led, metrics=BrokerMetrics())
    state = {"svc": 2, "train": 4, "bat": 2}
    spec = {"svc": (KIND_SERVING, PRIORITY_SERVING, 1),
            "train": (KIND_TRAINING, PRIORITY_TRAINING, 2),
            "bat": (KIND_BATCH, PRIORITY_BATCH, 0)}

    def bid(name):
        kind, prio, floor = spec[name]
        return Bid(name=name, kind=kind, priority=prio,
                   current=state[name], desired=state[name], floor=floor)

    def apply(name, target, reason):
        state[name] = target
        return True

    for name in state:
        broker.register(name, lambda n=name: bid(n),
                        apply_fn=lambda t, r, n=name: apply(n, t, r),
                        managed=name == "bat")
    broker.run_once()
    for _ in range(3):
        clock.t += 10.0
        if not broker.request_capacity("svc", state["svc"], 6,
                                       urgent=True, trigger="slo_page:svc#1"):
            broker.run_once()
    path = tmp_path / "ledger.json"
    led.dump(str(path))
    report = why_report.build_report(why_report.load_ledger(str(path)))
    victims = {c["decision"]["loop"]: c["decision"]["reason"]
               for c in report["chains"]
               if c["decision"]["reason"].startswith(("harvest", "preempt"))}
    assert victims == {"broker/bat": "harvest:svc",
                       "broker/train": "preempt:svc"}, victims
    for chain in report["chains"]:
        if chain["decision"]["loop"] in victims:
            assert chain["decision"]["trigger"] == "slo_page:svc#1"
    assert (state["svc"], state["train"], state["bat"]) == (2, 2, 0)
