"""End-to-end chaos soak: the scripted recovery scenario, twice, compared
(the counterpart of the reference's ``tools/chaos_soak.py``).

One fixed seed drives three staged recoveries against the port's stack:

1. **Operator stage** (REST backend, live controller threads): drop the Pod
   watch stream on its first live frame and refuse the next two reconnect
   dials (``chaos.watch_outage``), prove the informer recovers and the job
   reaches all-Running; then preempt a whole worker slice with Evicted
   (``chaos.slice_preemption``) and prove exit-code failover replaces every
   slice pod and returns the job to Running. The job is a ``TorchJob`` on
   one ``4x8`` slice of ``nvidia-h100-80gb`` hosts (the reference's v5e
   ``4x4`` is four hosts), so ``SlicePreempt(0)`` takes every worker.
2. **Serve stage**: crash the continuous-batching engine mid-decode
   (``chaos.engine_crash_mid_decode``) under a ``ServingGateway``; every
   surviving in-flight request must finish via replay with tokens equal to
   ``models/decode.generate``'s, and a crash-every-step run must account
   exhausted requests as ``retry_exhausted``: zero requests silently lost.
   The model is the reference's ``tiny`` in fp32 with ``max_seq_len`` 64 by
   default, its parameters drawn from a torch seed; ``run_serve_stage``
   takes another config and parameters.
3. **Train stage**: preempt the training loop at an injected step, with
   the preemption-time save ALSO failing, so the resume falls back to the
   last periodic checkpoint, and prove the resumed run reproduces the
   no-fault loss trajectory bit for bit (``train/loop.TrainLoop``,
   ``train/checkpoint.CheckpointManager``).

Each stage contributes deterministic lines to one event log (injected
faults and recovery outcomes, no timestamps); ``--repeat 2`` (the default)
runs the whole scenario again under the same seed and asserts the two logs
are identical.

Usage::

    python -m tpu_on_k8s_torch.chaos_soak                 # seed 1234, card
    python -m tpu_on_k8s_torch.chaos_soak --device cpu --skip-operator

On failure the seed is printed (``CHAOS_SOAK_FAILED seed=...``) on stderr so
the exact run can be replayed. The default device is ``cuda``, which raises
without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_on_k8s_torch import chaos
from tpu_on_k8s_torch.device import resolve_device

DEFAULT_SEED = 1234


def _wait_until(pred: Callable[[], bool], timeout_s: float,
                what: str, poll_s: float = 0.05) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(poll_s)
    raise AssertionError(f"timed out after {timeout_s}s waiting for {what}")


# ------------------------------------------------------------ operator stage
def run_operator_stage(seed: int) -> Tuple[List[str], Dict]:
    from tpu_on_k8s_torch.api.core import (
        Container,
        ObjectMeta,
        Pod,
        PodPhase,
        PodSpec,
        PodTemplateSpec,
    )
    from tpu_on_k8s_torch.api.types import (
        GPUPolicy,
        RestartPolicy,
        TaskSpec,
        TaskType,
        TorchJob,
        TorchJobSpec,
    )
    from tpu_on_k8s_torch.client import KubeletSim
    from tpu_on_k8s_torch.client.apiserver import ApiServer
    from tpu_on_k8s_torch.client.rest import RestCluster
    from tpu_on_k8s_torch.controller.torchjob import submit_job
    from tpu_on_k8s_torch.main import Operator, build_parser

    events: List[str] = []
    template = PodTemplateSpec(
        spec=PodSpec(containers=[Container(name="torch", image="i")]))
    # 4x8 = one slice of four 8-GPU hosts: SlicePreempt(0) takes every worker
    job = TorchJob(
        metadata=ObjectMeta(name="chaos-soak"),
        spec=TorchJobSpec(
            tasks={TaskType.MASTER: TaskSpec(num_tasks=1, template=template),
                   TaskType.WORKER: TaskSpec(
                       num_tasks=4, template=template,
                       restart_policy=RestartPolicy.ON_EXIT_CODE)},
            gpu_policy=GPUPolicy(accelerator="nvidia-h100-80gb",
                                 topology="4x8")))

    server = ApiServer().start()
    operator_client = RestCluster(server.url)
    kubelet_client = RestCluster(server.url)
    op = Operator(build_parser().parse_args(
        ["--coordinator-period-seconds", "0.02"]), cluster=operator_client)
    sim = KubeletSim(kubelet_client)

    def kubelet_tick() -> None:
        sim.run_all("default")

    def workers() -> List:
        return [p for p in kubelet_client.list(Pod, "default")
                if "worker" in p.metadata.name]

    def all_running(n_total: int = 5) -> bool:
        kubelet_tick()
        pods = kubelet_client.list(Pod, "default")
        return (len(pods) == n_total
                and all(p.status.phase == PodPhase.RUNNING for p in pods))

    outage = chaos.watch_outage(kind="Pod", reconnect_failures=2, seed=seed)
    inj = outage.injector()
    try:
        # ---- phase 0: healthy rollout ------------------------------------
        op._start_workers()
        submit_job(operator_client, job)
        _wait_until(all_running, 60.0, "healthy rollout to all-Running")

        # ---- phase 1: watch outage on the live stream --------------------
        chaos.install(inj)
        # provoke one Pod frame so the drop rule fires on a live stream
        kubelet_client.patch_meta(Pod, "default", "chaos-soak-master-0",
                                  annotations={"chaos/poke": "watch"})
        _wait_until(lambda: inj.fired_total() >= 3, 30.0,
                    "watch drop + 2 refused reconnect dials to fire")
        chaos.uninstall(inj)
        events.extend(inj.events)
        events.append("operator: watch outage survived, job all-Running")

        # ---- phase 2: slice preemption (Evicted) -------------------------
        before_uids = {p.metadata.uid for p in workers()}
        preempt = chaos.slice_preemption("default/chaos-soak",
                                         slice_index=0, seed=seed)
        inj2 = preempt.injector()
        chaos.install(inj2)
        # touch the job so a reconcile (carrying the injected fault) runs now
        operator_client.patch_meta(TorchJob, "default", "chaos-soak",
                                   annotations={"chaos/poke": "1"})
        _wait_until(lambda: inj2.fired_total() >= 1, 30.0,
                    "slice preemption to fire")

        def slice_replaced() -> bool:
            kubelet_tick()
            ws = workers()
            return (len(ws) == 4
                    and all(p.status.phase == PodPhase.RUNNING for p in ws)
                    and not ({p.metadata.uid for p in ws} & before_uids))

        _wait_until(slice_replaced, 60.0,
                    "every slice pod replaced and Running via failover")
        _wait_until(all_running, 30.0, "job back to all-Running")
        chaos.uninstall(inj2)
        events.extend(inj2.events)
        # the replacements must be visible through the operator's OWN watch
        # pipeline (stream resume or re-list): proof the informer is not
        # deaf after the outage, not just that failover LISTed its way out
        replaced_uids = {p.metadata.uid for p in workers()}

        def informer_sees_replacements() -> bool:
            with operator_client._watch_lock:
                cached = {o.metadata.uid
                          for o in operator_client._known.get("Pod",
                                                              {}).values()}
            return replaced_uids <= cached

        _wait_until(informer_sees_replacements, 30.0,
                    "operator informer cache to observe the replaced pods")
        events.append("operator: slice recovered via failover, replaced=4")
        summary = {"watch_faults": inj.fired_total(),
                   "slice_faults": inj2.fired_total(), "replaced": 4}
        return events, summary
    finally:
        chaos.uninstall()
        op.stop()
        operator_client.close()
        kubelet_client.close()
        server.stop()


# --------------------------------------------------------------- serve stage
def run_serve_stage(seed: int, cfg=None, params=None,
                    device: str | torch.device = "cuda"
                    ) -> Tuple[List[str], Dict]:
    """The serve stage on ``(cfg, params)``; by default the reference's
    ``tiny`` in fp32 with ``max_seq_len`` 64, its parameters drawn from
    torch seed 1 on ``device``."""
    from tpu_on_k8s_torch.metrics import ServingMetrics
    from tpu_on_k8s_torch.models.decode import generate
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.models.transformer import TransformerConfig
    from tpu_on_k8s_torch.serve import (
        ReplayPolicy,
        RequestState,
        ServingGateway,
    )

    dev = resolve_device(device)
    if cfg is None:
        cfg = dataclasses.replace(TransformerConfig.tiny(),
                                  dtype=torch.float32, max_seq_len=64)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             dev)
    events: List[str] = []
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 12, size=6)]

    # ---- crash mid-decode: everything finishes via replay ---------------
    metrics = ServingMetrics()
    engine = ContinuousBatchingEngine(cfg, params, n_slots=2, device=dev)
    # backoff 0: replays re-enter immediately, so the outcome accounting is
    # step-deterministic (independent of host speed) for the event log
    gateway = ServingGateway(engine, metrics=metrics,
                             replay=ReplayPolicy(max_replays=2,
                                                 backoff_base_s=0.0))
    rids = [gateway.submit(p, 6) for p in prompts]
    crash = chaos.engine_crash_mid_decode(at_steps=(3,), seed=seed)
    inj = crash.injector()
    with inj:
        out = gateway.run()
    events.extend(inj.events)
    lost = [r for r in rids if r not in out]
    assert not lost, f"requests silently lost: {lost}"
    exact = 0
    for rid, p in zip(rids, prompts):
        if out[rid].state is RequestState.DONE:
            want = generate(cfg, params,
                            torch.from_numpy(p)[None, :].to(dev),
                            max_new_tokens=6, device=dev)[0].cpu().numpy()
            assert np.array_equal(np.asarray(out[rid].tokens), want), \
                f"replayed request {rid} lost oracle exactness"
            exact += 1
    done = sum(out[r].state is RequestState.DONE for r in rids)
    assert done == len(rids), "with budget left, every request must finish"
    events.append(
        f"serve: crash recovered done={done} "
        f"replayed={metrics.counters['requests_replayed']} "
        f"retry_exhausted={metrics.counters['retry_exhausted']} "
        f"lost={len(lost)} oracle_exact={exact}")

    # ---- crash storm: budget exhaustion is accounted, never silent ------
    metrics2 = ServingMetrics()
    engine2 = ContinuousBatchingEngine(cfg, params, n_slots=2, device=dev)
    gateway2 = ServingGateway(engine2, metrics=metrics2,
                              replay=ReplayPolicy(max_replays=1,
                                                  backoff_base_s=0.0))
    rids2 = [gateway2.submit(p, 6) for p in prompts[:2]]
    storm = chaos.engine_crash_mid_decode(at_steps=(1, 2, 3, 4), seed=seed)
    inj2 = storm.injector()
    with inj2:
        out2 = gateway2.run()
    events.extend(inj2.events)
    exhausted = sum(out2[r].state is RequestState.RETRY_EXHAUSTED
                    for r in rids2)
    assert len(out2) == len(rids2), "crash storm silently lost requests"
    events.append(f"serve: crash storm accounted retry_exhausted={exhausted} "
                  f"lost=0")
    return events, {
        "done": done,
        "replayed": int(metrics.counters["requests_replayed"]),
        "retry_exhausted_storm": exhausted,
    }


# --------------------------------------------------------------- train stage
def _least_squares(device: torch.device):
    """The reference's toy train: a 4 x 2 least-squares weight stepped by
    gradient descent on seeded (8 x 4, 8 x 2) batches."""

    def step_fn(state, batch):
        x, y = batch
        w = state["w"].detach().requires_grad_()
        loss = torch.mean((x @ w - y) ** 2)
        (grad,) = torch.autograd.grad(loss, w)
        return ({"w": state["w"] - 0.1 * grad,
                 "step": state["step"] + 1}, {"loss": loss.detach()})

    def init_state():
        return {"w": torch.zeros(4, 2, device=device),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    return step_fn, init_state


def run_train_stage(seed: int, device: str | torch.device = "cuda"
                    ) -> Tuple[List[str], Dict]:
    from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
    from tpu_on_k8s_torch.train.loop import TrainLoop

    dev = resolve_device(device)
    events: List[str] = []
    step_fn, init_state = _least_squares(dev)

    def batches_from(start: int):
        i = start
        while True:
            brng = np.random.default_rng((seed, i))
            yield tuple(torch.from_numpy(brng.normal(size=shape).astype(
                np.float32)).to(dev) for shape in ((8, 4), (8, 2)))
            i += 1

    steps, preempt_at, ckpt_every = 14, 9, 3
    baseline = TrainLoop(step_fn, init_state(), batches_from(1),
                         log_every=1).run(steps)
    base_losses = {s: float(h["loss"]) for s, h in baseline.history}

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        scenario = chaos.train_preemption(preempt_at, fail_save=True,
                                          seed=seed)
        inj = scenario.injector()
        loop = TrainLoop(step_fn, init_state(), batches_from(1), log_every=1,
                         checkpoint_manager=mgr, checkpoint_every=ckpt_every)
        with inj:
            first = loop.run(steps)
        events.extend(inj.events)
        assert first.preempted and first.steps == preempt_at - 1
        assert first.checkpoint_failures == 1, \
            "the injected save failure must be recorded, not fatal"

        # resume: the preemption save failed, so the newest surviving
        # checkpoint is the last PERIODIC one: the fallback under test
        restored, gen, step = mgr.restore(init_state())
        expect_step = ((preempt_at - 1) // ckpt_every) * ckpt_every
        assert step == expect_step, (step, expect_step)
        resumed = TrainLoop(step_fn, restored, batches_from(step + 1),
                            log_every=1, checkpoint_manager=mgr,
                            checkpoint_every=ckpt_every).run(steps - step)
        mgr.close()

    stitched = {s: float(h["loss"]) for s, h in first.history}
    stitched.update({s + step: float(h["loss"]) for s, h in resumed.history})
    mismatch = [s for s in range(1, steps + 1)
                if stitched.get(s) != base_losses[s]]
    assert not mismatch, f"loss trajectory diverged at steps {mismatch}"
    crc = zlib.crc32(np.asarray(
        [base_losses[s] for s in range(1, steps + 1)],
        np.float32).tobytes())
    events.append(f"train: preempt@{preempt_at} resumed@{step} "
                  f"bit_exact_steps={steps} losses_crc={crc:08x}")
    return events, {"resumed_from": step, "steps": steps,
                    "losses_crc": f"{crc:08x}"}


# --------------------------------------------------------------------- main
def run_all(seed: int, skip_operator: bool = False,
            device: str | torch.device = "cuda", cfg=None,
            params: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
    """The three stages; ``cfg`` and ``params`` replace the serve stage's
    default model."""
    dev = resolve_device(device)
    events: List[str] = []
    summary: Dict = {"seed": seed}
    if not skip_operator:
        ev, s = run_operator_stage(seed)
        events.extend(ev)
        summary["operator"] = s
    ev, s = run_serve_stage(seed, cfg, params, dev)
    events.extend(ev)
    summary["serve"] = s
    ev, s = run_train_stage(seed, dev)
    events.extend(ev)
    summary["train"] = s
    summary["events"] = events
    summary["events_crc"] = f"{zlib.crc32(chr(10).join(events).encode()):08x}"
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="chaos recovery soak")
    p.add_argument("--seed", type=int, default=DEFAULT_SEED)
    p.add_argument("--repeat", type=int, default=2,
                   help="run the scenario this many times and assert "
                        "identical event logs (default 2)")
    p.add_argument("--skip-operator", action="store_true",
                   help="skip the REST operator stage (serve+train only)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    args = p.parse_args(argv)
    try:
        runs = [run_all(args.seed, skip_operator=args.skip_operator,
                        device=args.device)
                for _ in range(max(args.repeat, 1))]
        for later in runs[1:]:
            assert later["events"] == runs[0]["events"], (
                "event logs diverged across repeats:\n"
                f"run 1: {runs[0]['events']}\nrun n: {later['events']}")
        out = dict(runs[0])
        out["repeats"] = len(runs)
        out["identical_logs"] = len(runs) > 1
        print(json.dumps(out, indent=2))
        return 0
    except Exception as e:  # noqa: BLE001 — the seed line is the contract
        print(f"CHAOS_SOAK_FAILED seed={args.seed}: {type(e).__name__}: {e}",
              file=sys.stderr)
        raise


if __name__ == "__main__":
    sys.exit(main())
