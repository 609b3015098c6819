"""Driver-target benchmarks (the counterpart of the reference's
``tools/driver_bench.py``): the two metrics ``BASELINE.json`` names, and the
serving paths beside them.

1. **ResNet-50 images/sec/card**: the compute-plane number
   (``models/vision.py`` ResNet-50, bf16 images 224x224x3, real train steps
   through ``train/vision.ClassifierTrainer`` with SGD momentum 0.9 on one
   card).
2. **job-submit→first-step p50**: the orchestration-plane number: N sample
   jobs (a ``TorchJob``: ``MNIST_CNN_SAMPLE``) submitted through the port's
   full operator (``main.Operator``, ``--cluster-backend rest``) over an
   ``ApiServer``, with informers, reconcilers and a ``KubeletLoop`` on
   separate connections; the p50 of ``first_pod_launch_delay_seconds``.

The serving benches run the flagship (``serve_load.bench_config()``, ~350M
parameters, bf16 weights from torch seed 0, greedy): ``bench_decode``
(``models/decode.generate``, optionally the int8 KV cache or W8A16
weights), ``bench_continuous`` (``ContinuousBatchingEngine`` behind a
``ServingGateway``) and ``bench_speculative`` (``speculative_generate``
with the self-draft or a layer-truncated draft).

    python -m tpu_on_k8s_torch.driver_bench [--write] [--skip-resnet]
        [--skip-submit] [--skip-decode] [--continuous [--horizon N]]
        [--speculative [--draft-layers N]] [--cache-int8] [--serve-int8]
        [--device D]

``--write`` merges the records into ``BASELINE_torch.json``'s "published"
at the repository's root (git ignores it); without it the records are only
printed. The default device is ``cuda``, which raises without a card.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tpu_on_k8s_torch.device import resolve_device

OUT = Path(__file__).resolve().parents[1] / "BASELINE_torch.json"

#: The reference's ``config/samples/mnist_cnn.yaml`` in the GPU flavour:
#: BASELINE config 1, a one-master ``TorchJob`` on one H100.
MNIST_CNN_SAMPLE = {
    "api_version": "distributed.torch.io/v1alpha1",
    "kind": "TorchJob",
    "metadata": {"name": "mnist-cnn", "namespace": "default"},
    "spec": {
        "tasks": {
            "Master": {
                "num_tasks": 1,
                "template": {"spec": {"containers": [{
                    "name": "torch",
                    "image": "tpu-on-k8s/examples:latest",
                    "command": ["python", "-m",
                                "tpu_on_k8s_torch.train_mnist"]}]}}}},
        "run_policy": {"clean_pod_policy": "Running", "backoff_limit": 3},
        "gpu_policy": {"accelerator": "nvidia-h100-80gb", "topology": "1x1"},
    },
}


def _kind(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flagship(device: torch.device, cache_int8: bool = False):
    """The flagship's config and bf16 serving weights (torch seed 0)."""
    from tpu_on_k8s_torch.models.params import init_params
    from tpu_on_k8s_torch.serve_load import bench_config

    cfg = bench_config()
    if cache_int8:
        cfg = dataclasses.replace(cfg, cache_int8=True)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device, dtype=torch.bfloat16)
    return cfg, params


def _prompt(batch: int, prompt_len: int, vocab: int,
            device: torch.device) -> torch.Tensor:
    return torch.randint(0, vocab, (batch, prompt_len), dtype=torch.int32,
                         generator=torch.Generator(device=device)
                         .manual_seed(1), device=device)


def bench_resnet50(batch: int = 256, steps: int = 20,
                   device: str | torch.device = "cuda") -> dict:
    from tpu_on_k8s_torch.models.vision import ResNet, ResNetConfig
    from tpu_on_k8s_torch.train.optimizer import SGD
    from tpu_on_k8s_torch.train.vision import ClassifierTrainer

    dev = resolve_device(device)
    with torch.device(dev):
        model = ResNet(ResNetConfig.resnet50())
    trainer = ClassifierTrainer(model, SGD(model.parameters(), 0.1,
                                           momentum=0.9))
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(2))
    images = torch.randn(batch, 224, 224, 3, device=dev,
                         generator=torch.Generator(device=dev)
                         .manual_seed(0)).to(torch.bfloat16)
    labels = torch.randint(0, 1000, (batch,), device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    for _ in range(3):
        state, metrics = trainer.train_step(state, images, labels)
    float(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = trainer.train_step(state, images, labels)
    float(metrics["loss"])
    _sync(dev)
    dt = time.perf_counter() - t0
    img_s = steps * batch / dt
    return {
        "metric": "resnet50_train_images_per_sec_per_chip",
        "value": round(img_s, 1),
        "unit": "images/s/chip",
        "batch": batch,
        "device_kind": _kind(dev),
    }


def bench_decode(batch: int = 8, prompt_len: int = 128,
                 new_tokens: int = 128, cache_int8: bool = False,
                 serve_int8: bool = False,
                 device: str | torch.device = "cuda") -> dict:
    """Serving-path throughput: KV-cache ``generate()`` on the flagship,
    greedy, bf16 weights, one card. Tokens/s counts generated tokens only
    (the prefill is timed apart, as ``prefill_ms``); ``cache_int8`` stores
    the cache int8 with per-(token, head) fp32 scales, ``serve_int8``
    serves W8A16 weights (deterministic absmax rounding,
    ``decode.quantize_weights_for_serving``)."""
    from tpu_on_k8s_torch.models.decode import (
        generate,
        quantize_weights_for_serving,
    )

    dev = resolve_device(device)
    cfg, params = _flagship(dev, cache_int8)
    prompt = _prompt(batch, prompt_len, cfg.vocab_size, dev)
    if serve_int8:
        cfg = dataclasses.replace(cfg, serve_int8_weights=True)
        params = quantize_weights_for_serving(params)

    def gen(n):
        return generate(cfg, params, prompt, n, device=dev)

    out = gen(new_tokens)            # warm-up: the kernels build here
    int(out[0, 0])
    one = gen(1)                     # prefill-only timing via 1-token runs
    int(one[0, 0])
    t0 = time.perf_counter()
    one = gen(1)
    int(one[0, 0])
    prefill_s = time.perf_counter() - t0

    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = gen(new_tokens)
    int(out[0, 0])
    dt = time.perf_counter() - t0
    tok_s = reps * batch * new_tokens / dt
    return {
        "metric": "decode_tokens_per_sec",
        "value": round(tok_s, 1),
        "unit": "tokens/s",
        "batch": batch,
        "prompt_len": prompt_len,
        "new_tokens": new_tokens,
        "prefill_ms": round(prefill_s * 1e3, 1),
        "cache": ("int8 + per-(token, head) fp32 scales" if cache_int8
                  else "bf16"),
        "weights": ("int8 W8A16 + per-out-channel fp32 scales" if serve_int8
                    else "bf16"),
        "model": "350M flagship (serve_load.bench_config), greedy",
        "device_kind": _kind(dev),
    }


def bench_continuous(n_slots: int = 8, n_requests: int = 32,
                     new_tokens: int = 128, cache_int8: bool = False,
                     step_horizon: int = 1, serve_int8: bool = False,
                     device: str | torch.device = "cuda") -> dict:
    """Continuous-batching serving throughput on the flagship through the
    front door (``serve/gateway.py`` over ``models/serving.py``): ragged
    prompts (64-256 tokens) streaming through a fixed slot pool, greedy,
    bf16 weights. The gateway's bound sits above the request count, so
    nothing is rejected; TTFT and queue wait are the gateway's. Each
    ``step_horizon`` decode steps pay a host round trip, the price of
    admitting and retiring requests mid-flight."""
    from tpu_on_k8s_torch.metrics import ServingMetrics
    from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
    from tpu_on_k8s_torch.serve import AdmissionConfig, ServingGateway

    dev = resolve_device(device)
    cfg, params = _flagship(dev, cache_int8)
    rng = np.random.default_rng(0)
    metrics = ServingMetrics()
    eng = ContinuousBatchingEngine(cfg, params, n_slots=n_slots,
                                   max_len=512, step_horizon=step_horizon,
                                   int8_weights=serve_int8, device=dev)
    gw = ServingGateway(
        eng, AdmissionConfig(max_queue_depth=max(64, 2 * n_requests)),
        metrics=metrics)
    # warm-up: the step, the admission and the prefill at every (bucket,
    # batch) shape the traffic below can hit (7 same-bucket submissions
    # admit as groups of 4, 2 and 1), so no first-use cost lands in the
    # timed region
    for lp in (100, 200):
        for _ in range(7):
            gw.submit(rng.integers(0, cfg.vocab_size,
                                   size=lp).astype(np.int32), 4)
        gw.run()
    # the published numbers cover the timed region only
    for key in eng.stats:
        eng.stats[key] = 0
    metrics.histograms.clear()

    lengths = rng.integers(64, 257, size=n_requests)
    t0 = time.perf_counter()
    for lp in lengths:
        gw.submit(rng.integers(0, cfg.vocab_size,
                               size=int(lp)).astype(np.int32), new_tokens)
    out = gw.run()
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in out.values())
    served = sum(r.ok for r in out.values())

    def p50(name):
        vals = list(metrics.histograms[name])
        return round(statistics.median(vals) * 1e3, 1) if vals else None

    def p95(name):
        # 20 or more keep the exclusive quantiles inside the sample
        vals = list(metrics.histograms[name])
        return (round(statistics.quantiles(vals, n=20)[-1] * 1e3, 1)
                if len(vals) >= 20 else None)

    def p99(name):
        # empirical nearest rank (the maximum of a small sample)
        vals = sorted(metrics.histograms[name])
        if not vals:
            return None
        idx = min(len(vals) - 1, max(0, -(-99 * len(vals) // 100) - 1))
        return round(vals[idx] * 1e3, 1)

    return {
        "metric": "continuous_batching_tokens_per_sec",
        "value": round(total / dt, 1),
        "unit": "tokens/s",
        "gateway": "tpu_on_k8s_torch.serve.ServingGateway",
        "served": served,
        "ttft_ms_p50": p50("time_to_first_token_seconds"),
        "ttft_ms_p95": p95("time_to_first_token_seconds"),
        "ttft_ms_p99": p99("time_to_first_token_seconds"),
        "queue_wait_ms_p50": p50("queue_wait_seconds"),
        "tpot_ms_p50": p50("time_per_output_token_seconds"),
        "latency_ms_p50": p50("request_latency_seconds"),
        "latency_ms_p95": p95("request_latency_seconds"),
        "n_slots": n_slots,
        "n_requests": n_requests,
        "prompt_lens": "uniform[64,256]",
        "new_tokens": new_tokens,
        "step_horizon": step_horizon,
        "decode_steps": eng.stats["steps"],
        # prefill emits each request's first token outside the step loop,
        # so utilization counts only step-emitted tokens
        "slot_utilization": round((total - n_requests)
                                  / (eng.stats["steps"] * n_slots), 3)
                            if eng.stats["steps"] else None,
        "cache": ("int8 + per-(token, head) fp32 scales" if cache_int8
                  else "bf16"),
        "weights": ("int8 W8A16 + per-out-channel fp32 scales" if serve_int8
                    else "bf16"),
        "model": "350M flagship (serve_load.bench_config), greedy",
        "device_kind": _kind(dev),
    }


def bench_speculative(prompt_len: int = 128, new_tokens: int = 123,
                      k: int = 4, serve_int8: bool = False,
                      draft_layers: int = 0,
                      device: str | torch.device = "cuda") -> dict:
    """Speculative decoding's mechanism bound at batch 1. The default draft
    is the target itself (every proposal accepted: k+1 tokens a target
    forward, the bound a trained draft approaches); ``draft_layers > 0``
    drafts with the target's first N layers (``decode.truncated_draft``),
    whose acceptance is measured. ``serve_int8`` serves the target as
    W8A16 weights (the draft stays bf16). Compared with plain
    ``generate()`` on the same target; ``new_tokens`` 123 makes both paths
    bucket their cache to 256."""
    from tpu_on_k8s_torch.models.decode import (
        generate,
        quantize_weights_for_serving,
        speculative_generate,
        truncated_draft,
    )

    dev = resolve_device(device)
    cfg, params = _flagship(dev)
    prompt = _prompt(1, prompt_len, cfg.vocab_size, dev)
    if draft_layers:
        draft_cfg, draft_params = truncated_draft(cfg, params, draft_layers)
    else:
        draft_cfg, draft_params = cfg, params   # self-draft upper bound
    if serve_int8:
        cfg = dataclasses.replace(cfg, serve_int8_weights=True)
        params = quantize_weights_for_serving(params)

    def plain():
        return generate(cfg, params, prompt, new_tokens, device=dev)

    def spec():
        return speculative_generate(cfg, params, draft_cfg, draft_params,
                                    prompt, new_tokens, k=k, device=dev)

    out = plain()                    # warm-up of both paths
    int(out[0, 0])
    toks, _ = spec()
    int(toks[0, 0])

    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        out = plain()
    int(out[0, 0])
    base_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(reps):
        toks, stats = spec()
    int(toks[0, 0])
    spec_s = time.perf_counter() - t0
    if draft_layers:
        draft_desc = f"target[:{draft_layers}] layers"
    elif serve_int8:
        draft_desc = "self bf16 vs int8 target (acceptance measured)"
    else:
        draft_desc = "self (acceptance=1 upper bound)"
    return {
        "metric": "speculative_tokens_per_sec",
        "value": round(reps * new_tokens / spec_s, 1),
        "unit": "tokens/s",
        "baseline_generate_tokens_per_sec": round(
            reps * new_tokens / base_s, 1),
        "ratio_vs_generate": round(base_s / spec_s, 3),
        "k": k,
        "draft": draft_desc,
        "acceptance_rate": round(stats["acceptance_rate"], 4),
        "tokens_per_target_forward": round(
            stats["tokens_per_target_forward"], 2),
        "weights": ("int8 W8A16 + per-out-channel fp32 scales"
                    if serve_int8 else "bf16"),
        "note": ("real-draft acceptance measured on a layer-truncated "
                 "draft" if draft_layers else
                 "bf16 self-draft against the int8 target: rejections "
                 "are pure quantization disagreement" if serve_int8 else
                 "self-draft upper bound: a REAL draft adds its own "
                 "forwards but shrinks the target count toward this"),
        "device_kind": _kind(dev),
    }


def bench_submit_to_first_step(n_jobs: int = 20) -> dict:
    from tpu_on_k8s_torch.api.types import TorchJob
    from tpu_on_k8s_torch.client import KubeletLoop
    from tpu_on_k8s_torch.client.apiserver import ApiServer
    from tpu_on_k8s_torch.client.rest import RestCluster
    from tpu_on_k8s_torch.controller.torchjob import submit_job
    from tpu_on_k8s_torch.main import Operator, build_parser
    from tpu_on_k8s_torch.utils import serde

    srv = ApiServer().start()
    args = build_parser().parse_args(["--cluster-backend", "rest",
                                      "--api-server", srv.url,
                                      "--no-leader-elect"])
    op = Operator(args, cluster=RestCluster(srv.url))
    op.start()
    kubelet_client = RestCluster(srv.url)
    # run every pending pod as soon as it appears (an idle cluster: the
    # delay measured is the controllers' latency alone)
    kubelet = KubeletLoop(kubelet_client).start()
    user = RestCluster(srv.url)
    try:
        for i in range(n_jobs):
            job = serde.from_dict(TorchJob, copy.deepcopy(MNIST_CNN_SAMPLE))
            job.metadata.name = f"bench-job-{i}"
            submit_job(user, job)
            deadline = time.time() + 30
            while time.time() < deadline:
                j = user.try_get(TorchJob, job.metadata.namespace or "default",
                                 job.metadata.name)
                if j and any(c.type == "Running" for c in j.status.conditions):
                    break
                time.sleep(0.01)
        deadline = time.time() + 10
        while time.time() < deadline:
            delays = op.metrics.histograms.get(
                "first_pod_launch_delay_seconds", [])
            if len(delays) >= n_jobs:
                break
            time.sleep(0.1)
        delays = list(op.metrics.histograms.get(
            "first_pod_launch_delay_seconds", []))
    finally:
        kubelet.stop()
        op.stop()
        user.close()
        kubelet_client.close()
        srv.stop()
    if not delays:
        raise RuntimeError("no launch delays observed")
    return {
        "metric": "job_submit_to_first_pod_ready_p50_seconds",
        "value": round(statistics.median(delays), 3),
        "unit": "s",
        "p90": round(statistics.quantiles(delays, n=10)[-1], 3)
                if len(delays) >= 10 else None,
        "samples": len(delays),
        "backend": "rest (apiserver + informers + kubelet sim)",
    }


def build_parser() -> argparse.ArgumentParser:
    """The reference's flags, and ``--device``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--write", action="store_true",
                        help="update BASELINE_torch.json 'published' in "
                             "place")
    parser.add_argument("--skip-resnet", action="store_true")
    parser.add_argument("--skip-submit", action="store_true")
    parser.add_argument("--skip-decode", action="store_true")
    parser.add_argument("--cache-int8", action="store_true",
                        help="decode with the int8 KV cache (recorded under "
                             "decode_tokens_per_sec_cache_int8)")
    parser.add_argument("--serve-int8", action="store_true",
                        help="decode with W8A16 int8 weights (recorded "
                             "under decode_tokens_per_sec_w8a16)")
    parser.add_argument("--speculative", action="store_true",
                        help="measure the speculative-decoding mechanism "
                             "(self-draft acceptance=1 upper bound by "
                             "default; see --draft-layers); combines with "
                             "--serve-int8")
    parser.add_argument("--draft-layers", type=int, default=0,
                        help="with --speculative: draft with the target's "
                             "first N layers instead of the self-draft")
    parser.add_argument("--continuous", action="store_true",
                        help="measure continuous-batching serving "
                             "throughput (mixed ragged traffic through the "
                             "slot pool) instead of the static decode batch")
    parser.add_argument("--horizon", type=int, default=1,
                        help="continuous engine step horizon: decode steps "
                             "a host round trip")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; raises without a card) or "
                             "'cpu'")
    return parser


def main(argv=None, out: Path = OUT) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.horizon > 1 and not args.continuous:
        parser.error("--horizon only applies to --continuous (the static "
                     "decode bench has no step horizon)")
    if args.speculative and (args.cache_int8 or args.continuous):
        parser.error("--speculative does not combine with --cache-int8 "
                     "or --continuous (the engine path is measured by "
                     "serve_load --spec)")
    if args.draft_layers and not args.speculative:
        parser.error("--draft-layers only applies to --speculative")
    dev = resolve_device(args.device)

    published = {}
    if not args.skip_submit:
        published["job_submit_to_first_pod_ready_p50"] = \
            bench_submit_to_first_step()
        print(json.dumps(published["job_submit_to_first_pod_ready_p50"]))
    if not args.skip_resnet:
        published["resnet50_images_per_sec_per_chip"] = bench_resnet50(
            device=dev)
        print(json.dumps(published["resnet50_images_per_sec_per_chip"]))
    if not args.skip_decode:
        if args.speculative:
            key = ("speculative_selfdraft_tokens_per_sec"
                   if not args.draft_layers else
                   f"speculative_draft{args.draft_layers}l_tokens_per_sec")
            if args.serve_int8:
                key += "_w8a16"
            published[key] = bench_speculative(
                serve_int8=args.serve_int8,
                draft_layers=args.draft_layers, device=dev)
        elif args.continuous:
            key = "continuous_batching_tokens_per_sec"
            if args.cache_int8:
                key += "_cache_int8"
            if args.serve_int8:
                key += "_w8a16"
            if args.horizon > 1:
                key += f"_h{args.horizon}"
            published[key] = bench_continuous(cache_int8=args.cache_int8,
                                              step_horizon=args.horizon,
                                              serve_int8=args.serve_int8,
                                              device=dev)
        else:
            key = "decode_tokens_per_sec"
            if args.cache_int8:
                key += "_cache_int8"
            if args.serve_int8:
                key += "_w8a16"
            published[key] = bench_decode(cache_int8=args.cache_int8,
                                          serve_int8=args.serve_int8,
                                          device=dev)
        print(json.dumps(published[key]))

    if args.write:
        path = Path(out)
        baseline = json.loads(path.read_text()) if path.exists() else {}
        baseline.setdefault("published", {}).update(published)
        path.write_text(json.dumps(baseline, indent=2) + "\n")
        print(f"wrote {path} published: {sorted(baseline['published'])}")
    return published


if __name__ == "__main__":
    sys.exit(main() and 0)
