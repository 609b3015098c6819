"""Continuous-batching serving on the card (the port's production serving
entry point).

Counterpart of ``examples/serve.py``: the parameters of a checkpoint
(``--checkpoint-dir``, as ``train_llama --checkpoint-dir`` writes it), of
a local Hugging Face checkpoint directory of the Llama or GPT-2 family
(``--hf-model``, bf16 weights through ``models/convert.py``; it overrides
``--config`` and ``--checkpoint-dir`` and needs ``transformers``, imported
only for it) or
random weights from ``--seed``, synthetic ragged traffic (seeded prompts arriving
at ``--arrival`` requests per engine step on average) and
``models.serving.ContinuousBatchingEngine``; a real frontend would call
``engine.submit()`` from its request handler and ``engine.step()`` on a
loop, as this file does::

    python -m tpu_on_k8s_torch.serve --config llama2_7b --n-slots 8 \\
        --max-len 2048 --prompt-min 64 --prompt-max 1000 --max-new-tokens 64
    python -m tpu_on_k8s_torch.serve --config tiny --device cpu
    python -m tpu_on_k8s_torch.serve --config tiny --device cpu --spec \\
        --spec-draft-layers 1
    python -m tpu_on_k8s_torch.serve --hf-model ./gpt2 --device cpu
    python -m tpu_on_k8s_torch.serve --config tiny --device cpu --gateway
    python -m tpu_on_k8s_torch.serve --config tiny --device cpu \\
        --replicas 2 --rollout-demo

The engine reports through a ``ServingMetrics``; ``--metrics-port`` serves
it at ``/metrics`` (without ``prometheus_client``, from a stdlib HTTP
thread). The closing line reports the p50 latency and time to first token
from its histograms, on the engine's clock. ``--spec`` decodes
speculatively (greedy; ``--spec-k`` proposals a round) with the target's
first ``--spec-draft-layers`` layers as the draft, or the target itself
(0, the acceptance-1 upper bound), and the closing line adds the rounds
and the acceptance.

``--gateway`` serves the same traffic through ``serve.ServingGateway``:
bounded admission (``--queue-bound``; overflow prints as a typed
rejection), smooth-WRR fairness over ``--tenants`` synthetic tenants,
optional per-request deadlines (``--deadline-s``) and a graceful drain at
the end. ``--replicas N`` serves a routed ``serve.ServingFleet`` of N
engines (prefix affinity over ``--prefix-bucket``-token heads of three
repeated system prompts, least-outstanding-tokens balance, slow-start
readiness); with ``--rollout-demo`` it rolls the fleet to a second random
parameter set after half the trace, under load, and prints the phases.
Every engine is on ``--device``.

``--model-axis N`` / ``--fsdp N`` serve the engine tensor-parallel on a
mesh of the job's ranks (``data`` 1, ``fsdp`` the given count or the ranks
left over, ``model`` N) under the flagship rules, as the reference does.
The world is the launcher's (``train/distributed.initialize``: torchrun's
variables or the operator's), else this process alone::

    torchrun --nproc-per-node 2 -m tpu_on_k8s_torch.serve --config tiny \
        --device cpu --model-axis 2

Rank 0 is the driver (it serves and prints); every other rank runs
``parallel/serving.serve_mesh_worker`` and returns when the driver is
done. ``--replicas`` serves meshless replicas and refuses the mesh flags.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch.device import resolve_device
from tpu_on_k8s_torch.generate import CONFIGS, load_hf
from tpu_on_k8s_torch.metrics import ServingMetrics, SpecMetrics
from tpu_on_k8s_torch.metrics import serve as serve_metrics
from tpu_on_k8s_torch.models.decode import truncated_draft
from tpu_on_k8s_torch.models.params import init_params
from tpu_on_k8s_torch.models.serving import ContinuousBatchingEngine
from tpu_on_k8s_torch.models.transformer import flagship_partition_rules
from tpu_on_k8s_torch.parallel.mesh import MeshConfig, create_mesh, mesh_shape
from tpu_on_k8s_torch.parallel.serving import (
    serve_mesh_worker,
    shutdown_mesh_workers,
)
from tpu_on_k8s_torch.serve.admission import AdmissionConfig, Rejected
from tpu_on_k8s_torch.serve.fleet import (
    FleetRolloutPolicy,
    RolloutPhase,
    ServingFleet,
)
from tpu_on_k8s_torch.serve.gateway import ServingGateway
from tpu_on_k8s_torch.serve.health import ProbeConfig
from tpu_on_k8s_torch.serve.lifecycle import RequestState
from tpu_on_k8s_torch.serve.router import Router
from tpu_on_k8s_torch.train.checkpoint import load_params
from tpu_on_k8s_torch.train.distributed import initialize, local_world


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="continuous-batching server")
    p.add_argument("--config", default="tiny", choices=sorted(CONFIGS))
    p.add_argument("--n-slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=0,
                   help="engine cache length (0 = the model's max_seq_len)")
    p.add_argument("--horizon", type=int, default=1,
                   help="decode steps per host round trip")
    p.add_argument("--prefill-chunk", type=int, default=0,
                   help=">0: prompts longer than this prefill one chunk "
                        "per step (decode keeps flowing for other slots)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0,
                   help="sample only the k highest-probability tokens")
    p.add_argument("--top-p", type=float, default=0.0,
                   help="nucleus sampling: smallest token set with mass p")
    p.add_argument("--n-requests", type=int, default=16)
    p.add_argument("--arrival", type=float, default=1.0,
                   help="mean requests arriving per engine step")
    p.add_argument("--prompt-min", type=int, default=4)
    p.add_argument("--prompt-max", type=int, default=24)
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--system-prompt-len", type=int, default=0,
                   help=">0 registers a shared prefix of this length once "
                        "(prefix caching); every request then prefills "
                        "only its own suffix")
    p.add_argument("--kv-pages", type=int, default=0,
                   help=">0: a paged KV pool of this many pages")
    p.add_argument("--spec", action="store_true",
                   help="speculative decoding (greedy): a draft proposes, "
                        "one batched forward verifies")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft proposals per speculative round (--spec)")
    p.add_argument("--spec-draft-layers", type=int, default=0,
                   help="draft with the target's first N layers (--spec); "
                        "0 drafts with the target itself")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--checkpoint-dir", default="",
                   help="restore the model's parameters from here (the "
                        "newest generation and step)")
    p.add_argument("--hf-model", default="",
                   help="local HF checkpoint dir (Llama or GPT-2 family), "
                        "served with bf16 weights; overrides --config and "
                        "--checkpoint-dir")
    p.add_argument("--model-axis", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=0)
    p.add_argument("--metrics-port", type=int, default=0)
    p.add_argument("--gateway", action="store_true",
                   help="serve through serve.ServingGateway: bounded "
                        "admission, tenant fairness, deadlines")
    p.add_argument("--replicas", type=int, default=0,
                   help=">0: serve a routed fleet of this many replicas "
                        "(serve.ServingFleet): prefix-affinity + "
                        "least-outstanding-tokens routing, slow-start "
                        "readiness, crash ejection with replay")
    p.add_argument("--prefix-bucket", type=int, default=16,
                   help="router prefix-affinity bucket length "
                        "(with --replicas)")
    p.add_argument("--rollout-demo", action="store_true",
                   help="with --replicas: after half the trace, roll the "
                        "fleet to a v2 parameter set under load and "
                        "report the phases")
    p.add_argument("--queue-bound", type=int, default=16,
                   help="admission queue bound (with --gateway or "
                        "--replicas)")
    p.add_argument("--tenants", type=int, default=3,
                   help="synthetic tenants to spread traffic across "
                        "(with --gateway)")
    p.add_argument("--deadline-s", type=float, default=0.0,
                   help=">0: per-request deadline in seconds "
                        "(with --gateway)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.model_axis > 1 or args.fsdp > 1:
        if args.replicas > 0:
            raise ValueError("--replicas serves meshless replicas; "
                             "--model-axis / --fsdp serve one engine on a "
                             "mesh")
        return _on_mesh(args, dev)
    return _serve(args, dev)


def _on_mesh(args, dev) -> dict:
    """Serve on a mesh of the job's ranks: rank 0 drives, the others run
    their mesh workers. A world this call made is destroyed before it
    returns."""
    made = not dist.is_initialized()
    initialize(device=dev)
    if not dist.is_initialized():
        local_world(dev)
    try:
        mesh = create_mesh(MeshConfig(data=1, fsdp=args.fsdp or -1,
                                      model=args.model_axis, seq=1),
                           device=dev)
        if dist.get_rank() != 0:
            serve_mesh_worker(mesh)
            return {}
        print(f"serving tensor-parallel over mesh {mesh_shape(mesh)}")
        try:
            return _serve(args, dev, mesh)
        finally:
            shutdown_mesh_workers()
    finally:
        if made:
            dist.destroy_process_group()


def _serve(args, dev, mesh=None) -> dict:
    cfg = CONFIGS[args.config]()
    if args.hf_model:
        cfg, params = load_hf(args.hf_model, dev)
    elif args.checkpoint_dir:
        params, ck_gen, ck_step = load_params(args.checkpoint_dir, dev,
                                              cfg.dtype)
        print(f"restored generation={ck_gen} step={ck_step}")
    else:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            args.seed), dev)
    if args.replicas > 0:
        return _fleet_loop(args, cfg, params, dev)
    metrics = ServingMetrics()
    spec_metrics = SpecMetrics() if args.spec else None
    draft_cfg = draft_params = None
    if args.spec:
        draft_cfg, draft_params = (
            truncated_draft(cfg, params, args.spec_draft_layers)
            if args.spec_draft_layers > 0 else (cfg, params))
    if args.metrics_port:
        serve_metrics(metrics, args.metrics_port)
        print(f"metrics at :{args.metrics_port}/metrics")
    eng = ContinuousBatchingEngine(
        cfg, params, n_slots=args.n_slots, max_len=args.max_len or None,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        prefill_chunk=args.prefill_chunk, step_horizon=args.horizon,
        kv_pages=args.kv_pages,
        metrics=None if args.gateway else metrics, draft_cfg=draft_cfg,
        draft_params=draft_params, spec_k=args.spec_k,
        spec_metrics=spec_metrics,
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        mesh=mesh, rules=None if mesh is None else flagship_partition_rules(),
        device=dev)

    worst = (args.system_prompt_len + args.prompt_max
             + args.max_new_tokens)
    if worst > eng.max_len:
        raise SystemExit(
            f"system prompt {args.system_prompt_len} + prompt-max "
            f"{args.prompt_max} + max-new-tokens {args.max_new_tokens} = "
            f"{worst} exceeds the engine's max_len {eng.max_len}")
    rng = np.random.default_rng(args.seed)
    prefix_id = None
    if args.system_prompt_len:
        prefix_id = eng.register_prefix(rng.integers(
            0, cfg.vocab_size, size=args.system_prompt_len).astype(np.int32))
        print(f"registered a {args.system_prompt_len}-token shared prefix "
              f"(id {prefix_id})")
    if args.gateway:
        return _gateway_loop(args, cfg, eng, metrics, rng, prefix_id)

    submitted = 0
    finished = {}
    t0 = time.perf_counter()
    # the serving loop a frontend would run: submit arrivals, step, collect
    while submitted < args.n_requests or len(finished) < submitted:
        if submitted < args.n_requests:
            for _ in range(rng.poisson(args.arrival)):
                if submitted >= args.n_requests:
                    break
                lp = int(rng.integers(args.prompt_min, args.prompt_max + 1))
                prompt = rng.integers(0, cfg.vocab_size,
                                      size=lp).astype(np.int32)
                rid = eng.submit(prompt, args.max_new_tokens,
                                 prefix_id=prefix_id)
                submitted += 1
                print(f"→ r{rid} submitted (prompt {lp} tokens)")
        for rid in eng.step():
            finished[rid] = eng.result(rid)
            print(f"← r{rid} done: {finished[rid].tolist()}")
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in finished.values())
    line = (f"served {len(finished)} requests, {total} tokens in {dt:.2f}s "
            f"({total / dt:.1f} tok/s) — stats {eng.stats}")
    lat = metrics.histograms["request_latency_seconds"]
    ttft = metrics.histograms["time_to_first_token_seconds"]
    if lat and ttft:
        line += (f"; p50 latency {statistics.median(lat) * 1e3:.0f}ms, "
                 f"p50 TTFT {statistics.median(ttft) * 1e3:.0f}ms")
    if args.spec:
        st = eng.stats
        line += (f"; spec rounds {st['spec_rounds']}, acceptance "
                 f"{st['spec_accepted'] / max(st['spec_proposed'], 1):.3f} "
                 f"({st['spec_accepted']}/{st['spec_proposed']})")
    print(line)
    return finished


def _gateway_loop(args, cfg, eng, metrics, rng, prefix_id) -> dict:
    """The production shape: the same synthetic traffic through the
    gateway, with bounded admission (overflow prints as typed
    rejections), smooth-WRR fairness across synthetic tenants, optional
    per-request deadlines and a graceful drain at the end. Returns the
    tokens of the requests that finished DONE."""
    gw = ServingGateway(
        eng, AdmissionConfig(max_queue_depth=args.queue_bound),
        metrics=metrics)
    submitted = rejected = 0
    finished = {}
    t0 = time.perf_counter()
    while submitted < args.n_requests:
        for _ in range(rng.poisson(args.arrival)):
            if submitted >= args.n_requests:
                break
            lp = int(rng.integers(args.prompt_min, args.prompt_max + 1))
            prompt = rng.integers(0, cfg.vocab_size, size=lp).astype(np.int32)
            r = gw.submit(prompt, args.max_new_tokens,
                          tenant=f"tenant-{submitted % args.tenants}",
                          deadline_s=args.deadline_s or None,
                          prefix_id=prefix_id)
            submitted += 1
            if isinstance(r, Rejected):
                rejected += 1
                print(f"✗ rejected ({r.reason}): {r.detail}")
            else:
                print(f"→ r{r} submitted (prompt {lp} tokens)")
        for rid in gw.step():
            res = gw.result(rid)
            if res is not None:
                finished[rid] = res
                print(f"← r{rid} {res.state.value}: {res.tokens.tolist()}")
    for rid, res in gw.drain().items():
        finished[rid] = res
        print(f"← r{rid} {res.state.value}: {res.tokens.tolist()}")
    dt = time.perf_counter() - t0
    done = {rid: r.tokens for rid, r in finished.items() if r.ok}
    expired = sum(r.state is RequestState.DEADLINE_EXCEEDED
                  for r in finished.values())
    total = sum(len(v) for v in done.values())
    line = (f"served {len(done)}/{submitted} requests ({rejected} rejected, "
            f"{expired} expired), {total} tokens in {dt:.2f}s "
            f"({total / dt:.1f} tok/s) — stats {eng.stats}")
    ttft = metrics.histograms["time_to_first_token_seconds"]
    if ttft:
        line += f"; p50 TTFT {statistics.median(ttft) * 1e3:.0f}ms"
    print(line)
    return done


def _fleet_loop(args, cfg, params, dev) -> dict:
    """The fleet shape: ``--replicas`` engines behind the router. Traffic
    repeats three synthetic system prompts so prefix affinity has
    something to exploit; with ``--rollout-demo`` a second random
    parameter set rolls in under load. Returns the tokens of the
    requests that finished DONE."""
    def factory_for(tree):
        def make(name):
            return ContinuousBatchingEngine(
                cfg, tree, n_slots=args.n_slots,
                max_len=args.max_len or None, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p,
                step_horizon=args.horizon,
                generator=torch.Generator(device=dev).manual_seed(
                    args.seed + 1),
                device=dev)
        return make

    fleet = ServingFleet(
        factory_for(params), args.replicas,
        admission=AdmissionConfig(max_queue_depth=args.queue_bound),
        probe=ProbeConfig(slow_start_steps=2),
        router=Router(prefix_bucket_len=args.prefix_bucket))
    while not any(r.routable for r in fleet.replicas.values()):
        fleet.step()                       # slow start: earn readiness
    rng = np.random.default_rng(args.seed)
    shared = [rng.integers(0, cfg.vocab_size,
                           size=args.prefix_bucket).astype(np.int32)
              for _ in range(3)]           # repeated "system prompts"
    submitted = rejected = 0
    finished = {}
    rollout_started = False
    phases = []
    t0 = time.perf_counter()
    while submitted < args.n_requests or fleet.has_live_requests \
            or fleet.rollout_phase not in (RolloutPhase.IDLE,
                                           RolloutPhase.COMPLETE):
        if args.rollout_demo and not rollout_started \
                and submitted >= args.n_requests // 2:
            v2 = init_params(cfg, torch.Generator(device=dev).manual_seed(
                args.seed + 99), dev)
            fleet.start_rollout(factory_for(v2), "v2",
                                FleetRolloutPolicy(max_surge=1,
                                                   canary_weight=0.25))
            rollout_started = True
            print("=== rollout v1 → v2 started under load ===")
        if submitted < args.n_requests:
            for _ in range(rng.poisson(args.arrival)):
                if submitted >= args.n_requests:
                    break
                suffix = rng.integers(
                    0, cfg.vocab_size,
                    size=int(rng.integers(2, 9))).astype(np.int32)
                prompt = np.concatenate(
                    [shared[submitted % len(shared)], suffix])
                r = fleet.submit(prompt, args.max_new_tokens)
                submitted += 1
                if isinstance(r, Rejected):
                    rejected += 1
                    print(f"✗ rejected ({r.reason})")
        for rid in fleet.step():
            res = fleet.result(rid)
            if res is not None:
                finished[rid] = res
        if not phases or phases[-1] != fleet.rollout_phase:
            phases.append(fleet.rollout_phase)
            if args.rollout_demo and rollout_started:
                print(f"--- rollout phase: {fleet.rollout_phase.value} "
                      f"(weights {fleet.router.weights})")
    dt = time.perf_counter() - t0
    done = {rid: r.tokens for rid, r in finished.items() if r.ok}
    total = sum(len(v) for v in done.values())
    per = {name: rep.routed for name, rep in sorted(fleet.replicas.items())}
    print(f"fleet served {len(done)}/{submitted} requests "
          f"({rejected} rejected), {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s) — routed {per}, "
          f"prefix hits/misses {fleet.stats['prefix_hits']}/"
          f"{fleet.stats['prefix_misses']}, rerouted "
          f"{fleet.stats['rerouted']}")
    if args.rollout_demo:
        print(f"rollout phases: {[p.value for p in phases]}; retired "
              f"{[(r['name'], r['drained_clean']) for r in fleet.retired]}")
    return done


if __name__ == "__main__":
    main()
