"""AIMaster sidecar: the checkpoint-protocol actor inside an elastic job.

Counterpart of ``examples/aimaster.py``. Polls the job's
``ckpt-requested-version`` annotation and acknowledges after persisting
state (reference: the AIMaster the operator coordinates with via
annotations, elastic_scale.go:469-488). Against a real cluster the
``cluster`` handle is the API-server client; this entrypoint wires the same
``train/checkpoint.py::CheckpointAgent`` the trainer's tests use, over
``TorchJob``::

    python -m tpu_on_k8s_torch.aimaster --job-name j1 \\
        --api-server http://127.0.0.1:8080 --max-polls 3
"""
from __future__ import annotations

import argparse
import time


def run(cluster, namespace: str, job_name: str, save_fn,
        period_seconds: float = 5.0, max_polls: int = 0) -> int:
    """Poll loop; returns number of checkpoints completed. ``max_polls=0``
    runs forever (in-cluster mode)."""
    from tpu_on_k8s_torch.api.types import TorchJob
    from tpu_on_k8s_torch.train.checkpoint import CheckpointAgent

    agent = CheckpointAgent(cluster, namespace, job_name, save_fn,
                            job_cls=TorchJob)
    completed = 0
    polls = 0
    while max_polls == 0 or polls < max_polls:
        if agent.poll_once() is not None:
            completed += 1
        polls += 1
        if max_polls == 0 or polls < max_polls:
            time.sleep(period_seconds)
    return completed


def default_save_fn(ckpt_dir: str):
    """Checkpoint writer used when the training loop doesn't inject one:
    persists a per-generation marker so resume can find the latest state.
    Real trainers pass `CheckpointManager.save` instead (train/checkpoint.py)."""
    import json
    import pathlib

    def save(generation: int) -> None:
        root = pathlib.Path(ckpt_dir)
        root.mkdir(parents=True, exist_ok=True)
        (root / f"gen_{generation:06d}.json").write_text(
            json.dumps({"generation": generation, "completed_at": time.time()}))

    return save


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="AIMaster checkpoint agent")
    p.add_argument("--namespace", default="default")
    p.add_argument("--job-name", required=True)
    p.add_argument("--period-seconds", type=float, default=5.0)
    p.add_argument("--api-server", default="",
                   help="Operator API server URL (default: kubeconfig / "
                        "in-cluster resolution)")
    p.add_argument("--ckpt-dir", default="/tmp/tpu-on-k8s-ckpt")
    p.add_argument("--max-polls", type=int, default=0,
                   help="Exit after N polls (0 = run forever)")
    args = p.parse_args(argv)

    url = args.api_server
    token_path = ca_path = None
    if not url:
        from tpu_on_k8s_torch.client import kubeconfig

        cfg = kubeconfig.resolve()
        url = kubeconfig.server_url(cfg)
        token_path, ca_path = cfg.token_path, cfg.ca_path
    if not url:
        raise SystemExit(
            "no API server: pass --api-server or provide a kubeconfig / "
            "in-cluster service-account mount")
    from tpu_on_k8s_torch.client.rest import RestCluster

    cluster = RestCluster(url, token_path=token_path, ca_path=ca_path)
    try:
        completed = run(cluster, args.namespace, args.job_name,
                        default_save_fn(args.ckpt_dir),
                        period_seconds=args.period_seconds,
                        max_polls=args.max_polls)
    finally:
        cluster.close()
    print(f"aimaster: completed {completed} checkpoint(s)")
    return 0


if __name__ == "__main__":
    main()
