"""MNIST CNN training: the counterpart of ``examples/train_mnist.py``
(BASELINE config 1, the reference's config/samples baseline).

Synthetic MNIST-shaped records (784 pixel bytes widened to int32 and a
label, from numpy ``--seed``) written to a record file and read back
through the port's native loader (``data/loader.py``, each rank its own
shard) and ``device_prefetch`` (the host split into images in [0, 1] and
labels rides the prefetch ring), then ``ClassifierTrainer.fit`` with
``optax.adam(1e-3)``'s arithmetic (``train/optimizer.py``'s ``adam``) on
the job's mesh; ``[elastic-metrics]`` a step. ``--data F`` trains from
``F`` (a real 28x28 record file, or synthesised there if missing);
without it the file lives in a temporary directory removed at the end::

    python -m tpu_on_k8s_torch.train_mnist --steps 100
    python -m tpu_on_k8s_torch.train_mnist --device cpu --steps 3
"""
from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch.cli_common import bring_up, standard_parser
from tpu_on_k8s_torch.data import DataLoader, FixedRecordDataset, write_records
from tpu_on_k8s_torch.data.prefetch import device_prefetch
from tpu_on_k8s_torch.models.vision import MnistCNN, vision_partition_rules
from tpu_on_k8s_torch.train.optimizer import adam
from tpu_on_k8s_torch.train.vision import ClassifierTrainer
from tpu_on_k8s_torch.train_llama import StepTimer


def synthesize(path: Path, n: int = 4096, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    # record = 784 pixel bytes widened to int32 + 1 label int32
    images = rng.integers(0, 255, (n, 784), dtype=np.int32)
    labels = rng.integers(0, 10, (n, 1), dtype=np.int32)
    write_records(str(path), np.concatenate([images, labels], axis=1))


def split(batch: np.ndarray):
    """A record batch → (images ``[b, 28, 28, 1]`` in [0, 1], labels)."""
    images = (batch[:, :784].astype(np.float32) / 255.0).reshape(
        -1, 28, 28, 1)
    return images, batch[:, 784].astype(np.int64)


def main(argv=None) -> float:
    p = standard_parser("MNIST CNN")
    p.add_argument("--data", default="")
    args = p.parse_args(argv)
    with bring_up(args) as (dev, mesh), tempfile.TemporaryDirectory(
            prefix="mnist_") as tmp:
        # each rank its own temporary copy: the records follow --seed
        data = Path(args.data) if args.data else Path(tmp) / "mnist_syn.bin"
        if not data.exists():
            synthesize(data, seed=args.seed)
        return _train(args, dev, mesh, data)


def _train(args, dev: torch.device, mesh, data: Path) -> float:
    with torch.device(dev):
        model = MnistCNN()
    trainer = ClassifierTrainer(model, adam(model.parameters(), 1e-3),
                                rules=vision_partition_rules(), mesh=mesh)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(
        args.seed))
    shard_id, n_shards = trainer.data_shard()
    loader = DataLoader(FixedRecordDataset(str(data), record_shape=(785,),
                                           dtype=np.int32),
                        batch_size=args.batch_per_host, shard_id=shard_id,
                        num_shards=n_shards, seed=args.seed)
    timer = StepTimer(args.batch_per_host, enabled=dist.get_rank() == 0)
    try:
        # the host split runs inside the prefetch ring: the copy of batch
        # N+1 overlaps step N
        batches = device_prefetch(loader, dev, depth=2, transform=split)
        result = trainer.fit(
            state, batches, args.steps, log_every=1,
            on_metrics=lambda step, m, dt: timer.report(
                step - 1, m["loss"], dt, m["accuracy"]))
    finally:
        loader.close()
    return result.last_metrics.get("loss", float("nan"))


if __name__ == "__main__":
    main()
