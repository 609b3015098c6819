"""ResNet-50 data-parallel training: the counterpart of
``examples/train_resnet.py`` (BASELINE config 2).

Synthetic ImageNet-shaped NHWC batches from numpy (``--seed``: the image
holds no dataset), random fp32 master weights drawn as the reference
initialises them (seed ``--seed + 2``), bf16 compute, ``ClassifierTrainer``
(``train/vision.py``) with nesterov SGD (momentum 0.9) on the warm-up
cosine schedule (peak 0.1, warm-up ``min(5·390, max(steps // 10, 1))``
steps), laid out by ``vision_partition_rules`` on the job's mesh
(``cli_common.bring_up``; ``--batch-per-host`` rows a rank), driven by
``fit`` one step a window, each printing the ``[elastic-metrics]`` line
(``tok_s``: images/s)::

    python -m tpu_on_k8s_torch.train_resnet --steps 20 --batch-per-host 256
    python -m tpu_on_k8s_torch.train_resnet --tiny --device cpu --steps 3 \\
        --image-size 32
"""
from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.distributed as dist

from tpu_on_k8s_torch.cli_common import bring_up, standard_parser
from tpu_on_k8s_torch.models.vision import (
    ResNet,
    ResNetConfig,
    vision_partition_rules,
)
from tpu_on_k8s_torch.train.optimizer import SGD, warmup_cosine_decay_schedule
from tpu_on_k8s_torch.train.vision import ClassifierTrainer
from tpu_on_k8s_torch.train_llama import StepTimer


def main(argv=None) -> float:
    p = standard_parser("ResNet-50")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--tiny", action="store_true", help="test-size model")
    args = p.parse_args(argv)
    with bring_up(args) as (dev, mesh):
        return _train(args, dev, mesh)


def _train(args, dev: torch.device, mesh) -> float:
    cfg = (ResNetConfig.resnet18ish(args.num_classes) if args.tiny
           else ResNetConfig.resnet50(args.num_classes))
    with torch.device(dev):
        model = ResNet(cfg)
    warmup = min(5 * 390, max(args.steps // 10, 1))
    opt = SGD(model.parameters(), warmup_cosine_decay_schedule(
        0.0, 0.1, warmup, max(args.steps, warmup + 1)), momentum=0.9,
        nesterov=True)
    trainer = ClassifierTrainer(model, opt, rules=vision_partition_rules(),
                                mesh=mesh)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(
        args.seed + 2))

    global_batch = args.batch_per_host * dist.get_world_size()
    rng = np.random.default_rng(args.seed)
    images = torch.from_numpy(rng.standard_normal(
        (global_batch, args.image_size, args.image_size, 3),
        dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, args.num_classes,
                                           (global_batch,)).astype(np.int64))
    batch = tuple(t.to(dev) for t in trainer.shard_batch(images, labels))
    timer = StepTimer(global_batch, enabled=dist.get_rank() == 0)
    result = trainer.fit(
        state, itertools.repeat(batch), args.steps,
        log_every=1, on_metrics=lambda step, m, dt: timer.report(
            step - 1, m["loss"], dt, m["accuracy"]))
    return result.last_metrics.get("loss", float("nan"))


if __name__ == "__main__":
    main()
