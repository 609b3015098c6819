"""Mesh parallelism over the job's ranks: the counterpart of
``tpu_on_k8s/parallel/``.

The vocabulary is the reference's: a ``DeviceMesh`` with the axes ``data``
(batch split, gradients summed), ``fsdp`` (batch and parameters split),
``model`` (tensor parallelism: heads and hidden split), ``seq`` (each
sequence split, for the decoder's training) and ``expert`` (an MoE
model's experts split; the batch is the same on its ranks), and regex
rules over leaf paths
that give each parameter its layout. Where the reference hands the specs to
XLA's SPMD partitioner, ``sharded.py`` writes the layout out with
``parallelize_module`` and FSDP2 (a serving model's with plain local
tensors and explicit collectives, ``shard_serving_model``);
``reshard.py`` moves a live state from one (mesh, rules) to another;
``serving.py`` runs a serving engine's device programs on every rank of
its mesh (the driver's command channel and ``serve_mesh_worker``);
``ring.py`` and ``ulysses.py`` run attention over ``seq`` (a P2P ring, or
all-to-alls from sequence to heads); ``pipeline.py`` runs stacked layers
as a GPipe pipeline over a ``stage`` axis (``stage_mesh``).
"""
from tpu_on_k8s_torch.parallel.mesh import (
    AXIS_DATA,
    AXIS_FSDP,
    AXIS_MODEL,
    AXIS_SEQ,
    MeshConfig,
    batch_sharding,
    create_mesh,
)
from tpu_on_k8s_torch.parallel.partition import (
    PartitionRule,
    named_sharding,
    shard_pytree,
    spec_for_path,
    specs_for_pytree,
)
from tpu_on_k8s_torch.parallel.pipeline import AXIS_STAGE, gpipe, stage_mesh
from tpu_on_k8s_torch.parallel.reshard import (
    ReshardAgent,
    ReshardNotice,
    ReshardPlan,
    plan_reshard,
    reshard_state,
    restore_resharded,
)
from tpu_on_k8s_torch.parallel.ring import (
    ring_attention,
    ring_attention_shard,
    ring_context,
)
from tpu_on_k8s_torch.parallel.ulysses import (
    ulysses_attention,
    ulysses_attention_shard,
)

__all__ = [
    "AXIS_DATA",
    "AXIS_FSDP",
    "AXIS_MODEL",
    "AXIS_SEQ",
    "AXIS_STAGE",
    "MeshConfig",
    "create_mesh",
    "batch_sharding",
    "gpipe",
    "PartitionRule",
    "ReshardAgent",
    "ReshardNotice",
    "ReshardPlan",
    "named_sharding",
    "plan_reshard",
    "reshard_state",
    "restore_resharded",
    "ring_attention",
    "ring_attention_shard",
    "ring_context",
    "shard_pytree",
    "spec_for_path",
    "specs_for_pytree",
    "stage_mesh",
    "ulysses_attention",
    "ulysses_attention_shard",
]
