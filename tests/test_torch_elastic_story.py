"""The elastic story (``tests/test_elastic_story.py``) across both planes of
the port, against the reference's, on the CPU, in one process.

The port's trainer takes two steps of ``TransformerConfig.tiny()`` from the
reference's initial parameters (carried across with ``from_jax_params``)
while the port's job controller runs the story's elastic job; two workers
are preempted, the controller requests a checkpoint, the AIMaster-side
``CheckpointAgent`` saves the trainer's state at the requested generation
and acknowledges, the controller cleans the victims and respecs, and a
fresh ``TrainState`` restored from the checkpoint takes one more step. The
three losses are the reference story's trainer's within the bf16 trainer
tolerance of ``tests/test_torch_train_step.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_torch_elastic import EL, TorchJobCheckpointAgent
from test_torch_train_step import BF16_TOL, port_config
from tpu_on_k8s.models.transformer import Transformer as JTransformer
from tpu_on_k8s.models.transformer import TransformerConfig as JConfig
from tpu_on_k8s.models.transformer import flagship_partition_rules
from tpu_on_k8s.parallel.mesh import MeshConfig, create_mesh
from tpu_on_k8s.train import trainer as jtrainer
from tpu_on_k8s_torch.api import constants
from tpu_on_k8s_torch.api.core import Pod
from tpu_on_k8s_torch.api.types import TaskType, TorchJob
from tpu_on_k8s_torch.models import params as pparams
from tpu_on_k8s_torch.train.checkpoint import CheckpointManager
from tpu_on_k8s_torch.train.optimizer import default_optimizer
from tpu_on_k8s_torch.train.trainer import Trainer, train_state_template

# one intra-op thread, so that parallel test workers do not oversubscribe
# the cores under the suite's timing-sensitive tests
torch.set_num_threads(1)


def test_preemption_checkpoint_rescale_resume_matches_the_reference(tmp_path):
    """``tests/test_elastic_story.py`` in one process at ``tiny``: the port's
    trainer takes two steps from the reference's parameters, two workers are
    preempted, the controller requests a checkpoint, the AIMaster-side agent
    saves the state at the requested generation, the controller cleans the
    victims and respecs, and a fresh state restored from the checkpoint
    takes one more step. Its three losses are the reference story's
    trainer's (8-way fsdp mesh, bf16 compute) within the bf16 trainer
    tolerance of ``tests/test_torch_train_step.py``."""
    # ---- the reference's trainer: its story's model, mesh, optimizer, data
    jcfg = JConfig.tiny()
    jopt = jtrainer.default_optimizer(warmup_steps=1, decay_steps=10)
    mesh8 = create_mesh(MeshConfig(data=1, fsdp=8, model=1, seq=1))
    jt = jtrainer.Trainer(JTransformer(jcfg), flagship_partition_rules(),
                          mesh8, jopt)
    tokens = jax.random.randint(jax.random.key(0), (8, 65), 0,
                                jcfg.vocab_size, jnp.int32)
    jstate = jt.init_state(jax.random.key(1), tokens[:, :-1])
    tree = jax.tree.map(np.asarray, jstate.params)
    want = []
    for _ in range(3):
        jstate, m = jt.train_step(jstate, jt.shard_batch(tokens))
        want.append(float(m["loss"]))

    # ---- the port: the story's cluster and a trainer from the same weights
    cluster, manager, engine, sim, elastic = EL.make_env()
    EL.start_running(cluster, manager, sim, name="story")
    cfg = port_config(jcfg)
    model = pparams.load_model(
        cfg, pparams.from_jax_params(tree, torch.float32, "cpu"), "cpu")
    opt_kw = dict(warmup_steps=1, decay_steps=10)
    trainer = Trainer(model, default_optimizer(model.parameters(), **opt_kw))
    state = trainer.state()
    batch = torch.from_numpy(np.array(tokens)).long()
    got = []
    for _ in range(2):
        state, m = trainer.train_step(state, batch)
        got.append(float(m["loss"]))

    mgr = CheckpointManager(str(tmp_path))
    agent = TorchJobCheckpointAgent(
        cluster, "default", "story",
        lambda gen: mgr.save(state, step=int(state.step), generation=gen))
    for name in ("story-worker-6", "story-worker-7"):
        pod = cluster.get(Pod, "default", name)
        assert constants.FINALIZER_PREEMPT_PROTECTOR in pod.metadata.finalizers
        cluster.delete(Pod, "default", name)
    manager.run_until_idle()
    job = cluster.get(TorchJob, "default", "story")
    requested = job.metadata.annotations.get(
        constants.ANNOTATION_CKPT_REQUESTED_VERSION)
    assert requested is not None

    assert agent.poll_once() == int(requested)
    manager.run_until_idle()
    job = cluster.get(TorchJob, "default", "story")
    assert job.metadata.generation > int(requested)
    assert job.spec.tasks[TaskType.WORKER].num_tasks == 4
    assert mgr.latest() == (int(requested), 2)

    # ---- the new generation: a fresh state restored from the checkpoint
    template = train_state_template(cfg, "cpu", **opt_kw)
    restored, gen, step = mgr.restore(template)
    assert (gen, step) == (int(requested), int(state.step))
    for key, t in state.state_dict().items():
        assert torch.equal(restored.state_dict()[key], t), key
    trainer2 = Trainer(restored.model, restored.optimizer)
    restored, m = trainer2.train_step(restored, batch)
    got.append(float(m["loss"]))
    assert int(restored.step) == step + 1
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=BF16_TOL["loss"], rtol=0)
