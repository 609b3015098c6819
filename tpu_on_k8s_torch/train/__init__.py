"""Training: the counterpart of ``tpu_on_k8s/train/`` (the step, the loss,
the optimizers, ``TrainLoop`` in ``loop.py``, checkpoints in
``checkpoint.py``, the FLOP count in ``compile.py``, the classifier
trainer in ``vision.py`` and BERT's masked-LM step in ``mlm.py``; on a
mesh through ``parallel/``)."""
from tpu_on_k8s_torch.train.optimizer import (  # noqa: F401
    ClipAdamW,
    default_optimizer,
    warmup_cosine_decay_schedule,
)
from tpu_on_k8s_torch.train.trainer import (  # noqa: F401
    Trainer,
    TrainState,
    chunked_cross_entropy,
    cross_entropy_loss,
    make_eval_step,
    make_grads_fn,
    make_train_step,
    packed_loss_mask,
    packed_positions_and_segments,
    train_state_template,
)
