"""Training on one card: the counterpart of ``tpu_on_k8s/train/`` (the step,
the loss and the optimizer; the loop, checkpoints and the mesh are later
slices)."""
from tpu_on_k8s_torch.train.optimizer import (  # noqa: F401
    ClipAdamW,
    default_optimizer,
    warmup_cosine_decay_schedule,
)
from tpu_on_k8s_torch.train.trainer import (  # noqa: F401
    Trainer,
    chunked_cross_entropy,
    cross_entropy_loss,
    make_eval_step,
    make_train_step,
    packed_loss_mask,
    packed_positions_and_segments,
)
