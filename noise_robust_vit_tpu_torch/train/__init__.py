"""Training runtime of the port (counterpart of ``noise_robust_vit_tpu/train``)."""

from .optim import adamw
from .trainer import TrainState, create_train_state

__all__ = ["TrainState", "adamw", "create_train_state"]
