"""Training runtime of the port (counterpart of ``noise_robust_vit_tpu/train``)."""

from .optim import adamw
from .tracing import StepTracer
from .trainer import TrainState, create_train_state

__all__ = ["StepTracer", "TrainState", "adamw", "create_train_state"]
