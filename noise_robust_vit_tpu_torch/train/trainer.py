"""The train step (counterpart of the step engine of
``noise_robust_vit_tpu/train/trainer.py::Trainer._build_train_step``).

One step is forward, mean cross-entropy on the logits cast to float32,
backward and one AdamW update of the float32 parameters. A ``StepTracer``
in ``TrainState.tracer`` times its phases (``tracing.py``). The mesh,
checkpointing, logging, preemption and the hook protocol are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .optim import adamw
from .tracing import StepTracer

__all__ = ["TrainState", "create_train_state"]


@dataclass
class TrainState:
    """Model, optimizer and step count; ``train_step`` advances all three.
    ``tracer``, off by default, marks each step's phases."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    tracer: StepTracer | None = None

    def train_step(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """One update on ``images [B, H, W, C]`` / integer ``labels [B]``;
        returns the batch's mean loss (a detached device scalar)."""
        t = self.tracer
        self.model.train()
        if t is not None:
            t.mark("begin", self.step)
        logits = self.model(images)
        loss = F.cross_entropy(logits.float(), labels)
        if t is not None:
            t.mark("forward_end")
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if t is not None:
            t.mark("backward_end")
        self.optimizer.step()
        if t is not None:
            t.mark("optimizer_end")
        self.step += 1
        return loss.detach()


def create_train_state(model: torch.nn.Module, lr: float = 1e-3,
                       weight_decay: float = 0.05) -> TrainState:
    return TrainState(model=model, optimizer=adamw(model.parameters(), lr=lr,
                                                   weight_decay=weight_decay))
