"""Models of the port (counterpart of ``noise_robust_vit_tpu/models``)."""

from .factory import create_model, register_model
from .simple_vit import SimpleViT

__all__ = ["SimpleViT", "create_model", "register_model"]
