"""Models of the port (counterpart of ``noise_robust_vit_tpu/models``)."""

from .factory import create_model, register_model
from .simple_vit import SimpleViT
from .swin import SwinTransformer

__all__ = ["SimpleViT", "SwinTransformer", "create_model", "register_model"]
