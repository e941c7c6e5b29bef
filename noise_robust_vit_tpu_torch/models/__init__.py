"""Models of the port (counterpart of ``noise_robust_vit_tpu/models``)."""

from .cait import CaiT
from .cvt import CvT
from .factory import create_model, register_model
from .levit import LeViT, fuse_levit_variables
from .mobile_vit import MobileViT
from .simple_vit import SimpleViT
from .swin import SwinTransformer

__all__ = ["CaiT", "CvT", "LeViT", "MobileViT", "SimpleViT", "SwinTransformer", "create_model",
           "fuse_levit_variables", "register_model"]
