"""Models of the port (counterpart of ``noise_robust_vit_tpu/models``)."""

from .cait import CaiT
from .cvt import CvT
from .factory import create_model, register_model
from .levit import LeViT, fuse_levit_variables
from .mobile_vit import MobileViT
from .simple_vit import SimpleViT
from .swin import SwinTransformer
from .vision_transformer import ConvStemConfig, VisionTransformer, interpolate_embeddings

__all__ = ["CaiT", "ConvStemConfig", "CvT", "LeViT", "MobileViT", "SimpleViT", "SwinTransformer",
           "VisionTransformer", "create_model", "fuse_levit_variables", "interpolate_embeddings",
           "register_model"]
