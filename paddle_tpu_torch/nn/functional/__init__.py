from .attention import flash_attention, scaled_dot_product_attention
from .common import dropout
from .norm import rms_norm, rms_norm_residual

__all__ = ["scaled_dot_product_attention", "flash_attention", "dropout",
           "rms_norm", "rms_norm_residual"]
