from .attention import scaled_dot_product_attention
from .norm import rms_norm, rms_norm_residual

__all__ = ["scaled_dot_product_attention", "rms_norm", "rms_norm_residual"]
