from . import activation, loss
from .activation import *  # noqa: F401,F403
from .attention import flash_attention, scaled_dot_product_attention
from .common import (bilinear, cosine_similarity, dropout, embedding,
                     layer_norm, linear, normalize, pad)
from .loss import *  # noqa: F401,F403
from .norm import rms_norm, rms_norm_residual
from ...ops.manipulation import one_hot

__all__ = (["scaled_dot_product_attention", "flash_attention", "dropout",
            "rms_norm", "rms_norm_residual", "linear", "embedding",
            "layer_norm", "normalize", "cosine_similarity", "bilinear",
            "pad", "one_hot"] + activation.__all__ + loss.__all__)
