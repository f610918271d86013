from . import activation, loss
from .activation import *  # noqa: F401,F403
from .attention import flash_attention, scaled_dot_product_attention
from .common import (adaptive_avg_pool2d, adaptive_max_pool2d, avg_pool2d,
                     batch_norm, bilinear, conv1d, conv2d, conv2d_transpose,
                     cosine_similarity, dropout, embedding, group_norm,
                     instance_norm, layer_norm, linear, local_response_norm,
                     max_pool2d, normalize, pad)
from .loss import *  # noqa: F401,F403
from .norm import rms_norm, rms_norm_residual
from ...ops.manipulation import one_hot

__all__ = (["scaled_dot_product_attention", "flash_attention", "dropout",
            "rms_norm", "rms_norm_residual", "linear", "embedding",
            "layer_norm", "normalize", "cosine_similarity", "bilinear",
            "pad", "one_hot", "batch_norm", "group_norm", "instance_norm",
            "conv1d", "conv2d", "conv2d_transpose", "max_pool2d",
            "avg_pool2d", "adaptive_avg_pool2d", "adaptive_max_pool2d",
            "local_response_norm"] + activation.__all__ + loss.__all__)
