from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import (Bilinear, CosineSimilarity, Dropout, Embedding, Flatten,
                     Identity, Linear)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .conv import Conv1D, Conv2D, Conv2DTranspose
from .layers import Layer, Parameter, ParamAttr
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .moe import MoELayer
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D,
                   GroupNorm, InstanceNorm2D, LayerNorm, LocalResponseNorm,
                   RMSNorm, SpectralNorm, SyncBatchNorm)
from .pooling import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D,
                      MaxPool2D)

__all__ = (["Layer", "Parameter", "ParamAttr", "Linear", "Embedding",
            "Dropout", "Flatten", "Identity", "CosineSimilarity", "Bilinear",
            "Sequential", "LayerList", "LayerDict", "ParameterList",
            "LayerNorm", "RMSNorm", "MoELayer", "Conv1D", "Conv2D",
            "Conv2DTranspose", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
            "AdaptiveMaxPool2D", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
            "BatchNorm3D", "SyncBatchNorm", "GroupNorm", "InstanceNorm2D",
            "LocalResponseNorm", "SpectralNorm"] + _activation + _loss)
