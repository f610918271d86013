from .activation import *  # noqa: F401,F403
from .activation import __all__ as _activation
from .common import (Bilinear, CosineSimilarity, Dropout, Embedding, Flatten,
                     Identity, Linear)
from .container import LayerDict, LayerList, ParameterList, Sequential
from .layers import Layer, Parameter, ParamAttr
from .loss import *  # noqa: F401,F403
from .loss import __all__ as _loss
from .moe import MoELayer
from .norm import LayerNorm, RMSNorm

__all__ = (["Layer", "Parameter", "ParamAttr", "Linear", "Embedding",
            "Dropout", "Flatten", "Identity", "CosineSimilarity", "Bilinear",
            "Sequential", "LayerList", "LayerDict", "ParameterList",
            "LayerNorm", "RMSNorm", "MoELayer"] + _activation + _loss)
