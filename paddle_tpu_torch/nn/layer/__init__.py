from .common import Dropout
from .moe import MoELayer
from .norm import RMSNorm

__all__ = ["Dropout", "MoELayer", "RMSNorm"]
