from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import Dropout, MoELayer, RMSNorm

__all__ = ["functional", "Dropout", "MoELayer", "RMSNorm",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
