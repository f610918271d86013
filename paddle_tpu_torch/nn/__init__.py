from . import functional
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import MoELayer, RMSNorm

__all__ = ["functional", "MoELayer", "RMSNorm", "ClipGradByValue",
           "ClipGradByNorm", "ClipGradByGlobalNorm"]
