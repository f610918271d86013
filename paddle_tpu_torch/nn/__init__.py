from . import functional
from .layer import MoELayer, RMSNorm

__all__ = ["functional", "MoELayer", "RMSNorm"]
