from .moe import MoELayer
from .norm import RMSNorm

__all__ = ["MoELayer", "RMSNorm"]
