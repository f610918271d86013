from . import functional
from .layer import RMSNorm

__all__ = ["functional", "RMSNorm"]
