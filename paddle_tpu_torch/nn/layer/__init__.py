from .norm import RMSNorm

__all__ = ["RMSNorm"]
