from . import functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layer import *  # noqa: F401,F403
from .layer import __all__ as _layers

__all__ = (["functional", "initializer", "ClipGradByValue", "ClipGradByNorm",
            "ClipGradByGlobalNorm"] + _layers)
