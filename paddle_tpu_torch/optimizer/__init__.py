from . import lr
from .optimizer import Adafactor, Adam, AdamW, Optimizer

__all__ = ["Optimizer", "Adam", "AdamW", "Adafactor", "lr"]
