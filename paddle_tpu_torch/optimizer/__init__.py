from .optimizer import Adafactor, AdamW

__all__ = ["AdamW", "Adafactor"]
