from .optimizer import AdamW

__all__ = ["AdamW"]
