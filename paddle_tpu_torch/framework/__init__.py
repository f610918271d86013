from .flags import get_flags, set_flags

__all__ = ["get_flags", "set_flags"]
