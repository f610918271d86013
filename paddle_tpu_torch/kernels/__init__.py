"""Hand-written Hopper kernels of the port, each beside its plain version.

``counters()`` reads every wrapper's launch and plain-call counts and
``reset_counters()`` sets them to 0: a run shows that its path went through
the kernels by resetting before and reading after.
"""
from . import flash_attention as _flash
from . import paged_attention as _paged
from .flash_attention import (flash_attention, flash_attention_plain,
                              flash_attention_with_lse)
from .paged_attention import paged_attention, paged_attention_plain

__all__ = ["paged_attention", "paged_attention_plain", "flash_attention",
           "flash_attention_with_lse", "flash_attention_plain", "counters",
           "reset_counters"]

_COUNTS = {"paged_attention": _paged.COUNTS,
           "flash_attention": _flash.COUNTS}


def counters():
    """``{kernel: {"launches": n, "plain_calls": n}}``."""
    return {name: {"launches": c.launches, "plain_calls": c.plain_calls}
            for name, c in _COUNTS.items()}


def reset_counters() -> None:
    for c in _COUNTS.values():
        c.reset()
