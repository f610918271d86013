"""Global flags (counterpart of ``paddle_tpu/framework/flags.py``).

The port holds the flags its modules read, with the JAX package's
defaults and values. ``FLAGS_moe_dispatch`` says how an MoE layer moves
tokens to its experts:

- ``index`` (default): capacity routing by a cumsum over the expert one-hot,
  plain PyTorch (the JAX package has no kernel there either);
- ``sort``: runs ``index``; the JAX package's stable sort by expert finds
  the same capacity slots as its cumsum;
- ``einsum``: GShard's one-hot dispatch and combine einsums, O(n * e *
  cap), plain PyTorch (the JAX package's parity oracle);
- ``gmm``: dropless; rows sorted by expert with a stable argsort, then the
  grouped-GEMM kernel;
- ``fused``: dropless; the routing kernel orders the rows without a sort,
  the gather and combine kernels move them, the grouped-GEMM kernel runs
  the experts.

``FLAGS_embedding_oov_policy`` says what ``nn.functional.embedding`` does
with an id outside the table:

- ``error`` (default): an eager lookup reads the ids' min and max back
  (one readback) and raises; inside a CUDA graph capture no readback can
  run, and there the lookup clamps the ids (see ``embedding``);
- ``clip``: the ids are clamped to the table everywhere.

Consumers read the flag per call, so ``set_flags`` takes effect at once.
An unknown flag or value raises, as the JAX registry's ``set_flags`` does
for an unknown name.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Union

__all__ = ["set_flags", "get_flags", "flag", "MOE_DISPATCH_MODES",
           "EMBEDDING_OOV_POLICIES"]

MOE_DISPATCH_MODES = ("index", "sort", "gmm", "fused", "einsum")
EMBEDDING_OOV_POLICIES = ("error", "clip")

_VALUES: Dict[str, Any] = {"FLAGS_moe_dispatch": "index",
                           "FLAGS_embedding_oov_policy": "error"}
_CHOICES = {"FLAGS_moe_dispatch": MOE_DISPATCH_MODES,
            "FLAGS_embedding_oov_policy": EMBEDDING_OOV_POLICIES}


def _key(name: str) -> str:
    key = name if name.startswith("FLAGS_") else "FLAGS_" + name
    if key not in _VALUES:
        raise ValueError(f"unknown flag {name!r}; known: {sorted(_VALUES)}")
    return key


def set_flags(flags: Dict[str, Any]) -> None:
    """Set flags by name (``FLAGS_`` prefix optional); every name and value
    is checked before any is stored."""
    staged = {}
    for name, value in flags.items():
        key = _key(name)
        if value not in _CHOICES[key]:
            raise ValueError(f"{key} must be one of {_CHOICES[key]}, got "
                             f"{value!r}")
        staged[key] = value
    _VALUES.update(staged)


def get_flags(flags: Union[str, Iterable[str], None] = None
              ) -> Dict[str, Any]:
    """``{name: value}`` for one name, several, or (``None``) all."""
    if flags is None:
        return dict(_VALUES)
    names = [flags] if isinstance(flags, str) else list(flags)
    return {_key(n): _VALUES[_key(n)] for n in names}


def flag(name: str):
    """One flag's value (``FLAGS_`` prefix optional), for the modules that
    read it per call."""
    return _VALUES[_key(name)]
