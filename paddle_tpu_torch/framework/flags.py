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

``FLAGS_cudnn_deterministic`` (default ``False``, the JAX registry's
``paddle_tpu/framework/flags.py:104``) asks for bitwise-reproducible
runs on the card. ``True`` turns on torch's deterministic mode in its
strict form (``torch.use_deterministic_algorithms(True)``: an operation
with no deterministic CUDA implementation raises instead of warning),
``torch.backends.cudnn.deterministic = True`` and ``benchmark = False``,
and sets ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` where the environment has no
value (torch checks it at every cuBLAS call in that mode). ``False`` puts
back the settings the first ``True`` found. The strict form is chosen
over ``warn_only`` so that the flag is a guarantee: the port's paths
avoid the operations torch cannot run deterministically, for instance
``nn.functional.adaptive_avg_pool2d`` takes means over its bins (the JAX
formulation), not torch's adaptive pooling, whose CUDA backward has none.

Consumers read the flag per call, so ``set_flags`` takes effect at once.
An unknown flag or value raises, as the JAX registry's ``set_flags`` does
for an unknown name.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Union

__all__ = ["set_flags", "get_flags", "flag", "MOE_DISPATCH_MODES",
           "EMBEDDING_OOV_POLICIES"]

MOE_DISPATCH_MODES = ("index", "sort", "gmm", "fused", "einsum")
EMBEDDING_OOV_POLICIES = ("error", "clip")

_VALUES: Dict[str, Any] = {"FLAGS_moe_dispatch": "index",
                           "FLAGS_embedding_oov_policy": "error",
                           "FLAGS_cudnn_deterministic": False}
_CHOICES = {"FLAGS_moe_dispatch": MOE_DISPATCH_MODES,
            "FLAGS_embedding_oov_policy": EMBEDDING_OOV_POLICIES,
            "FLAGS_cudnn_deterministic": (False, True)}
_BOOLS = ("FLAGS_cudnn_deterministic",)
_PRIOR_DETERMINISM = []  # torch's settings before the first True


def _as_bool(value) -> bool:
    """The JAX registry's reading of a bool flag: a string is true when it
    is 1, true, yes or on (any case), anything else by ``bool``."""
    if isinstance(value, str):
        return value.lower() in ("1", "true", "yes", "on")
    return bool(value)


def _set_deterministic(on: bool) -> None:
    import torch

    if on:
        if not _PRIOR_DETERMINISM:
            _PRIOR_DETERMINISM.append((
                torch.are_deterministic_algorithms_enabled(),
                torch.is_deterministic_algorithms_warn_only_enabled(),
                torch.backends.cudnn.deterministic,
                torch.backends.cudnn.benchmark))
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif _PRIOR_DETERMINISM:
        algos, warn_only, cudnn_det, bench = _PRIOR_DETERMINISM.pop()
        torch.use_deterministic_algorithms(algos, warn_only=warn_only)
        torch.backends.cudnn.deterministic = cudnn_det
        torch.backends.cudnn.benchmark = bench


_ON_SET = {"FLAGS_cudnn_deterministic": _set_deterministic}


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
        if key in _BOOLS:
            value = _as_bool(value)
        if value not in _CHOICES[key]:
            raise ValueError(f"{key} must be one of {_CHOICES[key]}, got "
                             f"{value!r}")
        staged[key] = value
    for key, value in staged.items():
        if key in _ON_SET and value != _VALUES[key]:
            _ON_SET[key](value)
        _VALUES[key] = value


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
