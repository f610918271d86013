"""Mixed precision (port of ``paddle_tpu/amp``): ``decorate``, the
``GradScaler``/``AmpScaler`` and the device queries.

``auto_cast`` (``amp_guard``) is not ported: the JAX package casts each
primitive's inputs in its eager dispatch layer (``maybe_cast_inputs``,
``paddle_tpu/amp/__init__.py:69-95``), which the port does not have until
its ``core/tensor.py`` and ``ops/`` are ported (ROADMAP.md, Queue 1 item
5); it raises.
"""
from __future__ import annotations

import torch

from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "amp_guard", "decorate", "GradScaler", "AmpScaler",
           "is_bfloat16_supported", "is_float16_supported"]

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    raise NotImplementedError(
        "amp.auto_cast is not ported yet: it casts in the eager dispatch "
        "layer, which comes with core/tensor.py and ops/; see ROADMAP.md, "
        "Queue 1 item 5")


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate`` (``paddle_tpu/amp/__init__.py:98-108``): the
    O2 path, every floating parameter and buffer of each model cast to
    ``dtype`` in place (``Module.to``; an optimizer built before keeps its
    parameters). Returns ``models`` (and ``optimizers`` where given) as
    passed."""
    d = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    for m in model_list:
        m.to(dtype=d)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    return True
