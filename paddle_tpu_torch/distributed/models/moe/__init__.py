"""Expert-parallel collectives (port of
``paddle_tpu/distributed/models/moe/__init__.py``; reference
``python/paddle/distributed/models/moe/utils.py`` and the
``global_scatter`` / ``global_gather`` ops).

The layout is the JAX package's capacity-dense one: a rank's tokens
packed per expert in a fixed capacity, ``x`` [n_expert, capacity, d],
bucket ``e`` holding its tokens routed to global expert ``e``. The JAX
package holds every rank's buckets in one global array whose first dim
is the source rank; here each process holds its own. The counts keep the
reference API: ``local_count`` [n_expert] is how many slots of each bucket
are real, and every slot past it is zeroed before it crosses the wire (the
ragged all-to-all's contract made dense); ``global_count`` sizes the
reference's receive and is not read.

``global_scatter`` sends, over the ``ep`` axis, block ``r`` of the buckets
(the ``n_expert / ep`` experts rank ``r`` owns) to rank ``r``: afterwards
rank ``r`` holds, in source-rank order, every rank's buckets for its own
experts, ``out[s * E/ep + j] = x_s[r * E/ep + j]``. ``global_gather`` sends
the experts' outputs back: the block permutation is its own inverse, so
it is the same all-to-all. Both are differentiable (the axis helper's
backward is the all-to-all back) and, at ep = 1, the mask alone.
"""
from __future__ import annotations

import torch

from ...collective import all_to_all_axis
from ...mesh import require_mesh_env

__all__ = ["number_count", "global_scatter", "global_gather"]


def number_count(gate_idx, upper_range):
    """Per-expert counts ``[upper_range]`` of the expert ids in
    ``gate_idx`` (any shape), in its dtype (reference ``_number_count``)."""
    flat = gate_idx.reshape(-1).long()
    return torch.zeros(int(upper_range), dtype=gate_idx.dtype,
                       device=gate_idx.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=gate_idx.dtype))


def _masked(x, local_count):
    cap = x.shape[1]
    lc = torch.as_tensor(local_count, device=x.device).reshape(-1)
    keep = torch.arange(cap, device=x.device)[None, :] < lc[:, None]
    return x * keep.reshape(keep.shape + (1,) * (x.dim() - 2)).to(x.dtype)


def _a2a(x, local_count):
    ep = require_mesh_env().get_dim("ep")
    if x.shape[0] % ep:
        raise ValueError(f"global_scatter/gather takes [n_expert, capacity, "
                         f"...] with n_expert divisible by ep={ep}, got "
                         f"{tuple(x.shape)}")
    return all_to_all_axis(_masked(x, local_count), "ep", 0, 0)


def global_scatter(x, local_count, global_count, group=None):
    """This rank's buckets ``x`` [n_expert, capacity, d] to the ep ranks
    that own their experts (reference ``global_scatter_op.cc``)."""
    return _a2a(x, local_count)


def global_gather(x, local_count, global_count, group=None):
    """The inverse of :func:`global_scatter`: the experts' outputs back to
    the ranks their tokens came from (reference ``global_gather_op.cc``)."""
    return _a2a(x, local_count)
