"""Shape, layout and indexing (port of ``paddle_tpu/ops/manipulation.py``).

Paddle's rules where torch's differ: ``split(x, 3)`` means three equal
parts (``torch.split`` takes a part's size); ``slice(x, axes, starts,
ends)`` clamps like a Python slice; ``squeeze(x, axis)`` leaves a dim
that is not 1; ``expand`` keeps a dim given as ``-1``; ``gather`` is an
``index_select`` along ``axis`` of the flattened index; ``flatten``'s
axes default to ``0, -1``; ``argsort(descending=True)`` is the ascending
stable order reversed (the JAX package's), so equal keys come out last
index first; ``topk``, ``argsort`` and ``nonzero`` give int64 indices.
"""
from __future__ import annotations

import builtins

import torch
import torch.nn.functional as F

from ..framework import dtype as dtype_mod

__all__ = ["cast", "astype", "reshape", "transpose", "t", "flatten",
           "squeeze", "unsqueeze", "concat", "stack", "split", "chunk",
           "unbind", "tile", "expand", "broadcast_to", "expand_as",
           "broadcast_tensors", "flip", "roll", "rot90", "gather",
           "gather_nd", "take_along_axis", "put_along_axis", "scatter",
           "scatter_nd_add", "scatter_nd", "index_select", "index_sample",
           "where", "nonzero", "masked_select", "masked_fill", "topk",
           "argsort", "sort", "unique", "pad", "repeat_interleave",
           "one_hot", "moveaxis", "slice", "numel", "searchsorted",
           "bucketize", "diag_embed", "unique_consecutive", "take",
           "index_add", "index_put", "diagonal", "kthvalue", "mode",
           "strided_slice", "unstack", "crop", "reverse", "shard_index",
           "multiplex", "as_real", "as_complex"]


def _ints(v):
    if isinstance(v, torch.Tensor):
        v = v.tolist()
    if isinstance(v, (list, tuple)):
        return [int(e.item() if isinstance(e, torch.Tensor) else e)
                for e in v]
    return [int(v)]


def _long(index):
    return index if index.dtype == torch.int64 else index.long()


def cast(x, dtype):
    return x.to(dtype_mod.convert_dtype(dtype))


astype = cast


def reshape(x, shape, name=None):
    return torch.reshape(x, _ints(shape))


def transpose(x, perm, name=None):
    return x.permute(_ints(perm))


def t(x, name=None):
    return x.clone() if x.dim() < 2 else x.transpose(0, 1)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return torch.flatten(x, int(start_axis), int(stop_axis))


def squeeze(x, axis=None, name=None):
    """Drops the given dims of size 1 (every one for ``None``); a given dim
    of another size stays."""
    if axis is None:
        return torch.squeeze(x)
    dims = tuple(a % builtins.max(x.dim(), 1) for a in _ints(axis))
    dims = tuple(d for d in dims if x.dim() and x.shape[d] == 1)
    return torch.squeeze(x, dims) if dims else x


def unsqueeze(x, axis, name=None):
    """A dim of size 1 at each of ``axis``, positions in the result."""
    axes = _ints(axis)
    nd = x.dim() + len(axes)
    out = x
    for a in sorted(a % nd for a in axes):
        out = out.unsqueeze(a)
    return out


def concat(x, axis=0, name=None):
    return torch.cat(list(x), dim=_ints(axis)[0])


def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """An int: that many equal parts; a list: parts of those sizes, one
    ``-1`` taking the rest."""
    axis = _ints(axis)[0]
    if isinstance(num_or_sections, (list, tuple)):
        sections = _ints(num_or_sections)
        if -1 in sections:
            known = builtins.sum(s for s in sections if s != -1)
            sections[sections.index(-1)] = x.shape[axis] - known
        return list(torch.split(x, sections, dim=axis))
    n = int(num_or_sections)
    if x.shape[axis] % n:
        raise ValueError(f"split: dim {axis} of size {x.shape[axis]} does "
                         f"not divide into {n} equal parts")
    return list(torch.split(x, x.shape[axis] // n, dim=axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, int(chunks), axis)


def unbind(x, axis=0):
    return list(torch.unbind(x, int(axis)))


def tile(x, repeat_times, name=None):
    return torch.tile(x, _ints(repeat_times))


def expand(x, shape, name=None):
    return x.expand(_ints(shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return x.expand(y.shape)


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis, name=None):
    return torch.flip(x, _ints(axis))


def roll(x, shifts, axis=None, name=None):
    """Along ``axis``; ``None``: over the flattened tensor."""
    shifts = _ints(shifts) if isinstance(shifts, (list, tuple)) else \
        int(shifts)
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, _ints(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, int(k), _ints(axes))


def gather(x, index, axis=0, name=None):
    """Rows of ``x`` along ``axis`` at the (flattened) ``index``."""
    return torch.index_select(x, _ints(axis)[0], _long(index.reshape(-1)))


def gather_nd(x, index, name=None):
    """``index [..., k]`` picks along the first ``k`` dims of ``x``."""
    return x[tuple(_long(index).movedim(-1, 0))]


def take_along_axis(arr, indices, axis, broadcast=True):
    return torch.take_along_dim(arr, _long(indices), int(axis))


def put_along_axis(arr, indices, values, axis, reduce="assign"):
    """``assign`` scatters; ``add``, ``mul``/``multiply``, ``amin``,
    ``amax`` and ``mean`` combine with the value already there (``mean``
    averages it with every value scattered onto it)."""
    axis = int(axis)
    idx = _long(indices)
    if not isinstance(values, torch.Tensor):
        values = torch.tensor(values, dtype=arr.dtype, device=arr.device)
    values = values.to(arr.dtype).expand(idx.shape)
    if reduce == "assign":
        return arr.scatter(axis, idx, values)
    if reduce == "add":
        return arr.scatter_add(axis, idx, values)
    how = {"mul": "prod", "multiply": "prod", "amin": "amin",
           "amax": "amax", "mean": "mean"}.get(reduce)
    if how is None:
        raise ValueError(f"put_along_axis: unsupported reduce {reduce!r}")
    return arr.scatter_reduce(axis, idx, values, how, include_self=True)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to (``overwrite``) or increased by
    ``updates``."""
    index = _long(index.reshape(-1))
    if overwrite:
        return x.index_copy(0, index, updates.to(x.dtype))
    return x.index_add(0, index, updates.to(x.dtype))


def scatter_nd_add(x, index, updates, name=None):
    return x.index_put(tuple(_long(index).movedim(-1, 0)), updates,
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    zeros = torch.zeros(_ints(shape), dtype=updates.dtype,
                        device=updates.device)
    return scatter_nd_add(zeros, index, updates)


def index_select(x, index, axis=0, name=None):
    return torch.index_select(x, int(axis), _long(index))


def index_sample(x, index):
    return torch.take_along_dim(x, _long(index), 1)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return torch.where(condition, x, y)


def nonzero(x, as_tuple=False):
    return torch.nonzero(x, as_tuple=bool(as_tuple))


def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask)


def masked_fill(x, mask, value, name=None):
    v = value.item() if isinstance(value, torch.Tensor) else value
    return x.masked_fill(mask, v)


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """(values, int64 indices) of the ``k`` largest (smallest) along
    ``axis``."""
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    return torch.topk(x, k, dim=int(axis), largest=bool(largest),
                      sorted=bool(sorted))


def argsort(x, axis=-1, descending=False, name=None):
    idx = torch.argsort(x, dim=int(axis), stable=True)
    return idx.flip(int(axis)) if descending else idx


def sort(x, axis=-1, descending=False, name=None):
    out = torch.sort(x, dim=int(axis), stable=True).values
    return out.flip(int(axis)) if descending else out


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """Sorted unique values (of the flattened tensor for ``axis`` None),
    then as asked: the first index of each, the inverse map (of ``x``'s
    shape for ``axis`` None, as numpy 2's ``unique`` gives it to the JAX
    package), the counts."""
    dim = None if axis is None else int(axis)
    src = x.reshape(-1) if dim is None else x
    out, inverse, counts = torch.unique(src, sorted=True,
                                        return_inverse=True,
                                        return_counts=True, dim=dim)
    idt = dtype_mod.convert_dtype(dtype)
    res = [out]
    if return_index:
        n = src.shape[0 if dim is None else dim]
        pos = torch.arange(n, device=x.device)
        first = torch.full((out.shape[0 if dim is None else dim],), n,
                           dtype=torch.int64, device=x.device)
        res.append(first.scatter_reduce(0, inverse, pos, "amin").to(idt))
    if return_inverse:  # x's shape for axis None (numpy 2's unique)
        res.append((inverse.reshape(x.shape) if dim is None else
                    inverse).to(idt))
    if return_counts:
        res.append(counts.to(idt))
    return res[0] if len(res) == 1 else tuple(res)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad`` of ``2 * x.ndim`` entries pads every dim, in dim order
    ``[d0_lo, d0_hi, d1_lo, ...]``; a shorter one pads the last
    ``len(pad) // 2`` dims, the first pair for the last dim (torch's
    ``F.pad`` order). Modes: constant, reflect, replicate, circular."""
    pad = _ints(pad)
    if len(pad) == 2 * x.dim():
        pairs = [pad[2 * i: 2 * i + 2] for i in range(x.dim())]
        pad = [p for pair in reversed(pairs) for p in pair]
    if mode == "constant":
        return F.pad(x, pad, mode="constant", value=float(value))
    return F.pad(x, pad, mode=mode)


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(
        x, repeats, dim=None if axis is None else int(axis))


def one_hot(x, num_classes, name=None):
    """One-hot rows in the default float dtype."""
    return F.one_hot(_long(x), int(num_classes)).to(
        dtype_mod.get_default_dtype())


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source if isinstance(source, int) else
                         tuple(source), destination if isinstance(
                             destination, int) else tuple(destination))


def slice(x, axes, starts, ends):
    """``x[starts[i]:ends[i]]`` along each of ``axes``, clamped as a Python
    slice clamps."""
    sl = [builtins.slice(None)] * x.dim()
    for ax, st, en in zip(_ints(axes), _ints(starts), _ints(ends)):
        sl[ax] = builtins.slice(st, en)
    return x[tuple(sl)]


def numel(x, name=None):
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    return torch.searchsorted(sorted_sequence, values,
                              out_int32=bool(out_int32), right=bool(right))


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def diag_embed(input, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(input, int(offset), int(dim1), int(dim2))


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Runs of equal values (slices along ``axis``) kept once; the inverse
    map is over the flattened tensor for ``axis`` None."""
    dim = None if axis is None else int(axis)
    src = x.reshape(-1) if dim is None else x
    out, inverse, counts = torch.unique_consecutive(
        src, return_inverse=True, return_counts=True, dim=dim)
    idt = dtype_mod.convert_dtype(dtype)
    res = [out]
    if return_inverse:
        res.append(inverse.to(idt))
    if return_counts:
        res.append(counts.to(idt))
    return res[0] if len(res) == 1 else tuple(res)


def take(x, index, mode="raise", name=None):
    """Elements of the flattened ``x``: ``raise`` checks the ids on the
    host (one readback) and wraps negative ones, ``wrap`` takes them
    modulo the size, ``clip`` clamps."""
    if mode not in ("raise", "wrap", "clip"):
        raise ValueError("mode must be raise/wrap/clip")
    flat = x.reshape(-1)
    n = flat.shape[0]
    idx = _long(index)
    if mode == "raise":
        if idx.numel():
            lo, hi = (int(v) for v in torch.stack(
                [idx.min(), idx.max()]).tolist())
            if lo < -n or hi >= n:
                raise IndexError(
                    f"take: index out of range for tensor with {n} "
                    f"elements (got min {lo}, max {hi})")
        idx = torch.where(idx < 0, idx + n, idx)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        idx = idx.clamp(0, n - 1)
    return flat[idx]


def index_add(x, index, axis, value, name=None):
    return x.index_add(int(axis), _long(index), value)


def index_put(x, indices, value, accumulate=False, name=None):
    return x.index_put(tuple(indices), value, accumulate=bool(accumulate))


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, int(offset), int(axis1), int(axis2))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """(the ``k``-th smallest value, its int64 index) along ``axis``."""
    return tuple(torch.kthvalue(x, int(k), int(axis), bool(keepdim)))


def mode(x, axis=-1, keepdim=False, name=None):
    """(the most frequent value, the index of its last occurrence)."""
    axis = int(axis) % x.dim()
    xm = x.movedim(axis, -1)
    sx = torch.sort(xm, dim=-1).values
    counts = (sx[..., :, None] == sx[..., None, :]).sum(-1)
    best = torch.argmax(counts, dim=-1, keepdim=True)
    val = torch.take_along_dim(sx, best, -1)[..., 0]
    pos = torch.arange(xm.shape[-1], device=x.device)
    idx = torch.where(xm == val[..., None], pos, -1).amax(-1)
    if keepdim:
        val, idx = val.unsqueeze(axis), idx.unsqueeze(axis)
    return val, idx


def strided_slice(x, axes, starts, ends, strides, name=None):
    sl = [builtins.slice(None)] * x.dim()
    for ax, st, en, sr in zip(_ints(axes), _ints(starts), _ints(ends),
                              _ints(strides)):
        sl[ax] = builtins.slice(st, en, sr)
    return x[tuple(sl)]


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(x, int(axis)))


def crop(x, shape=None, offsets=None, name=None):
    """The box at ``offsets`` (default 0) of lengths ``shape`` (-1: to the
    end)."""
    offsets = [0] * x.dim() if offsets is None else _ints(offsets)
    if shape is None:
        lengths = [int(d) - o for d, o in zip(x.shape, offsets)]
    else:
        lengths = [int(x.shape[i]) - offsets[i] if n == -1 else n
                   for i, n in enumerate(_ints(shape))]
    return x[tuple(builtins.slice(o, o + n)
                   for o, n in zip(offsets, lengths))]


def reverse(x, axis, name=None):
    return flip(x, axis)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    shard_size = (int(index_num) + int(nshards) - 1) // int(nshards)
    inside = torch.div(input, shard_size, rounding_mode="floor") == \
        int(shard_id)
    return torch.where(inside, torch.remainder(input, shard_size),
                       torch.full_like(input, int(ignore_value)))


def multiplex(inputs, index, name=None):
    """Row ``r`` from ``inputs[index[r]]``."""
    stacked = torch.stack(list(inputs))
    rows = torch.arange(inputs[0].shape[0], device=stacked.device)
    return stacked[_long(index.reshape(-1)), rows]


def as_real(x, name=None):
    return torch.view_as_real(x)


def as_complex(x, name=None):
    return torch.view_as_complex(x.contiguous())
