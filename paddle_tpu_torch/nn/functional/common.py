"""Common functionals (port of ``paddle_tpu/nn/functional/common.py``):
``linear`` (paddle's ``[in, out]`` weight), ``embedding`` (with the
out-of-vocabulary policy), ``layer_norm``, ``normalize``,
``cosine_similarity``, ``bilinear``, ``pad``, ``dropout`` (``:112-127``),
and (``:217-540``) ``batch_norm``, ``group_norm``, ``instance_norm``,
``conv1d``, ``conv2d``, ``conv2d_transpose``, ``max_pool2d``,
``avg_pool2d``, ``adaptive_avg_pool2d``, ``adaptive_max_pool2d`` and
``local_response_norm``. The rest of that file (interpolation, unfold,
the 1-D and 3-D pools and convs, unpooling) is not ported yet.

The JAX package draws each keep mask with ``jax.random.bernoulli`` from
the framework's key stream. Here the mask comes from an explicit
``torch.Generator`` (``torch.rand(..., generator=g) < 1 - p``), which a
model owns and hands to every dropout it holds, so that a seed fixes every
mask and a captured CUDA graph can register the generator's state (each
replay then draws fresh masks). Without a generator torch's default one for
the tensor's device is used.

Activation checkpointing runs a layer's forward twice. :func:`rewinding`
makes the two runs draw the same masks, as ``jax.checkpoint`` replays its
key: the first run notes each generator's state (16 bytes on CUDA), every later
run sets the generator back to it and, when done, forward again to where
it was. So recompute keeps no mask and equals the run without it, and
nested regions rewind through their outer region's rewound state.

Inside a CUDA graph capture a generator's state can be neither read nor
copied. There the ``j``-th rewind of a step draws from a twin generator
instead, registered with the graph and set before each replay to where
the same rewind started in an eager run of the step: the generator's
offset then plus the offset the region had reached since the step began
(:class:`Rewinds`, which ``jit.TrainStep`` records in its eager warm-up
step and arms before each replay).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as TF

from ...framework.flags import EMBEDDING_OOV_POLICIES, flag
from ...ops.linalg import linear_out_in

__all__ = ["dropout", "keep_mask", "rewinding", "Rewinds",
           "drawing_generator", "linear", "embedding", "layer_norm",
           "normalize", "cosine_similarity", "bilinear", "pad",
           "batch_norm", "group_norm", "instance_norm", "conv1d", "conv2d",
           "conv2d_transpose", "max_pool2d", "avg_pool2d",
           "adaptive_avg_pool2d", "adaptive_max_pool2d",
           "local_response_norm"]


def drawing_generator(generator: Optional[torch.Generator],
                      device) -> torch.Generator:
    """The generator a draw on ``device`` takes: ``generator``, or torch's
    default one for that device."""
    if generator is not None:
        return generator
    device = torch.device(device)
    if device.type == "cuda":
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        return torch.cuda.default_generators[index]
    return torch.default_generator


def _capturing(g: torch.Generator) -> bool:
    return g.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class Rewinds:
    """One CUDA generator's rewinds in one step, for a CUDA graph.

    ``record()`` before an eager run of the step and ``stop()`` after it
    give ``offsets``: for each rewind of the step, in order, the
    generator's offset at its region's first run less its offset when the
    step began. ``capture(twins)`` hands the twins to the regions of the
    captured step, in the same order; ``arm(twins, offsets)`` sets each
    twin to the generator's seed and present offset plus its rewind's, so
    that a replay draws what the eager step would."""

    # by id(generator); each entry holds its generator, so the id stays
    # its own (a CUDA generator takes no weak reference)
    _by_id: Dict[int, "Rewinds"] = {}

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.start: Optional[int] = None
        self.offsets: Optional[List[int]] = None
        self.twins: Optional[List[torch.Generator]] = None
        self.next = 0

    @classmethod
    def of(cls, generator: torch.Generator) -> "Rewinds":
        r = cls._by_id.get(id(generator))
        if r is None:
            r = cls._by_id[id(generator)] = cls(generator)
        return r

    @classmethod
    def find(cls, generator: torch.Generator) -> Optional["Rewinds"]:
        return cls._by_id.get(id(generator))

    def record(self):
        self.start = self.generator.get_offset()
        self.offsets = []

    def stop(self) -> List[int]:
        offsets, self.start, self.offsets = self.offsets, None, None
        return offsets

    def capture(self, twins: Optional[List[torch.Generator]]) -> int:
        """Hands ``twins`` to the regions of the capture that follows
        (``None`` once it is over); returns how many twins the capture
        before took."""
        used = self.next if self.twins is not None else 0
        self.twins, self.next = twins, 0
        return used

    def arm(self, twins: Sequence[torch.Generator], offsets: Sequence[int]):
        seed, offset = self.generator.initial_seed(), \
            self.generator.get_offset()
        for t, d in zip(twins, offsets):
            t.manual_seed(seed)
            t.set_offset(offset + d)


def _mark(g: torch.Generator):
    """What a region's first run notes of ``g``: its state, and its offset
    since a recorded step began (``None`` inside a capture)."""
    if _capturing(g):
        return None
    r = Rewinds.find(g)
    since = None
    if r is not None and r.offsets is not None:
        since = g.get_offset() - r.start
    return g.get_state(), since


@contextlib.contextmanager
def _rewound(g: torch.Generator, mark):
    if _capturing(g):
        r = Rewinds.find(g)
        if r is None or r.twins is None or r.next >= len(r.twins):
            raise RuntimeError(
                "a checkpointed region rewinds inside a CUDA graph capture "
                "that its eager step did not record (capture through "
                "jit.TrainStep)")
        twin = r.twins[r.next]
        r.next += 1
        prev = g.graphsafe_get_state()
        g.graphsafe_set_state(twin)
        try:
            yield
        finally:
            g.graphsafe_set_state(prev)
        return
    state, since = mark
    r = Rewinds.find(g)
    if r is not None and r.offsets is not None:
        r.offsets.append(since)
    prev = g.get_state()
    g.set_state(state)
    try:
        yield
    finally:
        g.set_state(prev)


def rewinding(fn, generators: Sequence[torch.Generator]):
    """``fn`` as the function to hand to ``torch.utils.checkpoint``
    (``preserve_rng_state=False``): every call after the first draws from
    each of ``generators`` what the first call drew, and leaves it where it
    was. A fresh wrapper for each checkpointed call."""
    gens = list(generators)
    if not gens:
        return fn
    marks = []

    def run(*args):
        if not marks:
            marks.append([_mark(g) for g in gens])
            return fn(*args)
        with contextlib.ExitStack() as stack:
            for g, m in zip(gens, marks[0]):
                stack.enter_context(_rewound(g, m))
            return fn(*args)
    return run


def keep_mask(shape, p: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """A bool mask, True with probability ``1 - p`` per element: the JAX
    ``jax.random.bernoulli(key, 1 - p, shape)``, drawn as fp32 uniforms
    from ``generator`` below ``1 - p``."""
    u = torch.rand(tuple(shape), generator=generator, device=device,
                   dtype=torch.float32)
    return u < 1.0 - float(p)


def _scalar(value, dtype):
    """``value`` rounded to ``dtype``, as the JAX package rounds a Python
    float beside an array of that dtype (torch would keep it in fp32)."""
    return torch.tensor(value, dtype=dtype)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator: Optional[torch.Generator] = None):
    """``upscale_in_train``: ``where(keep, x / (1 - p), 0)`` in training,
    ``x`` otherwise; ``downscale_in_infer``: ``where(keep, x, 0)`` in
    training, ``x * (1 - p)`` otherwise. ``p == 0`` in training returns
    ``x``. ``axis`` (a mask shared along axes) is not ported: the JAX
    package's ``dropout`` draws an elementwise mask whatever it says."""
    if axis is not None:
        raise NotImplementedError("dropout: axis is not ported (the JAX "
                                  "package draws an elementwise mask)")
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p must be in [0, 1], got {p}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * _scalar(1.0 - p, x.dtype)
        return x
    keep = keep_mask(x.shape, p, generator, x.device)
    if mode == "upscale_in_train":
        return torch.where(keep, x / _scalar(1.0 - p, x.dtype),
                           x.new_zeros(()))
    return torch.where(keep, x, x.new_zeros(()))


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with paddle's ``[in, out]`` weight; mixed
    float operands promote as in the JAX ``jnp.matmul(x, w) + b``."""
    return linear_out_in(x, weight.t(), bias)


def _capturing_on(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and \
        torch.cuda.is_current_stream_capturing()


def embedding(x, weight, padding_idx=None, sparse=False, name=None,
              oov_policy=None):
    """Rows of ``weight`` at the ids ``x``; the rows at ``padding_idx`` are
    zero and pass no gradient.

    The out-of-vocabulary policy (``FLAGS_embedding_oov_policy``, or
    ``oov_policy`` for this call), as in
    ``paddle_tpu/nn/functional/common.py:57-100``:

    - ``'error'``: an eager call reads the ids' min and max back (one
      readback for both) and raises ``ValueError`` on an id outside
      ``[0, rows)``. Under a CUDA graph capture nothing can be read back,
      and an id past the table would fire a device-side assert that
      leaves the CUDA context unusable; there the ids are clamped to the
      table, unchecked. (The JAX package's traced path is unchecked too,
      but its ``jnp.take`` under jax 0.9.0 returns NaN rows for ids
      ``>= rows`` or ``< -rows`` and wraps ids in ``[-rows, 0)``; a clamp
      is what the port can do without a NaN poisoning the step.)
    - ``'clip'``: the ids are clamped to ``[0, rows - 1]`` everywhere.

    ``sparse`` is taken and has no effect (the gradient is dense)."""
    policy = oov_policy or flag("embedding_oov_policy")
    if policy not in EMBEDDING_OOV_POLICIES:
        raise ValueError(f"embedding oov_policy must be 'error' or 'clip', "
                         f"got {policy!r}")
    n = weight.shape[0]
    ids = x if x.dtype in (torch.int32, torch.int64) else x.long()
    if policy == "clip" or _capturing_on(ids):
        ids = ids.clamp(0, n - 1)
    elif ids.numel():
        lo, hi = (int(v) for v in torch.stack([ids.min(), ids.max()])
                  .tolist())
        if lo < 0 or hi >= n:
            raise ValueError(
                f"embedding: id out of range [0, {n}) (min={lo}, max={hi}); "
                f"pass oov_policy='clip' or set "
                f"FLAGS_embedding_oov_policy='clip' for the clamped lookup")
    out = TF.embedding(ids, weight)
    if padding_idx is not None:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5,
               name=None):
    """Normalised over the trailing ``normalized_shape`` dims (biased
    variance), then ``* weight + bias``."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    return TF.layer_norm(x, list(normalized_shape), weight, bias,
                         float(epsilon))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x / max(||x||_p, epsilon)`` along ``axis``."""
    p = float(p)
    norm = torch.pow(torch.sum(torch.pow(torch.abs(x), p), dim=int(axis),
                               keepdim=True), 1.0 / p)
    return x / torch.clamp(norm, min=float(epsilon))


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    """``sum(x1 * x2) / max(||x1|| * ||x2||, eps)`` along ``axis``."""
    axis = int(axis)
    dot = torch.sum(x1 * x2, dim=axis)
    n1 = torch.sqrt(torch.sum(torch.square(x1), dim=axis))
    n2 = torch.sqrt(torch.sum(torch.square(x2), dim=axis))
    return dot / torch.clamp(n1 * n2, min=float(eps))


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[n, o] = x1[n, i] weight[o, i, j] x2[n, j] + bias``."""
    out = torch.einsum("ni,oij,nj->no", x1, weight, x2)
    return out if bias is None else out + bias


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ...ops.manipulation import pad as _pad

    return _pad(x, pad, mode, value, data_format)


# -- normalisation over batches, groups and instances --------------------------

def _channel_shape(x, axis):
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]
    return shape


def _affine(xn, weight, bias, shape):
    if weight is not None:
        xn = xn * weight.reshape(shape)
    if bias is not None:
        xn = xn + bias.reshape(shape)
    return xn


def batch_norm(x, running_mean, running_var, weight, bias, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW",
               use_global_stats=None, name=None):
    """Batch normalisation over every axis but the channel one (1 for
    ``NC*`` formats, the last for ``N*C``), as
    ``paddle_tpu/nn/functional/common.py:217-253``.

    With the batch's statistics (``training`` and no ``use_global_stats``)
    the mean and the BIASED variance of the batch normalise it, and the
    running buffers move in place by paddle's momentum: ``running = m *
    running + (1 - m) * batch`` (so ``m`` is the share kept, the opposite
    of torch's ``momentum``), the variance's buffer too from the biased
    variance, as paddle's kernel does. The buffers are written with
    ``copy_`` into their own storage, so a CUDA graph captures the update.
    torch's ``F.batch_norm`` would move them by the unbiased variance and
    its own momentum, so it is not called. Otherwise the running buffers
    normalise."""
    axis = 1 if data_format.startswith("NC") else x.dim() - 1
    if use_global_stats is None:
        use_global_stats = not training
    shape = _channel_shape(x, axis)
    if use_global_stats:
        xn = (x - running_mean.reshape(shape)) * torch.rsqrt(
            running_var.reshape(shape) + epsilon)
        return _affine(xn, weight, bias, shape)
    axes = tuple(i for i in range(x.dim()) if i != axis)
    mean = torch.mean(x, dim=axes)
    centred = x - mean.reshape(shape)
    var = torch.mean(centred * centred, dim=axes)
    xn = centred * torch.rsqrt(var.reshape(shape) + epsilon)
    if running_mean is not None:
        m = float(momentum)
        with torch.no_grad():
            running_mean.copy_(m * running_mean + (1 - m) * mean)
            running_var.copy_(m * running_var + (1 - m) * var)
    return _affine(xn, weight, bias, shape)


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW", name=None):
    """Normalisation over each group of ``C / num_groups`` channels and the
    spatial dims (biased variance), then the per-channel affine; NC*
    layout (the JAX function reads channels from dim 1 whatever
    ``data_format`` says)."""
    n, c = x.shape[0], x.shape[1]
    g = int(num_groups)
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    mean = torch.mean(xg, dim=axes, keepdim=True)
    centred = xg - mean
    var = torch.mean(centred * centred, dim=axes, keepdim=True)
    xn = (centred * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine(xn, weight, bias, [1, c] + [1] * (x.dim() - 2))


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channel normalised over its spatial dims (biased
    variance), then the per-channel affine. The running buffers are
    neither read nor moved, as in the JAX function."""
    axes = tuple(range(2, x.dim()))
    mean = torch.mean(x, dim=axes, keepdim=True)
    centred = x - mean
    var = torch.mean(centred * centred, dim=axes, keepdim=True)
    xn = centred * torch.rsqrt(var + eps)
    return _affine(xn, weight, bias, [1, x.shape[1]] + [1] * (x.dim() - 2))


# -- convolution ---------------------------------------------------------------
# The JAX convolutions are XLA ops (``lax.conv_general_dilated``), not
# Pallas kernels, so their counterpart here is torch's (cuDNN on the card),
# as cuBLAS is for the plain products.

def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _same_pads(size, k, s, d):
    """XLA's 'SAME' padding of one spatial dim: (lo, hi)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


def _conv_pads(x, weight, padding, stride, dilation):
    """[(lo, hi), (lo, hi)] of a 2-D conv over NCHW ``x`` and OIHW
    ``weight``: 'SAME' / 'VALID', two symmetric pads, or four (top, bottom,
    left, right)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return [(0, 0), (0, 0)]
        if mode != "SAME":
            raise ValueError(f"conv2d: padding {padding!r}")
        return [_same_pads(x.shape[2 + i], weight.shape[2 + i], stride[i],
                           dilation[i]) for i in range(2)]
    pad = _pair(padding)
    if len(pad) == 2:
        return [(pad[0], pad[0]), (pad[1], pad[1])]
    if len(pad) == 4:
        return [(pad[0], pad[1]), (pad[2], pad[3])]
    raise ValueError(f"conv2d: padding {padding!r}")


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution: ``NCHW`` input with an OIHW weight, or ``NHWC``
    input with an HWIO weight (the JAX function's dimension numbers);
    padding an int, two ints, four (top, bottom, left, right), 'SAME'
    (XLA's split: the extra pad at the end) or 'VALID'; the bias added
    after the product."""
    nchw = data_format == "NCHW"
    if not nchw:
        x = x.permute(0, 3, 1, 2)
        weight = weight.permute(3, 2, 0, 1)
    st, dl = _pair(stride), _pair(dilation)
    (t, b), (lft, r) = _conv_pads(x, weight, padding, st, dl)
    if t == b and lft == r:
        out = TF.conv2d(x, weight, None, st, (t, lft), dl, int(groups))
    else:
        out = TF.conv2d(TF.pad(x, (lft, r, t, b)), weight, None, st, 0, dl,
                        int(groups))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out if nchw else out.permute(0, 2, 3, 1)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution over NCL with an OIL weight, symmetric int padding,
    the bias added after the product."""
    out = TF.conv1d(x, weight, None, int(stride), int(padding),
                    int(dilation), int(groups))
    if bias is not None:
        out = out + bias.reshape(1, -1, 1)
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     data_format="NCHW", output_size=None, name=None):
    """The transposed 2-D convolution with paddle's ``[in, out / groups,
    kh, kw]`` weight: ``out = (H - 1) s - 2 p + d (k - 1) + 1 + op``.
    ``output_size`` picks ``op`` (and raises where it is out of ``[0,
    s)`` or where ``output_padding`` is set too); ``NHWC`` is computed in
    NCHW and transposed at the edges, as the JAX function does."""
    if data_format == "NHWC":
        out = conv2d_transpose(x.permute(0, 3, 1, 2), weight, bias, stride,
                               padding, output_padding, groups, dilation,
                               "NCHW", output_size)
        return out.permute(0, 2, 3, 1)
    if data_format != "NCHW":
        raise ValueError(f"conv2d_transpose: bad data_format {data_format!r}")
    st, pd, dl = _pair(stride), _pair(padding), _pair(dilation)
    op = _pair(output_padding)
    if output_size is not None:
        if op != (0, 0):
            raise ValueError(
                "output_padding and output_size can not be both set")
        if isinstance(output_size, torch.Tensor):
            output_size = output_size.tolist()
        osz = _pair(output_size)
        op = tuple(osz[i] - ((x.shape[2 + i] - 1) * st[i] - 2 * pd[i] +
                             dl[i] * (weight.shape[2 + i] - 1) + 1)
                   for i in range(2))
        for i in range(2):
            if not 0 <= op[i] < st[i]:
                raise ValueError(
                    f"output_size[{i}]={osz[i]} is out of the legal range "
                    f"[min, min+stride) for the given input/kernel/stride")
    out = TF.conv_transpose2d(x, weight, None, st, pd, op, int(groups), dl)
    if bias is not None:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


# -- pooling -------------------------------------------------------------------

def _to_nchw(x, data_format):
    return x if data_format == "NCHW" else x.permute(0, 3, 1, 2)


def _from_nchw(x, data_format):
    return x if data_format == "NCHW" else x.permute(0, 2, 3, 1)


def _fits(ks, pd):
    """torch's pooling takes a pad of at most half the window."""
    return all(p <= k // 2 for k, p in zip(ks, pd))


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    """The max over each window, padding counting as -inf. As in the JAX
    function the output size is ``floor((H + 2p - k) / s) + 1``:
    ``ceil_mode`` is taken and has no effect (ROADMAP's oracle caveats).
    ``return_mask`` (NCHW) adds each window's argmax as an int32 index
    into the input's flattened H * W, the first of equal values (-1 where
    the window's max is -inf, a window of padding alone)."""
    ks = _pair(kernel_size)
    st = _pair(stride) if stride is not None else ks
    pd = _pair(padding)
    if return_mask and data_format != "NCHW":
        raise ValueError("max_pool2d return_mask requires NCHW")
    xc = _to_nchw(x, data_format)
    w = xc.shape[3]
    if not _fits(ks, pd):
        xc = TF.pad(xc, (pd[1], pd[1], pd[0], pd[0]), value=float("-inf"))
    res = TF.max_pool2d(xc, ks, st, pd if _fits(ks, pd) else 0,
                        return_indices=return_mask)
    if not return_mask:
        return _from_nchw(res, data_format)
    out, idx = res
    if not _fits(ks, pd):  # an index into the padded plane: move it back
        wp = w + 2 * pd[1]
        idx = (idx // wp - pd[0]) * w + idx % wp - pd[1]
    # a window whose max is -inf (all padding) has no argmax: -1, as JAX's
    idx = torch.where(out == float("-inf"), -1, idx)
    return out, idx.to(torch.int32)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """The mean of each window: over the window's size when
    ``exclusive=False`` or nothing is padded, else over the window's
    positions inside the input. ``ceil_mode`` and ``divisor_override``
    are taken and have no effect, as in the JAX function."""
    ks = _pair(kernel_size)
    st = _pair(stride) if stride is not None else ks
    pd = _pair(padding)
    xc = _to_nchw(x, data_format)
    include = (not exclusive) or all(p == 0 for p in pd)
    if _fits(ks, pd):
        out = TF.avg_pool2d(xc, ks, st, pd, count_include_pad=include)
    else:
        xp = TF.pad(xc, (pd[1], pd[1], pd[0], pd[0]))
        out = TF.avg_pool2d(xp, ks, st, 0)
        if not include:
            ones = TF.pad(torch.ones_like(xc[:1, :1]),
                          (pd[1], pd[1], pd[0], pd[0]))
            share = TF.avg_pool2d(ones, ks, st, 0)
            out = out / share
    return _from_nchw(out, data_format)


def _adaptive_bins(size, out):
    """Adaptive pooling's bin edges (torch's and paddle's): bin i covers
    ``[floor(i s / o), ceil((i + 1) s / o))``."""
    return [(i * size // out, -(-(i + 1) * size // out)) for i in range(out)]


def _adaptive_pool2d(x, out_hw, reduce):
    """NCHW; ``reduce(v, dims)``: one reshape and reduction when the bins
    divide the input, else one reduction per bin (the JAX formulation:
    means and maxima over slices, whose backward is deterministic on the
    card, unlike torch's adaptive pooling)."""
    n, c, h, w = x.shape
    oh, ow = out_hw
    if h % oh == 0 and w % ow == 0:
        return reduce(x.reshape(n, c, oh, h // oh, ow, w // ow), (3, 5))
    rows = []
    for hs, he in _adaptive_bins(h, oh):
        rows.append(torch.stack([reduce(x[:, :, hs:he, ws:we], (2, 3))
                                 for ws, we in _adaptive_bins(w, ow)],
                                dim=-1))
    return torch.stack(rows, dim=-2)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """The mean over each adaptive bin of an NCHW input (the JAX function
    reads NCHW whatever ``data_format`` says)."""
    return _adaptive_pool2d(x, _pair(output_size),
                            lambda v, dims: torch.mean(v, dim=dims))


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """The max over each adaptive bin of an NCHW input; ``return_mask``
    adds each bin's argmax (first of equal values) as an int32 index into
    the flattened H * W."""
    hw = _pair(output_size)
    out = _adaptive_pool2d(x, hw, lambda v, dims: torch.amax(v, dim=dims))
    if not return_mask:
        return out
    n, c, h, w = x.shape
    rows = []
    for hs, he in _adaptive_bins(h, hw[0]):
        cols = []
        for ws, we in _adaptive_bins(w, hw[1]):
            flat = torch.argmax(x[:, :, hs:he, ws:we].reshape(n, c, -1),
                                dim=-1)
            cols.append((hs + flat // (we - ws)) * w + ws + flat % (we - ws))
        rows.append(torch.stack(cols, dim=-1))
    return out, torch.stack(rows, dim=-2).to(torch.int32)


def _lrn(x, size, alpha, beta, k, lo):
    """``x / (k + alpha * s)^beta``, ``s`` the sum of squares over ``size``
    channels (dim 1): ``lo`` before each channel, the rest after."""
    sq = TF.pad(x * x, (0, 0) * (x.dim() - 2) + (lo, size - 1 - lo))
    c = x.shape[1]
    acc = sq[:, 0:c]
    for i in range(1, size):
        acc = acc + sq[:, i:i + c]
    return x / torch.pow(k + alpha * acc, beta)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """AlexNet's LRN across channels as the JAX function computes it: the
    window ``(size - 1) // 2`` channels before each channel and the rest
    after, the sum not divided by ``size``. (The JAX
    ``LocalResponseNorm`` layer puts ``size // 2`` before:
    ``nn.LocalResponseNorm`` follows it.)"""
    return _lrn(x, size, alpha, beta, k, (size - 1) // 2)
