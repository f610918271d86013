"""Fused multi-tensor optimizer update: clip, decay and the rule of each of
the JAX package's optimizers over every parameter of a step in a few kernel
launches, and the gradient scaler's finiteness test and unscale.

Counterpart of what the JAX package gets from XLA: ``Optimizer._get_fused``
(``paddle_tpu/optimizer/optimizer.py:117-147``) jits clip, decay and the
rule over all parameters as one function. Here the same update is four
hand-written kernels (``csrc/optimizer.cu``), each beside its plain
version, the per-tensor PyTorch loop:

- :func:`multi_tensor_sumsq`: per-tensor fp32 sums of squares of the
  gradients, their global sum and the clip scales (``ClipGradByNorm``,
  ``ClipGradByGlobalNorm``);
- :func:`adam_update`: Adam (coupled decay) and AdamW (decoupled);
- :func:`adafactor_stats`: Adafactor's ``vr``/``vc`` (or ``v``),
  ``mean(vr)`` per matrix and the parameters' sums of squares;
- :func:`adafactor_update`: Adafactor's clipped update;
- :func:`sgd_update`, :func:`momentum_update`, :func:`adagrad_update`,
  :func:`adamax_update`, :func:`rmsprop_update`, :func:`adadelta_update`:
  the rules computed in the parameter's dtype (``optimizer.py:212-332,
  476-498``), one kernel over a rule id;
- :func:`lamb_update`, :func:`lars_update`: Lamb and LarsMomentum
  (``optimizer.py:335-407``), fp32 with per-tensor norms (two launches);
- :func:`check_finite`, :func:`unscale`: ``GradScaler.unscale_``
  (``paddle_tpu/amp/grad_scaler.py:52-67``), Paddle's
  ``check_finite_and_unscale``.

All take a :class:`StepBatch`, the step's tensors in lists, and read
the learning rate and the step from the header of its table, which is
copied to the device on the stream. A batch lives as long as its tensors'
storage: the optimizer keeps one across steps and only rewrites the
table's header (:meth:`StepBatch.set_step`), so a CUDA graph that captured
the launches reads the step's values at replay. A batch bound to a
device step (:meth:`StepBatch.bind_device_step`, the in-graph
``GradScaler``) has its step and a skip word written from device tensors
on the stream; a skipped update writes nothing. A gradient has its
parameter's dtype, or is fp32 beside a bf16 parameter (the fp32 sums of
``TrainStep.accumulate``), clipped in fp32 and then rounded to bf16 as the
JAX package's updater casts it. A batch whose tensors lie on more
than one device raises when it is made. On a CUDA batch a wrapper
launches its kernel (building the library at first use) or raises: on a
dtype the kernel does not take or a failed build. On a CPU batch it runs
the plain version. The wrappers are module
attributes that the optimizer looks up at call time, so a check can swap
each for its plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from . import _build

__all__ = ["StepBatch", "TensorSplits", "RULES", "multi_tensor_sumsq",
           "multi_tensor_sumsq_plain", "adam_update", "adam_update_plain",
           "adafactor_stats", "adafactor_stats_plain", "adafactor_update",
           "adafactor_update_plain", "sgd_update", "sgd_update_plain",
           "momentum_update", "momentum_update_plain", "adagrad_update",
           "adagrad_update_plain", "adamax_update", "adamax_update_plain",
           "rmsprop_update", "rmsprop_update_plain", "adadelta_update",
           "adadelta_update_plain", "lamb_update", "lamb_update_plain",
           "lars_update", "lars_update_plain", "check_finite",
           "check_finite_plain", "unscale", "unscale_plain",
           "clip_norms_plain", "clip_plain", "FLAT_CHUNK", "TILE_ELEMENTS",
           "MAX_TILE_ROWS", "SEG_COLS", "COUNTS_SUMSQ", "COUNTS_ADAM",
           "COUNTS_ADAFACTOR_STATS", "COUNTS_ADAFACTOR_UPDATE",
           "COUNTS_SGD", "COUNTS_MOMENTUM", "COUNTS_ADAGRAD",
           "COUNTS_ADAMAX", "COUNTS_RMSPROP", "COUNTS_ADADELTA",
           "COUNTS_LAMB", "COUNTS_LARS", "COUNTS_CHECK_FINITE",
           "COUNTS_UNSCALE"]

# the chunk table (csrc/optimizer.cu): a header of HEADER_WORDS int64 words
# (int32 lr bits, step, tensors, chunks, skip, 0), one entry of
# TENSOR_WORDS words per tensor, one word per chunk, one per matrix
HEADER_WORDS = 3
TENSOR_WORDS = 16
(_P, _G, _S0, _S1, _S2, _NUMEL, _COLS, _ROWS, _SPAN, _TILES, _CHUNK_BEGIN,
 _CHUNK_END, _FLAGS, _MAT_BASE, _COL_BASE) = range(15)
_BF16, _DECAY, _VEC, _FACTORED, _GRAD_F32 = 1, 2, 4, 8, 16
FLAT_CHUNK = 65536        # elements a block of a flat tensor
TILE_ELEMENTS = 262144    # about the elements of one row tile (Adafactor)
MAX_TILE_ROWS = 1024      # rows of a tile at most (csrc kMaxTileRows)
SEG_COLS = 6144           # columns per pass of the stats kernel at most
_CLIP_MODES = {"none": 0, "scale": 1, "value": 2}
_DTYPES = (torch.float32, torch.bfloat16)
# the state slots of each rule (the kernels' slot order), every one of the
# parameter's dtype and size as the JAX package's zeros_like(p); Adafactor
# keeps its own (StepBatch._slot_specs). "grads": a batch of gradients
# alone, which the clip's __call__ and the gradient scaler read.
_RULE_SLOTS = {"adam": 2, "sgd": 0, "momentum": 1, "adagrad": 1,
               "adamax": 2, "rmsprop": 3, "adadelta": 2, "lamb": 2,
               "lars": 1, "grads": 0}
RULES = tuple(_RULE_SLOTS) + ("adafactor",)
# pt_opt_rule's rule ids (csrc kSGD..kAdadelta) and pt_opt_norm_rule's
_RULE_IDS = {"sgd": 0, "momentum": 1, "adagrad": 2, "adamax": 3,
             "rmsprop": 4, "adadelta": 5}
_NORM_RULE_IDS = {"lamb": 0, "lars": 1}

COUNTS_SUMSQ = _build.Counts()
COUNTS_ADAM = _build.Counts()
COUNTS_ADAFACTOR_STATS = _build.Counts()
COUNTS_ADAFACTOR_UPDATE = _build.Counts()
COUNTS_SGD = _build.Counts()
COUNTS_MOMENTUM = _build.Counts()
COUNTS_ADAGRAD = _build.Counts()
COUNTS_ADAMAX = _build.Counts()
COUNTS_RMSPROP = _build.Counts()
COUNTS_ADADELTA = _build.Counts()
COUNTS_LAMB = _build.Counts()
COUNTS_LARS = _build.Counts()
COUNTS_CHECK_FINITE = _build.Counts()
COUNTS_UNSCALE = _build.Counts()


class StepBatch:
    """The tensors one optimizer step updates and the chunk table over them.

    ``params`` and ``grads`` are lists of one length; ``slots`` three lists
    of the rule's state (Adam: ``moment1``, ``moment2``, unused; Adafactor:
    ``vr`` or ``v``, ``vc`` or None, ``m`` or None; the other rules as the
    optimizers' ``_slots`` give them, None where a rule keeps fewer);
    ``decay`` the per-tensor weight-decay flags; ``lr`` and ``step`` this
    step's rate and 1-based step number; ``rule`` one of :data:`RULES`
    (Adafactor's tensors of 2+ dimensions are chunked by whole rows; the
    others' by flat chunks; ``"grads"`` keeps no state). Every tensor lies
    on the first parameter's device (ValueError otherwise), so the
    wrappers route the whole batch by that one device.

    The table is built at most once per batch, on the host, and copied to
    the device from pinned memory on the current stream. Inside a CUDA
    graph capture nothing is copied: the capture runs nothing, so the
    whole table is copied by the first :meth:`set_step` after it, outside
    the graph, and no graph reads pinned memory. Its device buffer is then
    one given by :meth:`reserve`, allocated before the capture: a buffer
    from the graph's pool may hold other tensors earlier in the replay,
    which would overwrite the table between that copy and the kernels. A
    batch holds its tensors' pointers: it serves again only for tensors
    at the same addresses (the optimizer compares them).
    """

    def __init__(self, params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor],
                 slots: Sequence[Sequence[Optional[torch.Tensor]]],
                 decay: Sequence[bool], lr: float, step: int,
                 rule: str = "adam"):
        if rule not in RULES:
            raise ValueError(f"unknown rule {rule!r}")
        self.params = list(params)
        self.grads = list(grads)
        n = len(self.params)
        self.slots = [list(s) for s in slots]
        self.decay = [bool(d) for d in decay]
        if len(self.grads) != n or len(self.decay) != n or \
                len(self.slots) != 3 or any(len(s) != n for s in self.slots):
            raise ValueError("StepBatch: lists of different lengths")
        self.lr = float(lr)
        self.step = int(step)
        self.rule = rule
        self.device = dev = (self.params[0].device if n
                             else torch.device("cpu"))
        for t in self.params + self.grads + [t for s in self.slots
                                             for t in s if t is not None]:
            if t.device != dev:
                raise ValueError(f"optimizer: tensor on {t.device}, the "
                                 f"step's first parameter on {dev}")
        self.n_chunks = self.n_matrices = self.col_elems = 0
        self.row_sums = self.col_sums = 0  # a split Adafactor step's sums
        self.seg_cols = 256
        self._table = None
        self._host = None       # the table's words, its header kept current
        self._pending = False   # captured: the device table not yet written
        self._reserved = None   # the device buffer for a captured table
        self.device_step = None  # (applied-update count, skip) on the device
        self.split = None  # TensorSplits: the tensors are split over ranks

    def __len__(self):
        return len(self.params)

    def factored(self, i: int) -> bool:
        """Adafactor keeps ``vr``/``vc`` for tensor ``i`` (2+ dims)."""
        return self.rule == "adafactor" and self.params[i].dim() >= 2

    def scalars(self):
        """(lr fp32, step int32) 0-d tensors on the batch's device, as the
        plain versions read them (the kernels read the two values from the
        table's header). Not CPU scalars on a CUDA batch: CUDA divides by
        a CPU scalar as a product with its reciprocal, which rounds
        otherwise than the division the reference and the kernel take.
        With a device step bound the step is its count + 1."""
        lr = torch.tensor(self.lr, dtype=torch.float32, device=self.device)
        if self.device_step is not None:
            return lr, (self.device_step[0].reshape(()) + 1).to(torch.int32)
        return lr, torch.tensor(self.step, dtype=torch.int32,
                                device=self.device)

    def bind_device_step(self, count: torch.Tensor,
                         skip: torch.Tensor) -> None:
        """Takes this step's number and skip flag from the device (the
        in-graph GradScaler): ``count`` int32 [1], the updates applied
        before this one (the step is ``count + 1``), ``skip`` int32 [1],
        nonzero where the update must write nothing. The kernels read both
        from the table's header, which :meth:`table` writes from them on
        the stream (two copies, captured with the kernels); the plain
        versions read them on the host."""
        for t in (count, skip):
            if t.device != self.device or t.dtype != torch.int32 or \
                    t.numel() != 1:
                raise ValueError("bind_device_step: int32 [1] tensors on "
                                 "the batch's device")
        self.device_step = (count, skip)

    def skipped(self) -> bool:
        """Whether a bound device flag says skip (a host read: the plain
        versions' test; the kernels read the header)."""
        return self.device_step is not None and \
            bool(self.device_step[1].item())

    def _check(self):
        for i, (p, g) in enumerate(zip(self.params, self.grads)):
            if p.dtype not in _DTYPES:
                raise TypeError(f"optimizer kernels take float32 or bfloat16 "
                                f"parameters, got {p.dtype} (tensor {i})")
            fp32_sum = g.dtype == torch.float32 and p.dtype == torch.bfloat16
            if (g.dtype != p.dtype and not fp32_sum) or g.shape != p.shape:
                raise TypeError(f"tensor {i}: gradient {g.dtype} "
                                f"{tuple(g.shape)} does not fit parameter "
                                f"{p.dtype} {tuple(p.shape)}")
            for j, (dtype, numel) in enumerate(self._slot_specs(i)):
                t = self.slots[j][i]
                if dtype is None or t is None:
                    # Adafactor's first moment is optional
                    if t is None and dtype is not None and not (
                            self.rule == "adafactor" and j == 2):
                        raise ValueError(f"tensor {i}: state {j} missing")
                    continue
                if t.dtype != dtype or t.numel() != numel:
                    raise TypeError(f"tensor {i}: state {t.dtype} "
                                    f"{tuple(t.shape)} is not {dtype} of "
                                    f"{numel} elements")
            for t in [p, g] + [s[i] for s in self.slots if s[i] is not None]:
                if not t.is_contiguous():
                    raise ValueError(f"tensor {i}: the optimizer kernels "
                                     f"take contiguous tensors")

    def _slot_specs(self, i):
        """(dtype, numel) each slot must have for tensor ``i``."""
        p = self.params[i]
        n = p.numel()
        if self.rule != "adafactor":
            k = _RULE_SLOTS[self.rule]
            return [(p.dtype, n) if j < k else (None, None)
                    for j in range(3)]
        if self.factored(i):
            return [(torch.float32, n // p.shape[-1] if n else 0),
                    (torch.float32, n // p.shape[-2] if n else 0),
                    (p.dtype, n)]
        return [(torch.float32, n), (None, None), (p.dtype, n)]

    def _plan(self) -> np.ndarray:
        """The table as an int64 array (layout: csrc/optimizer.cu). One
        Python row per tensor; the chunk and matrix words are numpy ranges
        (the host builds this every step)."""
        n = len(self)
        rows, nch, mats = [], [], []
        c0 = mat_base = col_base = max_cols = vr_base = vc_base = 0
        for i, (p, g) in enumerate(zip(self.params, self.grads)):
            numel = p.numel()
            ptrs = [p.data_ptr(), g.data_ptr()] + [
                0 if s[i] is None else s[i].data_ptr() for s in self.slots]
            flags = (_BF16 if p.dtype == torch.bfloat16 else 0) | \
                (_DECAY if self.decay[i] else 0) | \
                (_GRAD_F32 if g.dtype != p.dtype else 0)
            vec = not any(x % 16 for x in ptrs)
            C = R = tiles = split_base = 0
            span = FLAT_CHUNK
            if self.factored(i) and numel:
                C, R = p.shape[-1], p.shape[-2]
                span = max(1, min(R, MAX_TILE_ROWS, TILE_ELEMENTS // C))
                tiles = -(-R // span)
                mats.append((i, numel // (R * C)))
                count = mats[-1][1] * tiles
                vec = vec and C % 8 == 0
                flags |= _FACTORED
                max_cols = max(max_cols, C)
                split_base = (vc_base << 32) | vr_base
                vr_base += numel // C
                vc_base += numel // R
            else:
                count = -(-numel // FLAT_CHUNK)
            rows.append(ptrs + [numel, C, R, span, tiles, c0, c0 + count,
                                flags | (_VEC if vec else 0), mat_base,
                                col_base, split_base])
            if C:
                mat_base += mats[-1][1]
                col_base += count * C
            nch.append(count)
            c0 += count
        self.n_chunks, self.n_matrices, self.col_elems = c0, mat_base, col_base
        self.row_sums, self.col_sums = vr_base, vc_base
        self.seg_cols = min(SEG_COLS, max(256, -(-max_cols // 256) * 256))
        head = self._header(np.zeros(2 * HEADER_WORDS, np.int32))

        def ranges(owner, counts):
            """owner << 40 | index within the owner, for every item."""
            owner, counts = np.asarray(owner, np.int64), \
                np.asarray(counts, np.int64)
            first = np.repeat(np.cumsum(counts) - counts, counts)
            return (np.repeat(owner, counts) << 40) | \
                (np.arange(counts.sum(), dtype=np.int64) - first)

        words = np.asarray(rows, np.int64).reshape(n, TENSOR_WORDS)
        mat_words = ranges([i for i, _ in mats], [b for _, b in mats])
        return np.concatenate([head.view(np.int64), words.ravel(),
                               ranges(np.arange(n), nch), mat_words])

    def _header(self, out: np.ndarray) -> np.ndarray:
        """The header words into int32 ``out`` [6]: lr (fp32 bits), step,
        tensors, chunks, skip (0: the host never skips), 0."""
        out[0] = np.array([self.lr], np.float32).view(np.int32)[0]
        out[1:] = [self.step, len(self), self.n_chunks, 0, 0]
        return out

    def table(self) -> torch.Tensor:
        """The chunk table on the device (int64), built and copied once.
        Inside a CUDA graph capture it takes the buffer of :meth:`reserve`
        and is left unwritten: the kernels the capture records read it when
        the graph replays, after :meth:`set_step` has copied it. With a
        device step bound (:meth:`bind_device_step`) each call writes the
        header's step and skip words from it on the stream."""
        if self._table is None:
            host = self.host_table()
            self._pending = torch.cuda.is_current_stream_capturing()
            if not self._pending:
                self._table = torch.empty(host.size, dtype=torch.int64,
                                          device=self.device)
                self._copy(host.size)
            elif self._reserved is None or \
                    self._reserved.numel() != host.size:
                raise RuntimeError(
                    "a step table made inside a CUDA graph capture needs a "
                    "device buffer of its size reserved before the capture "
                    "(StepBatch.reserve, Optimizer._reserve_table)")
            else:
                self._table = self._reserved
        if self.device_step is not None:
            count, skip = self.device_step
            head = self._table[:HEADER_WORDS].view(torch.int32)
            head[1:2].copy_(count + 1)
            head[4:5].copy_(skip)
        return self._table

    def reserve(self, buffer: torch.Tensor) -> None:
        """The int64 device buffer, allocated outside any capture, that
        the table takes when it is made inside a CUDA graph capture."""
        self._reserved = buffer

    def words(self) -> int:
        """The table's length in int64 words (it depends on the tensors'
        shapes and the rule, not on their addresses)."""
        return self.host_table().size

    def host_table(self) -> np.ndarray:
        """The table's words as the device holds them after the last
        :meth:`set_step` (built on the first call)."""
        if self._host is None:
            self._check()
            self._host = self._plan()
        return self._host

    def _copy(self, words: int) -> None:
        """Copy the first ``words`` of the host table to the device on the
        current stream, from a fresh pinned buffer: the caching host
        allocator records an event for the copy and reuses the buffer only
        after it, so the host never overwrites words a queued copy has yet
        to read (the allocator's pool is the ring of pinned slots)."""
        pinned = torch.empty(words, dtype=torch.int64, pin_memory=True)
        pinned.numpy()[:] = self._host[:words]
        self._table[:words].copy_(pinned, non_blocking=True)

    def set_step(self, lr: float, step: int) -> None:
        """This step's rate and 1-based number, for a batch whose tensors
        are the same. Where the table is on the device, its header (24
        bytes) is copied there on the current stream (after a capture, the
        whole table the first time; :meth:`_copy`)."""
        self.lr = float(lr)
        self.step = int(step)
        if self._host is not None:
            self._header(self._host[:HEADER_WORDS].view(np.int32))
        if self._table is None:
            return
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("set_step: the header is written outside a "
                               "CUDA graph capture, before each replay")
        # the first step after a capture writes the whole table
        self._copy(self._host.size if self._pending else HEADER_WORDS)
        self._pending = False


class TensorSplits:
    """How the tensors of a step are split across ranks, for the rules
    that take statistics over a whole tensor (Adafactor, Lamb, LARS): a
    statistic is a partial sum on each rank, summed over the axes that
    split its tensor, then finished. ``axes``: ``(process group, degree,
    dims)`` per axis, in the order the sums are taken (fixed), where
    ``dims`` maps ``id(tensor)`` to the dim that axis splits (absent:
    whole over it).

    :meth:`reduce` sums a buffer of per-tensor statistics over each axis
    for the elements whose tensor the axis splits in the way the
    statistic reads: ``"tensor"`` (one value a tensor) and ``"tensor2"``
    (two) over any split; Adafactor's ``"rows"`` (a factored tensor's row
    sums, over its columns) where its last dim is split, and ``"cols"``
    (column sums) and ``"matrix"`` (each matrix's sum of vr) where its
    second to last is. Its masks are made at the first call for a list of
    tensors (a CUDA graph's eager warm-up), outside any capture."""

    def __init__(self, axes):
        self.axes = [(pg, int(n), dict(dims)) for pg, n, dims in axes]
        self._masks = {}
        self._fulls = {}

    def dims(self, t) -> list:
        """The dims of ``t`` split over each axis (None: whole)."""
        return [dims.get(id(t)) for _, _, dims in self.axes]

    def full_shape(self, t) -> list:
        shape = list(t.shape)
        for (_, n, _), d in zip(self.axes, self.dims(t)):
            if d is not None:
                shape[d] *= n
        return shape

    @staticmethod
    def _count(kind, t) -> int:
        if kind in ("tensor", "tensor2"):
            return 1 if kind == "tensor" else 2
        if t.dim() < 2 or not t.numel():
            return 0
        numel, C, R = t.numel(), t.shape[-1], t.shape[-2]
        return {"rows": numel // C, "cols": numel // R,
                "matrix": numel // (R * C)}[kind]

    @staticmethod
    def _reads(kind, d, t) -> bool:
        """Whether a split of ``t`` on dim ``d`` makes ``kind`` partial."""
        if d is None:
            return False
        if kind in ("tensor", "tensor2"):
            return True
        return d == t.dim() - (1 if kind == "rows" else 2)

    def _mask(self, kind, params, j):
        key = (kind, j, tuple(id(p) for p in params))
        m = self._masks.get(key)
        if m is None:
            bits = []
            for p in params:
                d = self.dims(p)[j]
                bits += [self._reads(kind, d, p)] * self._count(kind, p)
            m = self._masks[key] = (
                torch.tensor(bits, dtype=torch.bool, device=params[0].device)
                if any(bits) else False)
        return m

    def reduce(self, buf: torch.Tensor, kind: str, params) -> None:
        """Sums ``buf`` (the statistic ``kind`` of ``params``, in tensor
        order) in place over each axis, where that axis splits the
        statistic's tensor."""
        import torch.distributed as dist

        for j, (pg, _n, _dims) in enumerate(self.axes):
            m = self._mask(kind, params, j)
            if m is False:
                continue
            t = torch.where(m, buf, torch.zeros((), dtype=buf.dtype,
                                                device=buf.device))
            dist.all_reduce(t, group=pg)
            buf.copy_(torch.where(m, t, buf))

    def matrix_rows(self, params) -> torch.Tensor:
        """fp32 [matrices]: the whole R of each matrix of the tensors of 2+
        dims, the divisor of its mean of vr (made once per tensor list)."""
        key = ("rows",) + tuple(id(p) for p in params)
        t = self._fulls.get(key)
        if t is None:
            rs = [self.full_shape(p)[-2]
                  for p in params if p.dim() >= 2 and p.numel()
                  for _ in range(p.numel() // (p.shape[-1] * p.shape[-2]))]
            t = self._fulls[key] = torch.tensor(rs, dtype=torch.float32,
                                                device=params[0].device)
        return t

    def fulls(self, params) -> torch.Tensor:
        """fp32 [3 n]: each whole tensor's numel, last dim (C) and second
        to last (R), the divisors of its means (0 where it has none)."""
        key = tuple(id(p) for p in params)
        f = self._fulls.get(key)
        if f is None:
            rows = []
            for p in params:
                full = self.full_shape(p)
                numel = int(np.prod(full)) if full else 1
                rows += [numel, full[-1] if len(full) >= 1 else 0,
                         full[-2] if len(full) >= 2 else 0]
            f = self._fulls[key] = torch.tensor(
                np.asarray(rows, np.float64).astype(np.float32),
                device=params[0].device)
        return f


def _route(batch: StepBatch, counts) -> bool:
    """True where the kernel runs (a CUDA batch); counts a plain call on a
    CPU one; raises on any other device."""
    if batch.device.type == "cpu":
        counts.plain()
        return False
    if batch.device.type != "cuda":
        raise ValueError(f"optimizer kernels take CUDA tensors, got "
                         f"{batch.device}")
    return True


def _clip_args(batch: StepBatch, clip, norms):
    """(mode, lo, hi) of ``clip`` for a kernel; ``("scale",)`` needs the
    fp32 ``norms`` of :func:`multi_tensor_sumsq` over this batch."""
    mode = clip[0]
    if mode not in _CLIP_MODES:
        raise ValueError(f"unknown clip mode {mode!r}")
    if mode == "scale" and (
            norms is None or norms.device != batch.device or
            norms.dtype != torch.float32 or
            norms.numel() != 2 * len(batch) + 1):
        raise ValueError("clip ('scale',) needs the fp32 norms of "
                         "multi_tensor_sumsq over the same batch")
    lo, hi = (float(clip[1]), float(clip[2])) if mode == "value" else (0., 0.)
    return _CLIP_MODES[mode], lo, hi


def _ptr(t):
    return None if t is None else t.data_ptr()


# -- (a) sums of squares and clip scales ---------------------------------------

def clip_norms_plain(grads, clip_norm=0.0, scale_mode=0):
    """fp32 ``[2n + 1]``: per-tensor sums of squares, per-tensor scales
    ``min(clip_norm / max(norm, 1e-12), 1)`` (scale_mode 1: the tensor's
    own norm; 2: the global norm; 0: all 1) and the global sum, added in
    tensor order as ``paddle_tpu/nn/clip.py:49`` does."""
    n = len(grads)
    dev = grads[0].device if n else torch.device("cpu")
    sums = [g.float().square().sum() for g in grads]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for s in sums:
        total = total + s
    if not n:
        return total.reshape(1)
    sums = torch.stack(sums)
    if scale_mode == 0:
        scales = torch.ones_like(sums)
    else:
        norm = (total.expand(n) if scale_mode == 2 else sums).sqrt()
        scales = (clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
    return torch.cat([sums, scales, total.reshape(1)])


def multi_tensor_sumsq_plain(batch: StepBatch, clip_norm=0.0, scale_mode=0):
    return clip_norms_plain(batch.grads, clip_norm, scale_mode)


def multi_tensor_sumsq(batch: StepBatch, clip_norm=0.0, scale_mode=0):
    """Sums of squares of ``batch.grads`` (fp32), the clip scales and the
    global sum: ``[2n + 1]`` fp32, as :func:`clip_norms_plain`."""
    if not _route(batch, COUNTS_SUMSQ):
        return multi_tensor_sumsq_plain(batch, clip_norm, scale_mode)
    table = batch.table()
    partial = torch.empty(max(batch.n_chunks, 1), dtype=torch.float32,
                          device=batch.device)
    out = torch.empty(2 * len(batch) + 1, dtype=torch.float32,
                      device=batch.device)
    fn = _build.kernel("pt_opt_sumsq", [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_float,
                                        ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p])
    _build.launch(fn, "pt_opt_sumsq", batch.device, table.data_ptr(),
                  batch.n_chunks, partial.data_ptr(), float(clip_norm),
                  int(scale_mode), out.data_ptr())
    COUNTS_SUMSQ.launched()
    return out


def clip_plain(g, clip, norms=None, i=0):
    """Gradient ``g`` (the ``i``-th of a step) clipped in its dtype as
    ``paddle_tpu/nn/clip.py:28, 40, 52`` round: ``clip`` ``("none",)``;
    ``("value", lo, hi)``, clamped; ``("scale",)``, ``(g.float() *
    scale).to(g.dtype)`` with tensor ``i``'s scale from ``norms``
    (:func:`clip_norms_plain`)."""
    if clip[0] == "scale":
        return (g.float() * norms[(norms.numel() - 1) // 2 + i]).to(g.dtype)
    if clip[0] == "value":
        return g.clamp(clip[1], clip[2])
    return g


def _grad_plain(batch: StepBatch, i: int, clip, norms, weight_decay,
               decoupled):
    """Tensor ``i``'s gradient as the rule sees it: clipped
    (:func:`clip_plain`), cast to the parameter's dtype, plus the coupled
    decay ``wd * p`` (``paddle_tpu/optimizer/optimizer.py:128-134``)."""
    p = batch.params[i]
    g = clip_plain(batch.grads[i], clip, norms, i).to(p.dtype)
    if weight_decay and not decoupled and batch.decay[i]:
        g = g + _const(weight_decay, p) * p
    return g


def _const(x, t):
    """The Python float ``x`` as the JAX package takes it beside a tensor
    of ``t``'s dtype (a weakly typed scalar): a 0-d tensor of that dtype on
    ``t``'s device, so a bf16 product rounds the constant to bf16 first, as
    the kernels do (``Elem<T>::rnd``)."""
    return torch.tensor(x, dtype=t.dtype, device=t.device)


# -- (b) Adam / AdamW ----------------------------------------------------------

def adam_update_plain(batch: StepBatch, *, beta1, beta2, epsilon,
                      weight_decay, decoupled, clip=("none",), norms=None):
    """The per-tensor loop, in the rounding order of ``Adam._rule``
    (``optimizer.py:265-276``) and the decays of ``_get_fused``. The bias
    corrections ``1 - beta^t`` are taken in fp32, the power of the fp32
    beta, as the JAX package takes them (``optimizer.py:270-272``)."""
    lr, step = batch.scalars()
    t = step.float()
    c1 = 1.0 - torch.pow(torch.full_like(t, beta1), t)
    c2 = 1.0 - torch.pow(torch.full_like(t, beta2), t)
    omb1, omb2 = 1.0 - beta1, 1.0 - beta2
    if batch.skipped():
        return
    for i, p in enumerate(batch.params):
        m, v = batch.slots[0][i], batch.slots[1][i]
        g = _grad_plain(batch, i, clip, norms, weight_decay, decoupled)
        gf = g.float()
        mf = m.float() * beta1 + gf * omb1
        vf = v.float() * beta2 + (gf * omb2) * gf
        upd = (lr * (mf / c1)) / ((vf / c2).sqrt() + epsilon)
        new = (p.float() - upd).to(p.dtype)
        if weight_decay and decoupled and batch.decay[i]:
            new = new - ((lr * weight_decay) * p.float()).to(p.dtype)
        p.copy_(new)
        m.copy_(mf)
        v.copy_(vf)


def adam_update(batch: StepBatch, *, beta1, beta2, epsilon, weight_decay,
                decoupled, clip=("none",), norms=None):
    """One Adam (``decoupled`` False: the decay added to g) or AdamW step
    over ``batch`` in place: p, ``slots[0]`` (moment1), ``slots[1]``
    (moment2). ``clip`` ``("scale",)`` reads the scales of ``norms``
    (:func:`multi_tensor_sumsq`)."""
    if not _route(batch, COUNTS_ADAM):
        return adam_update_plain(batch, beta1=beta1, beta2=beta2,
                                 epsilon=epsilon, weight_decay=weight_decay,
                                 decoupled=decoupled, clip=clip, norms=norms)
    mode, lo, hi = _clip_args(batch, clip, norms)
    table = batch.table()
    fn = _build.kernel("pt_opt_adam", [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p] +
                       [ctypes.c_float] * 6 + [ctypes.c_int] * 2 +
                       [ctypes.c_float] * 2 + [ctypes.c_void_p])
    _build.launch(fn, "pt_opt_adam", batch.device, table.data_ptr(),
                  batch.n_chunks, _ptr(norms), float(beta1), float(beta2),
                  1.0 - beta1, 1.0 - beta2, float(epsilon),
                  float(weight_decay), int(bool(decoupled)), mode, lo, hi)
    COUNTS_ADAM.launched()


# -- (c) Adafactor statistics ----------------------------------------------------

def adafactor_stats_plain(batch: StepBatch, *, decay_rate, epsilon1,
                          weight_decay, pscale, clip=("none",), norms=None):
    """Updates ``vr``/``vc`` (or ``v``) in place as ``Adafactor._rule``
    (``optimizer.py:448-458``) does; returns fp32 ``[n + matrices]``: each
    parameter's sum of squares (0 where neither the parameter scale nor
    the decay reads p), then ``mean(vr)`` of every matrix in order. Over
    split tensors (``batch.split``) the row sums, column sums, sums of
    squares and sums of vr are summed over the ranks before each mean."""
    _lr, step = batch.scalars()
    bt = 1 - step.float().pow(-decay_rate)
    om = 1 - bt
    if batch.skipped():
        mats = sum(p.numel() // (p.shape[-1] * p.shape[-2])
                   for i, p in enumerate(batch.params)
                   if batch.factored(i) and p.numel())
        return torch.zeros(len(batch) + mats, dtype=torch.float32,
                           device=batch.device)
    split = batch.split
    psums, means, rows, cols = [], [], [], []
    for i, p in enumerate(batch.params):
        g = _grad_plain(batch, i, clip, norms, weight_decay, False)
        gf = g.float()
        g2 = gf * gf + epsilon1
        s0, s1 = batch.slots[0][i], batch.slots[1][i]
        if batch.factored(i) and split is not None:
            rows.append(g2.sum(dim=-1).reshape(-1))
            cols.append(g2.sum(dim=-2).reshape(-1))
        elif batch.factored(i):
            s0.copy_(bt * s0 + om * g2.mean(dim=-1))
            s1.copy_(bt * s1 + om * g2.mean(dim=-2))
            means.append(s0.mean(dim=-1).reshape(-1))
        else:
            s0.copy_(bt * s0 + om * g2)
        pf = p.float()
        need_p = pscale or weight_decay  # as the kernel reads p
        psums.append((pf * pf).sum() if need_p else pf.new_zeros(()))
    if not psums:
        return torch.zeros(0, dtype=torch.float32, device=batch.device)
    if split is None:
        return torch.cat([torch.stack(psums)] + means)
    params = batch.params
    psum = torch.stack(psums)
    empty = psum.new_zeros(0)
    rowsum = torch.cat(rows) if rows else empty
    colsum = torch.cat(cols) if cols else empty
    split.reduce(rowsum, "rows", params)
    split.reduce(colsum, "cols", params)
    split.reduce(psum, "tensor", params)
    ro = co = 0
    vrsums = []
    for i, p in enumerate(params):
        if not batch.factored(i):
            continue
        s0, s1 = batch.slots[0][i], batch.slots[1][i]
        full = split.full_shape(p)
        nr, nc = s0.numel(), s1.numel()
        s0.copy_(bt * s0 + om * (rowsum[ro:ro + nr].reshape(s0.shape) /
                                 float(full[-1])))
        s1.copy_(bt * s1 + om * (colsum[co:co + nc].reshape(s1.shape) /
                                 float(full[-2])))
        ro, co = ro + nr, co + nc
        vrsums.append(s0.sum(dim=-1).reshape(-1))
    vrsum = torch.cat(vrsums) if vrsums else empty
    split.reduce(vrsum, "matrix", params)
    return torch.cat([psum, vrsum / split.matrix_rows(params)])


def adafactor_stats(batch: StepBatch, *, decay_rate, epsilon1, weight_decay,
                    pscale, clip=("none",), norms=None):
    """Adafactor's statistics over ``batch`` (rule ``"adafactor"``): the
    factored ``vr``/``vc`` or plain ``v`` updated in place; returns the
    stats :func:`adafactor_update` reads, as :func:`adafactor_stats_plain`.
    Over split tensors (``batch.split``) the kernels stop at the raw
    sums, the ranks sum them (:meth:`TensorSplits.reduce`), and a finish
    launch takes the means over the whole tensors."""
    if not _route(batch, COUNTS_ADAFACTOR_STATS):
        return adafactor_stats_plain(batch, decay_rate=decay_rate,
                                     epsilon1=epsilon1,
                                     weight_decay=weight_decay, pscale=pscale,
                                     clip=clip, norms=norms)
    mode, lo, hi = _clip_args(batch, clip, norms)
    table = batch.table()
    dev = batch.device
    split = batch.split
    n = len(batch)
    colpart = torch.empty(max(batch.col_elems, 1), dtype=torch.float32,
                          device=dev)
    pspart = torch.empty(max(batch.n_chunks, 1), dtype=torch.float32,
                         device=dev)
    stats = torch.empty(n + batch.n_matrices, dtype=torch.float32,
                        device=dev)
    rowsum = colsum = None
    if split is not None:
        rowsum = torch.empty(max(batch.row_sums, 1), dtype=torch.float32,
                             device=dev)
        colsum = torch.empty(max(batch.col_sums, 1), dtype=torch.float32,
                             device=dev)
    need_p = int(bool(pscale) or bool(weight_decay))
    fn = _build.kernel("pt_opt_adafactor_stats",
                       [ctypes.c_void_p] + [ctypes.c_int] * 3 +
                       [ctypes.c_void_p] + [ctypes.c_float] * 3 +
                       [ctypes.c_int] + [ctypes.c_float] * 2 +
                       [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6)
    _build.launch(fn, "pt_opt_adafactor_stats", dev, table.data_ptr(),
                  n, batch.n_chunks, batch.n_matrices, _ptr(norms),
                  float(decay_rate), float(epsilon1), float(weight_decay),
                  mode, lo, hi, need_p, batch.seg_cols, colpart.data_ptr(),
                  pspart.data_ptr(), stats.data_ptr(), _ptr(rowsum),
                  _ptr(colsum))
    if split is not None:
        params = batch.params
        split.reduce(rowsum[:batch.row_sums], "rows", params)
        split.reduce(colsum[:batch.col_sums], "cols", params)
        split.reduce(stats[:n], "tensor", params)
        fin = _build.kernel("pt_opt_adafactor_split_finish",
                            [ctypes.c_void_p, ctypes.c_int, ctypes.c_float] +
                            [ctypes.c_void_p] * 5)
        _build.launch(fin, "pt_opt_adafactor_split_finish", dev,
                      table.data_ptr(), batch.n_matrices, float(decay_rate),
                      rowsum.data_ptr(), colsum.data_ptr(),
                      split.fulls(params).data_ptr(), stats.data_ptr())
        vrsum = stats[n:]
        split.reduce(vrsum, "matrix", params)
        vrsum.div_(split.matrix_rows(params))
    COUNTS_ADAFACTOR_STATS.launched()
    return stats


# -- (d) Adafactor update -----------------------------------------------------------

def adafactor_update_plain(batch: StepBatch, stats, *, beta1, epsilon2,
                           clip_threshold, pscale, weight_decay,
                           clip=("none",), norms=None):
    """p (and ``m``) in place as ``optimizer.py:462-473``: u = g /
    sqrt(vhat), clipped by its RMS, the first moment, the parameter
    scale. Over split tensors (``batch.split``) each RMS and parameter
    scale is over the whole tensor: the sums of u^2 are summed over the
    ranks first."""
    lr, _step = batch.scalars()
    n = len(batch)
    mat = n
    if batch.skipped():
        return
    split = batch.split
    us, usq = [], []
    for i, p in enumerate(batch.params):
        g = _grad_plain(batch, i, clip, norms, weight_decay, False)
        gf = g.float()
        numel = p.numel()
        s0, s1, m = (s[i] for s in batch.slots)
        if batch.factored(i):
            b = numel // (p.shape[-1] * p.shape[-2])
            mean = stats[mat:mat + b].reshape(p.shape[:-2] + (1,))
            mat += b
            vhat = (s0 / mean)[..., None] * s1[..., None, :]
        else:
            vhat = s0
        u = gf / vhat.sqrt()
        if split is not None:  # the update waits for the ranks' sums
            us.append(u)
            usq.append((u * u).sum())
            continue
        _adafactor_apply_plain(batch, i, u, (u * u).sum(), float(numel),
                               stats[i], lr, beta1, epsilon2, clip_threshold,
                               pscale)
    if split is None:
        return
    usq = torch.stack(usq)
    split.reduce(usq, "tensor", batch.params)
    psum = stats[:n].clone()
    for i, p in enumerate(batch.params):
        full = float(np.prod(split.full_shape(p)))
        _adafactor_apply_plain(batch, i, us[i], usq[i], full, psum[i], lr,
                               beta1, epsilon2, clip_threshold, pscale)


def _adafactor_apply_plain(batch, i, u, usq, numel, psum, lr, beta1,
                           epsilon2, clip_threshold, pscale):
    """Tensor ``i``'s update from its u, its sum of u^2 and sum of p^2 over
    ``numel`` elements."""
    p, m = batch.params[i], batch.slots[2][i]
    rms = (usq / numel).sqrt()
    u = u / (rms / clip_threshold).clamp_min(1.0)
    if m is not None:
        mf = m.float() * beta1 + u * (1.0 - beta1)
        m.copy_(mf)
        u = mf
    pf = p.float()
    scale = (psum / numel).sqrt().clamp_min(epsilon2) if pscale else 1.0
    p.copy_((pf - (lr * scale) * u).to(p.dtype))


def adafactor_update(batch: StepBatch, stats, *, beta1, epsilon2,
                     clip_threshold, pscale, weight_decay, clip=("none",),
                     norms=None):
    """Adafactor's update over ``batch`` in place (p, and ``m`` where the
    batch carries one), from ``stats`` of :func:`adafactor_stats`. Over
    split tensors: the u^2 pass and each tensor's sum, the sums over the
    ranks, then the update pass."""
    if not _route(batch, COUNTS_ADAFACTOR_UPDATE):
        return adafactor_update_plain(batch, stats, beta1=beta1,
                                      epsilon2=epsilon2,
                                      clip_threshold=clip_threshold,
                                      pscale=pscale,
                                      weight_decay=weight_decay, clip=clip,
                                      norms=norms)
    mode, lo, hi = _clip_args(batch, clip, norms)
    table = batch.table()
    if stats.device != batch.device or stats.dtype != torch.float32 or \
            stats.numel() != len(batch) + batch.n_matrices:
        raise ValueError("adafactor_update: stats do not fit the batch")
    uspart = torch.empty(max(batch.n_chunks, 1), dtype=torch.float32,
                         device=batch.device)
    split = batch.split
    usq = None if split is None else torch.empty(
        max(len(batch), 1), dtype=torch.float32, device=batch.device)
    fulls = None if split is None else split.fulls(batch.params)
    fn = _build.kernel("pt_opt_adafactor_update",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] +
                       [ctypes.c_void_p] * 3 + [ctypes.c_float] * 4 +
                       [ctypes.c_int, ctypes.c_float, ctypes.c_int] +
                       [ctypes.c_float] * 2 + [ctypes.c_int] +
                       [ctypes.c_void_p] * 3)

    def run(phase):
        _build.launch(fn, "pt_opt_adafactor_update", batch.device,
                      table.data_ptr(), len(batch), batch.n_chunks,
                      _ptr(norms), stats.data_ptr(), uspart.data_ptr(),
                      float(beta1), 1.0 - beta1, float(epsilon2),
                      float(clip_threshold), int(bool(pscale)),
                      float(weight_decay), mode, lo, hi, phase, _ptr(usq),
                      _ptr(fulls))

    if split is None:
        run(0)
    else:
        run(1)
        split.reduce(usq[:len(batch)], "tensor", batch.params)
        run(2)
    COUNTS_ADAFACTOR_UPDATE.launched()


# -- (e) the rules computed in the parameter's dtype ---------------------------

# each rule's hyperparameters as pt_opt_rule takes them (RuleArgs.h), its
# option flag (Momentum: Nesterov; RMSProp: centered) and its counter
def _rule_args(rule, kw):
    if rule == "sgd":
        return (), 0
    if rule == "momentum":
        return (kw["momentum"],), int(bool(kw["nesterov"]))
    if rule == "adagrad":
        return (kw["epsilon"],), 0
    if rule == "adamax":
        return (kw["beta1"], 1.0 - kw["beta1"], kw["beta2"],
                kw["epsilon"]), 0
    if rule == "rmsprop":
        return (kw["rho"], 1.0 - kw["rho"], kw["epsilon"],
                kw["momentum"]), int(bool(kw["centered"]))
    return (kw["rho"], 1.0 - kw["rho"], kw["epsilon"]), 0  # adadelta


_RULE_COUNTS = {"sgd": COUNTS_SGD, "momentum": COUNTS_MOMENTUM,
                "adagrad": COUNTS_ADAGRAD, "adamax": COUNTS_ADAMAX,
                "rmsprop": COUNTS_RMSPROP, "adadelta": COUNTS_ADADELTA}


def _rule_plain(rule, batch: StepBatch, kw, weight_decay, clip, norms):
    """The per-tensor loop of one of the six rules, each operation in the
    parameter's dtype in the order of its ``_rule`` (``optimizer.py:
    212-332, 476-498``): the Python-float hyperparameters and the rate
    (``lr.astype(p.dtype)``) are constants of that dtype (:func:`_const`);
    ``1 - x`` is taken in Python before it becomes one; Adamax's rate
    ``lr / (1 - b1^t)`` is taken in fp32, then cast."""
    h, opt = _rule_args(rule, kw)
    lr, step = batch.scalars()
    lr_t = lr
    if batch.skipped():
        return
    if rule == "adamax":
        t = step.float()
        lr_t = lr / (1 - torch.pow(torch.full_like(t, h[0]), t))
    for i, p in enumerate(batch.params):
        g = _grad_plain(batch, i, clip, norms, weight_decay, False)
        s0, s1, s2 = (s[i] for s in batch.slots)
        c = [_const(x, p) for x in h]
        r = lr_t.to(p.dtype)
        if rule == "sgd":
            new = p - r * g
        elif rule == "momentum":
            v = c[0] * s0 + g
            new = p - r * ((g + c[0] * v) if opt else v)
            s0.copy_(v)
        elif rule == "adagrad":
            m = s0 + g * g
            new = p - (r * g) / (m.sqrt() + c[0])
            s0.copy_(m)
        elif rule == "adamax":
            m = c[0] * s0 + c[1] * g
            u = torch.maximum(c[2] * s1, g.abs())
            new = p - (r * m) / (u + c[3])
            s0.copy_(m)
            s1.copy_(u)
        elif rule == "rmsprop":
            ms = c[0] * s0 + (c[1] * g) * g
            if opt:
                mg = c[0] * s1 + c[1] * g
                den = (ms - mg * mg + c[2]).sqrt()
                s1.copy_(mg)
            else:
                den = (ms + c[2]).sqrt()
            v = c[3] * s2 + (r * g) / den
            new = p - v
            s0.copy_(ms)
            s2.copy_(v)
        else:  # adadelta: the update reads the old avg_squared_update
            g2 = c[0] * s0 + (c[1] * g) * g
            upd = -(s1 + c[2]).sqrt() / (g2 + c[2]).sqrt() * g
            u2 = c[0] * s1 + (c[1] * upd) * upd
            new = p + r * upd
            s0.copy_(g2)
            s1.copy_(u2)
        p.copy_(new)


def _rule_update(rule, batch: StepBatch, kw, weight_decay, clip, norms):
    """One of the six rules over ``batch`` in place: the kernel
    (``pt_opt_rule``, one launch) on a CUDA batch, the plain loop on a CPU
    one."""
    if not _route(batch, _RULE_COUNTS[rule]):
        return _rule_plain(rule, batch, kw, weight_decay, clip, norms)
    mode, lo, hi = _clip_args(batch, clip, norms)
    h, opt = _rule_args(rule, kw)
    h = [float(x) for x in h] + [0.0] * (4 - len(h))
    table = batch.table()
    fn = _build.kernel("pt_opt_rule", [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_int] +
                       [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int] +
                       [ctypes.c_float] * 2 + [ctypes.c_void_p])
    _build.launch(fn, "pt_opt_rule", batch.device, table.data_ptr(),
                  batch.n_chunks, _ptr(norms), _RULE_IDS[rule], *h, opt,
                  float(weight_decay), mode, lo, hi)
    _RULE_COUNTS[rule].launched()


def sgd_update_plain(batch, *, weight_decay=0.0, clip=("none",), norms=None):
    _rule_plain("sgd", batch, {}, weight_decay, clip, norms)


def sgd_update(batch, *, weight_decay=0.0, clip=("none",), norms=None):
    """SGD (``optimizer.py:212-215``): ``p - lr g`` with the coupled decay,
    in place over ``batch`` (rule ``"sgd"``)."""
    _rule_update("sgd", batch, {}, weight_decay, clip, norms)


def momentum_update_plain(batch, *, momentum, nesterov, weight_decay=0.0,
                          clip=("none",), norms=None):
    _rule_plain("momentum", batch, dict(momentum=momentum, nesterov=nesterov),
                weight_decay, clip, norms)


def momentum_update(batch, *, momentum, nesterov, weight_decay=0.0,
                    clip=("none",), norms=None):
    """Momentum (``optimizer.py:218-235``): ``v = mu v + g``, ``p - lr v``
    (Nesterov: ``p - lr (g + mu v)``); ``slots[0]`` velocity."""
    _rule_update("momentum", batch, dict(momentum=momentum,
                                         nesterov=nesterov),
                 weight_decay, clip, norms)


def adagrad_update_plain(batch, *, epsilon, weight_decay=0.0, clip=("none",),
                         norms=None):
    _rule_plain("adagrad", batch, dict(epsilon=epsilon), weight_decay, clip,
                norms)


def adagrad_update(batch, *, epsilon, weight_decay=0.0, clip=("none",),
                   norms=None):
    """Adagrad (``optimizer.py:238-250``): ``m += g g``, ``p - (lr g) /
    (sqrt(m) + eps)``; ``slots[0]`` moment."""
    _rule_update("adagrad", batch, dict(epsilon=epsilon), weight_decay, clip,
                 norms)


def adamax_update_plain(batch, *, beta1, beta2, epsilon, weight_decay=0.0,
                        clip=("none",), norms=None):
    _rule_plain("adamax", batch, dict(beta1=beta1, beta2=beta2,
                                      epsilon=epsilon),
                weight_decay, clip, norms)


def adamax_update(batch, *, beta1, beta2, epsilon, weight_decay=0.0,
                  clip=("none",), norms=None):
    """Adamax (``optimizer.py:291-307``): ``m = b1 m + (1 - b1) g``, ``u =
    max(b2 u, |g|)``, ``p - (lr_t m) / (u + eps)`` with ``lr_t = lr / (1 -
    b1^t)`` in fp32; ``slots[0]`` moment, ``slots[1]`` inf_norm."""
    _rule_update("adamax", batch, dict(beta1=beta1, beta2=beta2,
                                       epsilon=epsilon),
                 weight_decay, clip, norms)


def rmsprop_update_plain(batch, *, rho, epsilon, momentum, centered,
                         weight_decay=0.0, clip=("none",), norms=None):
    _rule_plain("rmsprop", batch, dict(rho=rho, epsilon=epsilon,
                                       momentum=momentum, centered=centered),
                weight_decay, clip, norms)


def rmsprop_update(batch, *, rho, epsilon, momentum, centered,
                   weight_decay=0.0, clip=("none",), norms=None):
    """RMSProp (``optimizer.py:310-332``), centered or not, with momentum:
    ``slots`` mean_square, mean_grad (read and written only when
    centered), velocity."""
    _rule_update("rmsprop", batch, dict(rho=rho, epsilon=epsilon,
                                        momentum=momentum,
                                        centered=centered),
                 weight_decay, clip, norms)


def adadelta_update_plain(batch, *, rho, epsilon, weight_decay=0.0,
                          clip=("none",), norms=None):
    _rule_plain("adadelta", batch, dict(rho=rho, epsilon=epsilon),
                weight_decay, clip, norms)


def adadelta_update(batch, *, rho, epsilon, weight_decay=0.0, clip=("none",),
                    norms=None):
    """Adadelta (``optimizer.py:476-498``): ``slots`` avg_squared_grad,
    avg_squared_update; the update reads the old avg_squared_update."""
    _rule_update("adadelta", batch, dict(rho=rho, epsilon=epsilon),
                 weight_decay, clip, norms)


# -- (f) Lamb and LarsMomentum: fp32, per-tensor norms ---------------------------

def _norm(x):
    """fp32 ``||x||``: the sum of squares in fp64 (each fp32 square exact,
    the sum within ~2^-40 of itself), rounded to fp32, then its root, as
    the kernels take it (``csrc/optimizer.cu`` section (f))."""
    return _sumsq64(x).float().sqrt()


def _sumsq64(x):
    return x.double().square().sum()


def _split_norms(batch: StepBatch, pairs):
    """``pairs`` (per tensor two fp64 sums of squares) as fp32 norms,
    each sum first summed over the ranks that split its tensor
    (``batch.split``, kind ``"tensor2"``)."""
    sums = torch.stack([x for pair in pairs for x in pair])
    batch.split.reduce(sums, "tensor2", batch.params)
    return sums.float().sqrt().reshape(-1, 2)


def lamb_update_plain(batch: StepBatch, *, beta1, beta2, epsilon,
                      weight_decay, clip=("none",), norms=None):
    """The per-tensor loop of ``Lamb._rule`` (``optimizer.py:347-366``) in
    fp32: the decay ``weight_decay`` inside the rule, 0 for a tensor
    without the decay flag; the bias corrections in fp32. Over split
    tensors (``batch.split``) the norms are over the whole tensors."""
    lr, step = batch.scalars()
    t = step.float()
    c1 = 1.0 - torch.pow(torch.full_like(t, beta1), t)
    c2 = 1.0 - torch.pow(torch.full_like(t, beta2), t)
    omb1, omb2 = 1.0 - beta1, 1.0 - beta2
    if batch.skipped():
        return
    split = batch.split
    held = []
    for i, p in enumerate(batch.params):
        m0, v0 = batch.slots[0][i], batch.slots[1][i]
        wd = weight_decay if batch.decay[i] else 0.0
        gf = _grad_plain(batch, i, clip, norms, 0.0, False).float()
        pf = p.float()
        m = m0.float() * beta1 + gf * omb1
        v = v0.float() * beta2 + (gf * omb2) * gf
        r = (m / c1) / ((v / c2).sqrt() + epsilon) + pf * wd
        if split is not None:
            held.append((pf, m, v, r))
            continue
        _lamb_apply(p, m0, v0, pf, m, v, r, _norm(pf), _norm(r), lr)
    if split is not None:
        nrm = _split_norms(batch, [(_sumsq64(r), _sumsq64(pf))
                                   for pf, _m, _v, r in held])
        for i, (pf, m, v, r) in enumerate(held):
            _lamb_apply(batch.params[i], batch.slots[0][i],
                        batch.slots[1][i], pf, m, v, r, nrm[i, 1], nrm[i, 0],
                        lr)


def _lamb_apply(p, m0, v0, pf, m, v, r, pn, rn, lr):
    trust = torch.where((pn > 0) & (rn > 0), pn / rn, torch.ones_like(pn))
    p.copy_((pf - (lr * trust) * r).to(p.dtype))
    m0.copy_(m)
    v0.copy_(v)


def _norm_rule(rule, counts, batch, args, clip, norms):
    """Launch ``pt_opt_norm_rule`` (two kernels) over ``batch``; over split
    tensors its norms pass and per-tensor sums, the sums over the ranks,
    then its update pass."""
    mode, lo, hi = _clip_args(batch, clip, norms)
    table = batch.table()
    n = len(batch)
    partial = torch.empty(max(2 * batch.n_chunks, 1), dtype=torch.float64,
                          device=batch.device)
    split = batch.split
    sums = None if split is None else torch.empty(
        max(2 * n, 1), dtype=torch.float64, device=batch.device)
    fn = _build.kernel("pt_opt_norm_rule",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p, ctypes.c_int] +
                       [ctypes.c_float] * 8 + [ctypes.c_int] +
                       [ctypes.c_float] * 2 + [ctypes.c_void_p,
                                               ctypes.c_int] +
                       [ctypes.c_void_p] * 2)

    def run(phase):
        _build.launch(fn, "pt_opt_norm_rule", batch.device, table.data_ptr(),
                      n, batch.n_chunks, _ptr(norms), _NORM_RULE_IDS[rule],
                      *[float(x) for x in args], mode, lo, hi,
                      partial.data_ptr(), phase, _ptr(sums))

    if split is None:
        run(0)
    else:
        run(1)
        split.reduce(sums[:2 * n], "tensor2", batch.params)
        run(2)
    counts.launched()


def lamb_update(batch: StepBatch, *, beta1, beta2, epsilon, weight_decay,
                clip=("none",), norms=None):
    """Lamb over ``batch`` in place (p, ``slots[0]`` moment1, ``slots[1]``
    moment2): per-tensor norms of p and of ``r = mhat / (sqrt(vhat) + eps)
    + wd p``, then ``p - (lr trust) r``."""
    if not _route(batch, COUNTS_LAMB):
        return lamb_update_plain(batch, beta1=beta1, beta2=beta2,
                                 epsilon=epsilon, weight_decay=weight_decay,
                                 clip=clip, norms=norms)
    _norm_rule("lamb", COUNTS_LAMB, batch,
               (beta1, beta2, 1.0 - beta1, 1.0 - beta2, epsilon,
                weight_decay, 0.0, 0.0), clip, norms)


def lars_update_plain(batch: StepBatch, *, momentum, lars_coeff,
                      weight_decay, epsilon, clip=("none",), norms=None):
    """The per-tensor loop of ``LarsMomentum._rule`` (``optimizer.py:
    394-407``) in fp32: ``local_lr = lr coeff |p| / (|g| + wd |p| + eps)``
    where |p| and that denominator are positive (else lr), ``v = mu v +
    local_lr (g + wd p)``, ``p - v``; the decay 0 for a tensor without the
    decay flag. Over split tensors the norms are over the whole tensors."""
    lr, _step = batch.scalars()
    if batch.skipped():
        return
    split = batch.split
    held = []
    for i, p in enumerate(batch.params):
        gf = _grad_plain(batch, i, clip, norms, 0.0, False).float()
        pf = p.float()
        if split is not None:
            held.append((gf, pf))
            continue
        _lars_apply(batch, i, gf, pf, _norm(pf), _norm(gf), lr, momentum,
                    lars_coeff, weight_decay, epsilon)
    if split is not None:
        nrm = _split_norms(batch, [(_sumsq64(gf), _sumsq64(pf))
                                   for gf, pf in held])
        for i, (gf, pf) in enumerate(held):
            _lars_apply(batch, i, gf, pf, nrm[i, 1], nrm[i, 0], lr, momentum,
                        lars_coeff, weight_decay, epsilon)


def _lars_apply(batch, i, gf, pf, pn, gn, lr, momentum, lars_coeff,
                weight_decay, epsilon):
    p, v0 = batch.params[i], batch.slots[0][i]
    wd = weight_decay if batch.decay[i] else 0.0
    den = (gn + pn * wd) + epsilon
    rate = torch.where((pn > 0) & (den > 0), ((lr * lars_coeff) * pn) / den,
                       lr)
    v = v0.float() * momentum + rate * (gf + pf * wd)
    p.copy_((pf - v).to(p.dtype))
    v0.copy_(v)


def lars_update(batch: StepBatch, *, momentum, lars_coeff, weight_decay,
                epsilon, clip=("none",), norms=None):
    """LarsMomentum over ``batch`` in place (p, ``slots[0]`` velocity):
    per-tensor norms of p and of the clipped gradient, then one update
    pass."""
    if not _route(batch, COUNTS_LARS):
        return lars_update_plain(batch, momentum=momentum,
                                 lars_coeff=lars_coeff,
                                 weight_decay=weight_decay, epsilon=epsilon,
                                 clip=clip, norms=norms)
    _norm_rule("lars", COUNTS_LARS, batch,
               (0.0, 0.0, 0.0, 0.0, epsilon, weight_decay, lars_coeff,
                momentum), clip, norms)


# -- (g) the gradient scaler's check_finite_and_unscale ----------------------------

def _inv_args(batch: StepBatch, inv_scale):
    """(inv as a kernel argument, its device pointer or None): a float, or
    an fp32 [1] tensor on the batch's device that the kernel reads there
    (a captured graph then reads each replay's scale)."""
    if isinstance(inv_scale, torch.Tensor):
        if inv_scale.device != batch.device or \
                inv_scale.dtype != torch.float32 or inv_scale.numel() != 1:
            raise ValueError("inv_scale: a float or an fp32 [1] tensor on "
                             "the batch's device")
        return 1.0, inv_scale.data_ptr()
    return float(inv_scale), None


def check_finite_plain(batch: StepBatch, inv_scale):
    """int32 ``[1]``: 1 where some ``g * inv_scale`` (fp32) of
    ``batch.grads`` is not finite, else 0 (``inv_scale`` a float or an
    fp32 [1] tensor)."""
    flag = torch.zeros(1, dtype=torch.int32, device=batch.device)
    for g in batch.grads:
        flag |= (~torch.isfinite(g.float() * inv_scale).all()).to(
            torch.int32)
    return flag


def check_finite(batch: StepBatch, inv_scale):
    """The finiteness test of ``GradScaler.unscale_``
    (``paddle_tpu/amp/grad_scaler.py:21-27, 62-64``) over ``batch.grads``
    (rule ``"grads"``): int32 ``[1]`` on the batch's device, 1 where some
    ``g * inv_scale`` in fp32 is not finite. ``inv_scale``: a float, or
    an fp32 [1] tensor on the device that the kernel reads there."""
    if not _route(batch, COUNTS_CHECK_FINITE):
        return check_finite_plain(batch, inv_scale)
    inv, inv_dev = _inv_args(batch, inv_scale)
    table = batch.table()
    flag = torch.empty(1, dtype=torch.int32, device=batch.device)
    fn = _build.kernel("pt_opt_check_finite",
                       [ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    _build.launch(fn, "pt_opt_check_finite", batch.device, table.data_ptr(),
                  batch.n_chunks, inv, inv_dev, flag.data_ptr())
    COUNTS_CHECK_FINITE.launched()
    return flag


def unscale_plain(batch: StepBatch, inv_scale):
    for g in batch.grads:
        g.copy_((g.float() * inv_scale).to(g.dtype))


def unscale(batch: StepBatch, inv_scale):
    """Every gradient of ``batch`` to ``cast(g * inv_scale)`` in place, the
    product in fp32 (``grad_scaler.py:62, 65-67``); ``inv_scale`` as
    :func:`check_finite` takes it."""
    if not _route(batch, COUNTS_UNSCALE):
        return unscale_plain(batch, inv_scale)
    inv, inv_dev = _inv_args(batch, inv_scale)
    table = batch.table()
    fn = _build.kernel("pt_opt_unscale", [ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_float, ctypes.c_void_p,
                                          ctypes.c_void_p])
    _build.launch(fn, "pt_opt_unscale", batch.device, table.data_ptr(),
                  batch.n_chunks, inv, inv_dev)
    COUNTS_UNSCALE.launched()
