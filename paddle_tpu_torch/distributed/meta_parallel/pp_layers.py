"""The pipeline's layer description (port of
``paddle_tpu/distributed/meta_parallel/pp_layers.py`` and of
``stage_stack.py``'s ``layer_signature`` / ``find_homogeneous_run``).

``LayerDesc`` / ``SharedLayerDesc`` describe a model as a list of layers
(reference ``fleet/meta_parallel/pp_layers.py``), ``PipelineLayer``
(reference ``:132``) segments the list into stages. The JAX package
builds every stage on one controller and stacks the homogeneous run of
blocks for its ``lax.scan`` pipeline, its edge layers replicated over pp
outside the ``shard_map``; here, as in Paddle, a rank holds its own
stage's layers (kept in a ``ModuleDict`` under their global indices, no
stacking) and the edge layers sit where the segmentation puts them: the
embedding on the first stage, the final norm, head and loss on the last.
The function computed is the same.
"""
from __future__ import annotations

import contextlib
import re
import warnings
from typing import Callable, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...nn.functional.common import rewinding
from ..mesh import get_mesh_env

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "layer_signature", "find_homogeneous_run"]


class LayerDesc:
    """A deferred layer constructor (reference ``pp_layers.py``
    ``LayerDesc``): ``layer_cls(*inputs, **kwargs)``."""

    def __init__(self, layer_cls, *inputs, **kwargs):
        if not (isinstance(layer_cls, type) and
                issubclass(layer_cls, nn.Module)):
            raise TypeError(f"{layer_cls} must be a torch.nn.Module subclass")
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer whose weight is tied wherever its ``key`` appears (the
    embedding and the head): the second occurrence reuses the first's
    layer through ``forward_func(layer, *args)``."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def layer_signature(layer: nn.Module):
    """Structural identity: the class and the named parameter shapes and
    dtypes; None for a layer without parameters (never part of a run)."""
    params = tuple((n, tuple(p.shape), str(p.dtype))
                   for n, p in sorted(layer.named_parameters()))
    if not params:
        return None
    return (type(layer).__qualname__, params)


def find_homogeneous_run(layers: List[nn.Module], min_len: int = 2):
    """The longest contiguous ``[lo, hi)`` of structurally identical layers,
    or None where it is shorter than ``min_len``."""
    best = (0, 0)
    i, n = 0, len(layers)
    while i < n:
        sig = layer_signature(layers[i])
        j = i + 1
        if sig is not None:
            while j < n and layer_signature(layers[j]) == sig:
                j += 1
        if j - i > best[1] - best[0]:
            best = (i, j)
        i = j
    return best if best[1] - best[0] >= min_len else None


class _FnLayer(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _SharedProxy(nn.Module):
    """A later occurrence of a ``SharedLayerDesc``: the first occurrence's
    layer through ``forward_func``. Where that layer lives on this rank
    (same stage) it is hidden from the registry, so its weights count
    once; where the first occurrence is on another stage the proxy holds
    this stage's copy (``own``), registered."""

    def __init__(self, src: nn.Module, forward_func: Optional[Callable],
                 own: bool = False):
        super().__init__()
        if own:
            self.shared = src
        else:
            self._src = [src]
        self._forward_func = forward_func

    def _layer(self):
        return self.shared if "shared" in self._modules else self._src[0]

    def forward(self, *args):
        src = self._layer()
        if self._forward_func is not None:
            return self._forward_func(src, *args)
        return src(*args)


def _attr(layer, path):
    for part in path.split("."):
        layer = getattr(layer, part)
    return layer


class PipelineLayer(nn.Module):
    """Reference ``pp_layers.py:132``. ``layers``: ``LayerDesc`` /
    ``SharedLayerDesc`` / modules / callables, in order. Every layer is
    built in order on every rank (``build_device``, default the current
    one), so its initialisation draws what the pp = 1 model draws; then
    the layers are segmented into ``num_stages`` (default: the mesh's pp
    degree) by ``seg_method`` (``"uniform"``, or ``"layer:<Pattern>"``
    balancing only the layers whose class name matches) and, under a mesh
    with pp > 1 (or with ``stage`` given), a rank keeps its own stage's
    (``pipelined``). A list with no homogeneous run of blocks warns and is
    kept whole on every rank, run without the pipeline (the pp ranks then
    compute the same). ``loss_fn(output, label)`` gives the loss (default
    cross entropy), its mean over the microbatch (``loss_reduction =
    "mean"``). With ``recompute_interval`` > 0 every layer whose index is
    a multiple of it runs under ``torch.utils.checkpoint`` in training
    (drawing its first run's dropout masks again from the generators of
    ``recompute_generators``).
    A ``SharedLayerDesc`` whose occurrences fall on different stages has
    a copy on each; both copies' weights are marked ``pp_shared = key``,
    and the step all-reduces their gradients over pp."""

    loss_reduction = "mean"

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_microbatches=None, stage=None, build_device=None,
                 **kwargs):
        super().__init__()
        self._loss_fn = loss_fn
        self._topo = topology
        env = get_mesh_env()
        mesh_pp = env.get_dim("pp") if env is not None else 1
        if num_stages is None and topology is not None:
            num_stages = topology.get_dim("pipe")
        if num_stages is None:
            num_stages = mesh_pp
        self._num_stages = int(num_stages or 1)
        if stage is None and mesh_pp > 1 and self._num_stages == mesh_pp:
            stage = env.coord("pp")
        self._recompute_interval = int(recompute_interval)
        self.pp_microbatches = int(num_microbatches or 0)
        self.descs = list(layers)
        built, shared_first = [], {}
        with torch.device(build_device) if build_device is not None \
                else contextlib.nullcontext():
            for i, d in enumerate(self.descs):
                if isinstance(d, SharedLayerDesc):
                    if d.layer_name in shared_first:
                        j = shared_first[d.layer_name]
                        built.append(_SharedProxy(built[j], d.forward_func))
                    else:
                        shared_first[d.layer_name] = i
                        built.append(d.build_layer())
                elif isinstance(d, LayerDesc):
                    built.append(d.build_layer())
                elif isinstance(d, nn.Module):
                    built.append(d)
                elif callable(d):
                    built.append(_FnLayer(d))
                else:
                    raise TypeError(f"bad pipeline element {d!r}")
        # every parameter of the whole model, in order (an initialiser that
        # draws them all keeps this stage's: GPTForCausalLMPipe)
        self.full_param_shapes = [
            (f"run_function.{i}.{n}", tuple(p.shape))
            for i, layer in enumerate(built)
            if not isinstance(layer, _SharedProxy)
            for n, p in layer.named_parameters()]
        self.shared_first = dict(shared_first)
        self.recompute_generators: List[torch.Generator] = []
        self.segment_parts = self._segment(len(built), self._num_stages,
                                           seg_method, layers=built)
        self.pipelined = stage is not None and self._num_stages > 1
        if self.pipelined and find_homogeneous_run(
                built, min_len=max(self._num_stages, 2)) is None:
            warnings.warn(
                "PipelineLayer: mesh has pp>1 but no homogeneous layer run "
                "was found to pipeline; executing sequentially (every stage "
                "replicated). Repeated identical blocks pipeline best.")
            self.pipelined = False
        self.stage_id = int(stage) if self.pipelined else 0
        lo, hi = (self.segment_parts[self.stage_id],
                  self.segment_parts[self.stage_id + 1]) \
            if self.pipelined else (0, len(built))
        self.first = lo == 0
        self.last = hi == len(built)
        self._shared_shapes = {}
        self._shared_marks = []  # (kept layer key, weight path, key)
        kept = {}
        for i in range(lo, hi):
            layer = built[i]
            d = self.descs[i]
            if isinstance(layer, _SharedProxy) and not lo <= \
                    shared_first[d.layer_name] < hi:
                # the first occurrence is on another stage: hold a copy
                layer = _SharedProxy(layer._src[0], d.forward_func, own=True)
                self._shared_marks.append(
                    (str(i), "shared." + d.shared_weight_attr, d.layer_name))
            elif isinstance(d, SharedLayerDesc) and self.pipelined:
                later = [j for j, e in enumerate(self.descs)
                         if isinstance(e, SharedLayerDesc) and
                         e.layer_name == d.layer_name and j != i]
                if any(not lo <= j < hi for j in later):
                    self._shared_marks.append(
                        (str(i), d.shared_weight_attr, d.layer_name))
            kept[str(i)] = layer
        self.run_function = nn.ModuleDict(kept)
        self.mark_shared()

    def mark_shared(self):
        """Marks this stage's copies of the weights tied across stages
        (``pp_shared = key``); every parameter of a later stage's copy of
        a shared layer also takes the first holder's name (``ckpt_name``,
        ``ckpt_copy``: a checkpoint holds the layer once, as at pp = 1).
        Again after a call that makes new parameters (``to_empty``)."""
        for idx, path, key in self._shared_marks:
            w = _attr(self.run_function[idx], path)
            w.pp_shared = key
            self._shared_shapes[key] = tuple(w.shape)
            if path.startswith("shared."):
                first = self.shared_first[key]
                for n, p in self.run_function[idx].shared.named_parameters():
                    p.ckpt_name = f"run_function.{first}.{n}"
                    p.ckpt_copy = True

    def pp_shared_shapes(self):
        """{key: shape} of the weights tied across stages."""
        return dict(self._shared_shapes)

    @staticmethod
    def _segment(n, stages, seg_method, layers=None):
        """Reference ``_segment_network`` (``:282``): a uniform split by
        layer count, or ``"layer:<Pattern>"`` balancing only the layers
        whose class name matches (the edge layers then ride with their
        neighbours); too few matches warn and fall back to uniform."""
        if isinstance(seg_method, str) and seg_method.startswith("layer:") \
                and layers is not None:
            pat = seg_method[len("layer:"):]
            weights = [1 if re.search(pat, type(l).__name__) else 0
                       for l in layers]
            total = sum(weights)
            if total < stages:
                warnings.warn(
                    f"PipelineLayer seg_method={seg_method!r}: only {total} "
                    f"layers match for {stages} stages; falling back to the "
                    f"uniform layer-count split")
                return PipelineLayer._uniform(n, stages)
            parts = [0]
            prefix = [0]
            for w in weights:
                prefix.append(prefix[-1] + w)
            for s in range(1, stages):
                want = round(s * total / stages)
                idx = parts[-1] + 1  # stages must be non-empty
                while idx < n - (stages - s - 1) and prefix[idx] < want:
                    idx += 1
                parts.append(idx)
            parts.append(n)
            return parts
        return PipelineLayer._uniform(n, stages)

    @staticmethod
    def _uniform(n, stages):
        base, extra = divmod(n, stages)
        parts = [0]
        for s in range(stages):
            parts.append(parts[-1] + base + (1 if s < extra else 0))
        return parts

    def get_stage_layers(self, stage_id):
        """The layers of stage ``stage_id`` (those this rank holds)."""
        lo, hi = self.segment_parts[stage_id], \
            self.segment_parts[stage_id + 1]
        missing = [i for i in range(lo, hi)
                   if str(i) not in self.run_function]
        if missing:
            raise ValueError(f"stage {stage_id}'s layers are built on "
                             f"another rank")
        return [self.run_function[str(i)] for i in range(lo, hi)]

    def _run(self, x):
        for key, layer in self.run_function.items():
            if (self._recompute_interval > 0 and self.training and
                    int(key) % self._recompute_interval == 0 and
                    torch.is_grad_enabled()):
                # the recompute draws the first run's dropout masks again
                x = checkpoint(rewinding(layer, self.recompute_generators),
                               x, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x)
        return x

    def forward(self, x):
        """The layers this rank holds over ``x`` (the whole model where it
        is not pipelined)."""
        return self._run(x)

    def _loss(self, out, y):
        if self._loss_fn is not None:
            return self._loss_fn(out, y)
        return torch.nn.functional.cross_entropy(out, y)

    def compute_loss(self, x, y):
        return self._loss(self.forward(x), y)

    def pipeline_forward(self, inp, x, y=None):
        """One microbatch through this stage: the first stage starts from
        ``x``, the others from ``inp``; the last returns the loss (with
        ``y``) or the output."""
        out = self._run(x if self.first else inp)
        if self.last and y is not None:
            return self._loss(out, y)
        return out
