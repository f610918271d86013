"""One training step (port of ``paddle_tpu/jit`` ``TrainStep`` and
``AccumulateStep``).

The JAX ``TrainStep`` traces forward, backward, clip and update into one
executable with donated buffers (``paddle_tpu/jit/__init__.py:289-405``).
Here a step on a CUDA model is one captured ``torch.cuda.CUDAGraph``,
replayed per call: the forward and the backward (autograd's tape, the
hand-written kernels launched on the capturing stream), the fused
optimizer update (``kernels/optimizer.py``) and the gradients' reset. The
tensors a replay reads and writes stay at their addresses, as donated
buffers do: the parameters and the optimizer state where they are, the
gradients and activations in the graph's private pool, the batch in
static input buffers that each call copies into.

- The first call on an input signature (shapes, dtypes, devices) runs
  eagerly on a side stream: it builds the kernel library, creates the
  optimizer state, cuBLAS's workspace and the kernels' one-time settings.
  It is a real step. The next call captures the step on that stream and
  replays it once; each later call replays it. A new signature gets a
  graph of its own, as JAX retraces; so does a parameter or a state
  tensor moved to new storage since its capture (``set_state_dict``).
- The learning rate and the step number reach the kernels through the
  header of the optimizer's chunk table, which the host writes before each
  replay (``StepBatch.set_step``), so an ``LRScheduler`` or ``set_lr``
  takes effect at the next call. The table's device buffer is allocated
  before the capture, outside the graph's pool: what the host writes
  between replays must lie where no node of the graph writes.
- The wrappers count their launches in Python, which a replay does not
  run: ``captured_launches`` and ``replays`` let a caller reckon them.
- Dropout draws fresh masks on every replay: before the capture the
  generators the model's dropouts draw from are registered with the graph
  (``CUDAGraph.register_generator_state``; torch's default generator is
  registered by torch itself), so each replay reads its generator's seed
  and offset when it starts and advances the offset, as an eager step
  would. A replay equals the eager step from the same generator state. On
  a torch without that call a model with active dropout raises rather
  than replay the capture's masks. A checkpointed region draws its first
  run's masks again (``nn.functional.common.rewinding``): in a graph from
  twin generators, registered with it too, which the eager warm-up step
  records and each replay arms (``Rewinds``).
- Nothing falls back: a capture or replay that fails raises. A capture
  fails where an autograd graph built on another stream still holds the
  parameters' gradient accumulators (a loss kept from an eager step on the
  default stream): free it before the first graphed call.

On the CPU, and on the card when the caller asks with ``graph=False``, the
step runs eagerly: the same three phases in order. That eager step is the
reference the graphed one is checked against.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import kernels
from ..nn.functional.common import Rewinds, drawing_generator, rewinding

__all__ = ["TrainStep", "AccumulateStep"]


def _active_generators(model: torch.nn.Module, device=None):
    """The distinct generators that the model's active dropouts (``p`` or
    ``dropout_p`` above 0) draw from: their ``generator`` attribute, or
    with ``device`` given, torch's default generator there for a dropout
    that holds none."""
    out: Dict[int, torch.Generator] = {}
    for m in model.modules():
        p = getattr(m, "p", getattr(m, "dropout_p", 0.0))
        if not isinstance(p, (int, float)) or p <= 0.0 or \
                not hasattr(m, "generator"):
            continue
        g = m.generator
        if g is None:
            if device is None:
                continue
            g = drawing_generator(None, device)
        out[id(g)] = g
    return list(out.values())


def _dropout_generators(model: torch.nn.Module) -> List[torch.Generator]:
    """The distinct CUDA generators that the model's active dropouts
    (``p`` or ``dropout_p`` above 0, a ``generator`` attribute) draw from;
    raises on a torch that cannot register them with a graph."""
    out = {id(g): g for g in _active_generators(model)
           if g.device.type == "cuda"}
    if out and not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        raise RuntimeError(
            "TrainStep: this torch cannot register a dropout generator with "
            "a CUDA graph, and the graph would replay one mask forever; "
            "use graph=False or dropout 0")
    return list(out.values())


class _Captured:
    """One input signature's graph and what it must keep alive: the static
    inputs it reads, the loss it writes, the step tables (a ``StepBatch``
    or a list of them, each header written before each replay) and the
    addresses it baked in."""

    def __init__(self, graph, inputs, loss, batch, addresses, counts,
                 rewinds):
        self.graph = graph
        self.inputs = inputs
        self.loss = loss
        self.batch = batch
        self.addresses = addresses
        self.counts = counts
        self.rewinds = rewinds  # [(Rewinds, twins, offsets)]


class _Step:
    """What a graphed step and a graphed accumulation window share: the
    choice of eager or graph, warm-up, capture and replay. A subclass
    gives ``_body(*batch) -> (fp32 loss, StepBatch, a list of them, or
    None)``: the step's work without advancing the optimizer's step
    number."""

    warmup_steps = 1

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer,
                 graph: bool = True):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.graph = bool(graph)
        self.captures = 0
        self.replays = 0
        self.debug_dump: Optional[str] = None
        self._replayed: Dict[str, int] = {}  # launches the replays made
        self._graphs: Dict[tuple, _Captured] = {}
        self._seen: Dict[tuple, int] = {}
        self._offsets: Dict[tuple, list] = {}  # the warm-up's rewinds
        self._stream = None
        self._last_out = None  # what the last call's body returned beside
        # its loss (for a replay: what the capture's body returned)

    def _body(self, *batch):
        raise NotImplementedError

    # -- what a subclass whose step count lives elsewhere overrides ------------
    def _header_step(self) -> int:
        """The step number the optimizer's table header gets before a
        replay."""
        return self.optimizer._global_step + 1

    def _advance(self) -> None:
        """After a call: the optimizer's step count moves on."""
        self.optimizer._global_step += 1

    def _reserve(self, key) -> None:
        """Before the capture of signature ``key``: what the captured step
        must find allocated outside the graph's pool."""
        self.optimizer._reserve_table()

    def _device(self) -> torch.device:
        for p in self.optimizer._parameter_list:
            return p.device
        for p in self.model.parameters():
            return p.device
        return torch.device("cpu")

    def _run(self, *batch):
        self.model.train()
        dev = self._device()
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"{type(self).__name__}: the model is on {dev}; "
                             f"it runs on CUDA or the CPU")
        if dev.type == "cuda" and self.graph:
            return self._graphed(dev, batch)
        loss, self._last_out = self._body(*batch)
        self._advance()
        return loss

    # -- the graph -------------------------------------------------------------
    @staticmethod
    def _signature(batch) -> tuple:
        sig = []
        for a in batch:
            if isinstance(a, torch.Tensor):
                sig.append((tuple(a.shape), a.dtype, a.device))
            else:
                hash(a)  # a value the graph bakes in: it must be hashable
                sig.append(("value", a))
        return tuple(sig)

    def _addresses(self) -> tuple:
        opt = self.optimizer
        out = []
        for p in opt._parameter_list:
            out.append(p.data_ptr())
            out.extend(v.data_ptr() for v in opt._state.get(id(p), {}).values())
        return tuple(out)

    def _graphed(self, dev, batch):
        key = self._signature(batch)
        entry = self._graphs.get(key)
        if entry is not None and entry.addresses != self._addresses():
            del self._graphs[key]  # storage moved: capture again
            entry = None
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        opt = self.optimizer
        if entry is None:
            seen = self._seen.get(key, 0)
            if seen < self.warmup_steps:
                self._seen[key] = seen + 1
                self._stream.wait_stream(main)
                rewinds = [Rewinds.of(g) for g in _active_generators(
                    self.model, dev) if g.device.type == "cuda"]
                for r in rewinds:
                    r.record()
                try:
                    with torch.cuda.stream(self._stream):
                        loss, self._last_out = self._body(*batch)
                finally:
                    self._offsets[key] = [(r, r.stop()) for r in rewinds]
                main.wait_stream(self._stream)
                loss.record_stream(main)
                self._advance()
                return loss
            entry = self._capture(key, batch)
        for s, a in zip(entry.inputs, batch):
            if isinstance(a, torch.Tensor):
                s.copy_(a)
        if entry.batch is not None:
            step = self._header_step()
            for b in (entry.batch if isinstance(entry.batch, list)
                      else [entry.batch]):
                b.set_step(opt.get_lr(), step)
        for r, twins, offsets in entry.rewinds:
            r.arm(twins, offsets)
        entry.graph.replay()
        self._last_out = entry.batch
        self.replays += 1
        for n, c in entry.counts.items():
            self._replayed[n] = self._replayed.get(n, 0) + c
        self._advance()
        return entry.loss.clone()

    def _capture(self, key, batch) -> _Captured:
        opt = self.optimizer
        self._reserve(key)  # creates the state, then the table's buffer
        opt.clear_grad()  # the backward allocates them from the graph's pool
        # the warm-up's gradients and activations sit in the allocator's
        # cache, which the graph's private pool cannot reuse: return them
        # first (GPT-3 6.7B's bf16 gradients alone take 13.3 GB)
        torch.cuda.empty_cache()
        inputs = [a.clone() if isinstance(a, torch.Tensor) else a
                  for a in batch]
        # debug mode keeps the graph's description (keep_graph) to print it
        graph = torch.cuda.CUDAGraph(keep_graph=bool(self.debug_dump))
        if self.debug_dump:
            graph.enable_debug_mode()
        for gen in _dropout_generators(self.model):
            graph.register_generator_state(gen)
        # a checkpointed region's recompute draws from a twin of the
        # generator, one for each rewind the warm-up step made
        rewinds = []
        for r, offsets in self._offsets.get(key, []):
            twins = [r.generator.clone_state() for _ in offsets]
            for t in twins:
                graph.register_generator_state(t)
            rewinds.append((r, twins, offsets))
        before = kernels.counters()
        try:
            for r, twins, _ in rewinds:
                r.capture(twins)
            with torch.cuda.graph(graph, stream=self._stream):
                loss, opt_batch = self._body(*inputs)
        finally:
            used = [r.capture(None) for r, _, _ in rewinds]
        if used != [len(twins) for _, twins, _ in rewinds]:
            raise RuntimeError(
                f"{type(self).__name__}: the captured step rewound its "
                f"checkpointed regions {used} times, the eager step "
                f"{[len(t) for _, t, _ in rewinds]}")
        after = kernels.counters()
        if self.debug_dump:
            graph.debug_dump(self.debug_dump)
            graph.instantiate()
        counts = {n: after[n]["launches"] - before[n]["launches"]
                  for n in after
                  if after[n]["launches"] != before[n]["launches"]}
        entry = _Captured(graph, inputs, loss, opt_batch, self._addresses(),
                          counts, rewinds)
        self._graphs[key] = entry
        self.captures += 1
        return entry

    def captured_launches(self) -> Dict[str, int]:
        """{kernel counter: launches the replays made}: each replay adds
        its graph's launches at capture (counted then, when the wrappers
        ran), a graph captured again since included.
        ``kernels.counters()`` holds the eager steps' launches and the
        captures'."""
        return dict(self._replayed)


class TrainStep(_Step):
    """``step = TrainStep(model, loss_fn, optimizer); loss = step(*batch)``.

    ``loss_fn(model, *batch)`` returns a scalar loss. A call puts the model
    in training mode, runs the forward and the backward, applies one
    optimizer update, clears the gradients and returns the loss as a fresh
    fp32 scalar on the model's device (reading it synchronises).

    On a CUDA model the call is a replay of one captured CUDA graph per
    input signature (the module docstring says how). ``graph=False`` asks
    for the eager step on the card instead, the reference a graphed step
    is checked against; on the CPU the step is eager whatever ``graph``
    says. ``debug_dump``, a path, makes the next capture in CUDA graph
    debug mode and writes its graph there (Graphviz DOT).
    """

    def _body(self, *batch):
        opt = self.optimizer
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        opt_batch = opt._apply()
        opt.clear_grad()
        return loss.detach().float(), opt_batch

    def __call__(self, *batch):
        return self._run(*batch)

    def accumulate(self, steps: int, remat: bool = False,
                   average: bool = True) -> "AccumulateStep":
        """Gradient accumulation as the JAX ``TrainStep.accumulate``
        (``paddle_tpu/jit/__init__.py:353-362``): one step over ``steps``
        microbatches of the full batch (dim 0 must divide by ``steps``),
        gradients summed in fp32 (scaled 1/steps when ``average``), one
        clip and one update. It shares this step's model, optimizer and
        ``graph`` choice."""
        return AccumulateStep(self, steps, remat=remat, average=average)


class AccumulateStep(_Step):
    """One accumulation window (``TrainStep.accumulate``; JAX
    ``AccumulateStep``, ``paddle_tpu/jit/__init__.py:407-540``): the batch's
    dim 0 splits into ``steps`` microbatches; each runs its forward and
    backward (under ``torch.utils.checkpoint`` when ``remat``, as
    ``jax.checkpoint`` there), and its gradients are added into fp32
    accumulators, scaled by ``1 / steps`` when ``average``; then one clip
    and one update from those fp32 sums, which the optimizer's kernels read
    beside bf16 parameters without rounding the sum first. Returns the mean
    of the microbatch losses. On a CUDA model the window is one graph."""

    def __init__(self, step: TrainStep, steps: int, remat: bool = False,
                 average: bool = True):
        if int(steps) < 1:
            raise ValueError(f"accumulate: steps must be >= 1, got {steps}")
        super().__init__(step.model, step.loss_fn, step.optimizer,
                         graph=step.graph)
        self.steps = int(steps)
        self.remat = bool(remat)
        self.average = bool(average)

    def _loss(self, *mb):
        return self.loss_fn(self.model, *mb)

    def _body(self, *batch):
        k = self.steps
        opt = self.optimizer
        plist = opt._parameter_list
        train = [i for i, p in enumerate(plist) if p.requires_grad]
        params = [plist[i] for i in train]
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in params]
        scale = 1.0 / k if self.average else 1.0
        micro = [a.reshape((k, a.shape[0] // k) + tuple(a.shape[1:]))
                 if isinstance(a, torch.Tensor) else a for a in batch]
        losses = []
        gens = _active_generators(self.model, self._device()) \
            if self.remat else []
        for i in range(k):
            mb = [m[i] if isinstance(m, torch.Tensor) else m for m in micro]
            if self.remat:
                # the recompute draws the first run's dropout masks again
                loss = checkpoint(rewinding(self._loss, gens), *mb,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                loss = self._loss(*mb)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    if g is not None:
                        a.add_(g.float() * scale)
            losses.append(loss.detach().float())
        full: List[Optional[torch.Tensor]] = [None] * len(plist)
        for i, a in zip(train, acc):
            full[i] = a
        opt_batch = opt._apply(full)
        return torch.stack(losses).mean(), opt_batch

    def __call__(self, *batch):
        for a in batch:
            if isinstance(a, torch.Tensor) and (
                    a.dim() == 0 or a.shape[0] % self.steps != 0):
                raise ValueError(
                    f"accumulate({self.steps}): batch dim {tuple(a.shape)} "
                    f"must divide by the microbatch count")
        return self._run(*batch)
