"""A training step over every stage of a pipeline on one device: the harness
that holds ``meta_parallel.pipeline_local`` against the sequential model.

``chip_smoke.py``'s pipeline phase and the tests drive the whole 1F1B
schedule on one card (or the CPU) with it; the users' pipelined step is
``distributed.ShardedTrainStep`` over a pp mesh, one stage a process.
Import it with ``tools/`` on ``sys.path``:

    sys.path.insert(0, os.path.join(repo_root, "tools"))
    from pipeline_harness import LocalPipelineStep
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from paddle_tpu_torch.distributed.meta_parallel import pipeline_local
from paddle_tpu_torch.jit import _Step

__all__ = ["LocalPipelineStep", "shared_sums"]


def shared_sums(pairs) -> None:
    """Tied weights across stages: for each ``pp_shared`` key, every
    holder's fp32 gradient sum becomes their total (Paddle's shared-weight
    all-reduce, on one process). ``pairs``: (parameter, its sum)."""
    shared: Dict[str, list] = {}
    for p, a in pairs:
        key = getattr(p, "pp_shared", None)
        if key is not None and a is not None:
            shared.setdefault(key, []).append(a)
    with torch.no_grad():
        for accs in shared.values():
            if len(accs) > 1:
                total = accs[0]
                for a in accs[1:]:
                    total = total + a
                for a in accs:
                    a.copy_(total)


class LocalPipelineStep(_Step):
    """:func:`pipeline_local` over ``stages``, the tied weights' gradient
    sums added across stages (:func:`shared_sums`), then one update of
    ``optimizer`` (over every stage's parameters) from the fp32 sums.
    Returns the step's loss: the sum of the microbatch losses where the
    last stage's ``loss_reduction`` is ``"sum"`` (each microbatch's share
    of the batch, ``LlamaForCausalLM``), their mean otherwise (the
    gradients then scaled by 1 / M). On a CUDA model each call is one
    captured CUDA graph (``jit.TrainStep``'s machinery; ``graph=False``:
    eager)."""

    def __init__(self, stages: Sequence[torch.nn.Module], optimizer,
                 num_microbatches: int, graph: bool = True):
        super().__init__(torch.nn.ModuleList(stages), None, optimizer,
                         graph=graph)
        self.stages = list(stages)
        self.num_microbatches = int(num_microbatches)
        self.loss_reduction = getattr(self.stages[-1], "loss_reduction",
                                      "mean")

    def _body(self, *batch):
        m = self.num_microbatches
        mean = self.loss_reduction != "sum"
        losses, accs = pipeline_local(self.stages, *batch,
                                      num_microbatches=m,
                                      grad_scale=(1.0 / m) if mean else None)
        pairs = [(p, a) for st, acc in zip(self.stages, accs)
                 for p, a in zip([q for q in st.parameters()
                                  if q.requires_grad], acc)]
        shared_sums(pairs)
        grads = {id(p): a for p, a in pairs}
        opt_batch = self.optimizer._apply(
            [grads.get(id(p)) for p in self.optimizer._parameter_list])
        return (losses.mean() if mean else losses.sum()), opt_batch

    def __call__(self, *batch):
        return self._run(*batch)
