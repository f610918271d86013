"""The per-mode model wrappers and the hybrid optimizer (port of
``paddle_tpu/distributed/meta_parallel/wrappers.py``; reference
``fleet/meta_parallel/{tensor_parallel.py:25, sharding_parallel.py,
pipeline_parallel.py:152}`` and ``fleet/meta_optimizers/
dygraph_optimizer/hybrid_parallel_optimizer.py``).

The JAX wrappers annotate and its compiled step communicates; here the
step is ``ShardedTrainStep``: ``PipelineParallel.train_batch`` builds one
per (optimizer, scaler, window) and calls it, so the in-graph scaler and
gradient merge ride the pipeline as they do there.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..mesh import get_mesh_env

__all__ = ["TensorParallel", "ShardingParallel", "PipelineParallel",
           "HybridParallelOptimizer", "HybridParallelGradScaler"]


class _MetaParallelBase(nn.Module):
    def __init__(self, layers: nn.Module, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def parameters(self, recurse=True):
        return self._layers.parameters(recurse)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def load_state_dict(self, *a, **k):
        return self._layers.load_state_dict(*a, **k)

    set_state_dict = load_state_dict


class TensorParallel(_MetaParallelBase):
    """Reference ``tensor_parallel.py:25``: the replicas of each shard made
    equal at wrap time (``place_model``: each parameter broadcast within
    the ranks that hold the same shard of it)."""

    def __init__(self, layers, hcg=None, strategy=None):
        from ..parallel import place_model

        super().__init__(layers, hcg, strategy)
        place_model(layers)


class ShardingParallel(TensorParallel):
    """The sharding wrapper: replicas made equal as above. The ZeRO split
    itself is ``group_sharded_parallel``'s (the optimizer over this rank's
    slices) and ``ShardedTrainStep``'s."""


class PipelineParallel(_MetaParallelBase):
    """Reference ``pipeline_parallel.py:152``. ``train_batch((x, y),
    optimizer)`` is one update: under a mesh a ``ShardedTrainStep`` over
    the wrapped model (cached per optimizer, scaler and window), whose
    1F1B schedule runs ``accumulate_steps`` microbatches of this rank's
    batch on a pipelined model (``_pp_window``); a model that is not
    pipelined takes the window as ``ShardedTrainStep.accumulate``, or,
    where a scaler or an offloaded optimizer meets it, as the reference's
    eager microbatch loop (``ShardedTrainStep.eager_window``). A
    ``HybridParallelOptimizer``'s gradient merge becomes the step's
    ``accum_steps`` and a scaler its in-graph scaler. Without a mesh the
    eager loop runs (JAX ``wrappers.py:141-239``)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        self._steps = {}

    def _loss_fn(self, model, x, y):
        if hasattr(model, "compute_loss"):
            return model.compute_loss(x, y)
        return torch.nn.functional.cross_entropy(model(x), y)

    def _pp_window(self, n):
        """The microbatches of one ``train_batch`` call, from
        ``strategy.pipeline_configs``: ``accumulate_steps``, or with
        ``micro_batch_size`` alone the batch over it; both set must agree
        with the batch ``n`` fed (a mismatch raises); a
        ``micro_batch_size`` of 1 reads as unset (the default)."""
        strat = self._strategy
        if strat is None or not getattr(strat, "pipeline", False):
            return 1
        cfg = getattr(strat, "pipeline_configs", None) or {}
        k = int(cfg.get("accumulate_steps", 1))
        mbs = int(cfg.get("micro_batch_size", 1))
        if k > 1 and mbs > 1 and n != k * mbs:
            raise ValueError(
                f"pipeline_configs: global batch {n} != accumulate_steps "
                f"{k} * micro_batch_size {mbs}; feed batches of {k * mbs} "
                f"or fix the config")
        if k == 1 and mbs > 1:
            if n % mbs:
                raise ValueError(
                    f"pipeline_configs: global batch {n} does not divide "
                    f"by micro_batch_size {mbs}")
            k = n // mbs
        return k

    def _step(self, key, make, optimizer):
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = make()
            if hasattr(optimizer, "_attach_step"):
                optimizer._attach_step(getattr(step, "_step", step))
        return step

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        from ..parallel import ShardedTrainStep

        x, y = data
        env = get_mesh_env()
        inner = getattr(optimizer, "_inner_opt", optimizer)
        gm_k = int(getattr(optimizer, "_gm_k", 1))
        gm_avg = bool(getattr(optimizer, "_gm_avg", True))
        sc = getattr(scaler, "_scaler", scaler)
        pp_k = self._pp_window(int(x.shape[0]))
        if env is None:
            return self._eager_batch(x, y, optimizer, pp_k, scaler,
                                     lr_scheduler)
        pipelined = bool(getattr(self._layers, "pipelined", False))
        offload = bool(getattr(inner, "_offload", False))
        if gm_k == 1 and not pipelined and (
                (pp_k > 1 and (sc is not None or offload))
                or (offload and sc is not None)):
            # the reference's eager microbatch loop (``_eager_accum_batch``):
            # the window's semantics where the graphed step cannot host a
            # scaler beside the accumulation or the offload
            step = self._step(("eager", id(inner), pp_k), lambda: (
                ShardedTrainStep(self._layers, self._loss_fn, inner,
                                 env=env, graph=False)), optimizer)
            if int(x.shape[0]) % pp_k:
                raise ValueError(
                    f"pipeline_configs accumulate_steps={pp_k}: global "
                    f"batch dim {int(x.shape[0])} must divide by the "
                    f"microbatch count")
            loss = step.eager_window(pp_k, sc, x, y)
        else:
            if pp_k > 1 and gm_k == 1 and not pipelined:
                step = self._step(("accum", id(inner), pp_k), lambda: (
                    ShardedTrainStep(self._layers, self._loss_fn, inner,
                                     env=env).accumulate(pp_k)), optimizer)
            else:
                m = pp_k if pp_k > 1 else None
                step = self._step(
                    (id(inner), id(sc) if sc is not None else 0, gm_k, gm_avg,
                     m),
                    lambda: ShardedTrainStep(
                        self._layers, self._loss_fn, inner, env=env,
                        scaler=sc, accum_steps=gm_k, accum_avg=gm_avg,
                        num_microbatches=m),
                    optimizer)
            loss = step(x, y)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def _eager_batch(self, x, y, optimizer, k, scaler, lr_scheduler):
        """No mesh: the window as an eager loop, ``k`` microbatches of the
        batch, each loss / k backward, one update."""
        n = int(x.shape[0])
        if n % k:
            raise ValueError(
                f"pipeline_configs accumulate_steps={k}: global batch dim "
                f"{n} must divide by the microbatch count")
        mb = n // k
        total = None
        for i in range(k):
            loss = self._loss_fn(self._layers, x[i * mb:(i + 1) * mb],
                                 y[i * mb:(i + 1) * mb])
            part = loss * (1.0 / k) if k > 1 else loss
            (scaler.scale(part) if scaler is not None else part).backward()
            total = loss.detach() if total is None else total + loss.detach()
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total * (1.0 / k) if k > 1 else total

    @torch.no_grad()
    def eval_batch(self, data, compute_loss=True):
        """The forward alone: the loss (or the output) of ``data``; on a
        pipelined model every stage runs the microbatches' forwards in
        order, each handed to the next stage, and every stage returns the
        last stage's loss."""
        x, y = data
        model = self._layers
        if not getattr(model, "pipelined", False):
            if compute_loss:
                return self._loss_fn(model, x, y)
            return model(x)
        if not compute_loss:
            raise ValueError("PipelineParallel.eval_batch: a pipelined "
                             "model's outputs stay on its last stage; "
                             "ask for the loss")
        from ..parallel import DATA_AXES, default_batch_sharding, shard_batch
        from .pipeline import P2PTransport, microbatch

        env = get_mesh_env()
        pp, r = env.get_dim("pp"), env.coord("pp")
        k = self._pp_window(int(x.shape[0]))
        m = k if k > 1 else (getattr(model, "pp_microbatches", 0) or 2 * pp)
        spec_of = default_batch_sharding(env)
        local = [shard_batch(a, spec_of(a), env) for a in (x, y)]
        if hasattr(model, "pipeline_prepare"):
            model.pipeline_prepare(*local)
        dev = next(model.parameters()).device
        transport = P2PTransport(env.group("pp"), r, pp, dev)
        losses = []
        for mb in zip(*[microbatch(a, m) for a in local]):
            out = model.pipeline_forward(transport("recv_fwd", None), *mb)
            if r == pp - 1:
                losses.append(out.float())
            else:
                transport("send_fwd", out)
        mean = model.loss_reduction != "sum"
        if r == pp - 1:
            t = torch.stack(losses)
            loss = t.mean() if mean else t.sum()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
        dist.all_reduce(loss, group=env.group("pp"))
        dist.all_reduce(loss, group=env.group_over(DATA_AXES))
        n = env.size_over(DATA_AXES)
        return loss / n if mean and n > 1 else loss


class HybridParallelOptimizer:
    """Reference ``hybrid_parallel_optimizer.py`` and the strategy's
    meta-optimizers: the wrapped optimizer with

    - ``strategy.lamb`` / ``strategy.lars`` swapping its rule for Lamb /
      LarsMomentum (:meth:`_maybe_swap_rule`, the inner optimizer's rate,
      betas, epsilon, decay and clip carried over);
    - ``strategy.gradient_merge``: the update every ``k_steps`` backward
      passes (eager gradients add up in ``.grad`` between them; averaged
      when ``avg``), which ``PipelineParallel.train_batch`` turns into the
      step's ``accum_steps``; ``discard_merge_window`` drops a window;
    - ``strategy.localsgd``: after each update from ``begin_step`` on,
      every ``k_steps``-th averages the parameters over the data ranks.
    """

    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = self._maybe_swap_rule(optimizer, strategy)
        self._hcg = hcg
        self._gm_k, self._gm_avg, self._gm_count = 1, True, 0
        if strategy is not None and getattr(strategy, "gradient_merge",
                                            False):
            cfg = strategy.gradient_merge_configs
            self._gm_k = int(cfg.get("k_steps", 1))
            self._gm_avg = bool(cfg.get("avg", True))
        self._lsgd_k, self._lsgd_begin, self._lsgd_count = 0, 1, 0
        if strategy is not None and getattr(strategy, "localsgd", False):
            cfg = getattr(strategy, "localsgd_configs", {}) or {}
            self._lsgd_k = max(int(cfg.get("k_steps", 1)), 1)
            self._lsgd_begin = int(cfg.get("begin_step", 1))
        self._attached_steps = []

    @staticmethod
    def _maybe_swap_rule(optimizer, strategy):
        if strategy is None:
            return optimizer
        from ...optimizer import Lamb, LarsMomentum
        from ...optimizer.optimizer import _wd_value

        if getattr(strategy, "lamb", False) and not isinstance(optimizer,
                                                               Lamb):
            wd = getattr(optimizer, "_weight_decay_arg", None)
            wd = 0.01 if wd is None else _wd_value(wd)
            return Lamb(learning_rate=optimizer._learning_rate,
                        lamb_weight_decay=wd,
                        beta1=getattr(optimizer, "_b1", 0.9),
                        beta2=getattr(optimizer, "_b2", 0.999),
                        epsilon=getattr(optimizer, "_eps", 1e-6),
                        parameters=optimizer._parameter_list,
                        grad_clip=optimizer._grad_clip)
        if getattr(strategy, "lars", False) and not isinstance(
                optimizer, LarsMomentum):
            return LarsMomentum(learning_rate=optimizer._learning_rate,
                                momentum=getattr(optimizer, "_momentum", 0.9),
                                parameters=optimizer._parameter_list,
                                grad_clip=optimizer._grad_clip)
        return optimizer

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        if self._gm_k > 1:
            self._gm_count += 1
            if self._gm_count % self._gm_k:
                return  # the gradients keep adding up in .grad
            if self._gm_avg:
                for p in self._inner_opt._parameter_list:
                    if p.grad is not None:
                        p.grad.div_(self._gm_k)
        self._inner_opt.step()
        self._maybe_localsgd_sync()

    def _maybe_localsgd_sync(self):
        if not self._lsgd_k:
            return
        self._lsgd_count += 1
        if self._lsgd_count < self._lsgd_begin or \
                self._lsgd_count % self._lsgd_k:
            return
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return
        from ..parallel import DATA_AXES

        env = get_mesh_env()
        pg = env.group_over(DATA_AXES) if env is not None else None
        n = dist.get_world_size(pg)
        with torch.no_grad():
            for p in self._inner_opt._parameter_list:
                t = p.data.float()
                dist.all_reduce(t, group=pg)
                p.data.copy_(t / n)

    def clear_grad(self, set_to_zero: bool = False):
        # inside a merge window the gradients are kept (a loop may clear at
        # both ends of an iteration); discard_merge_window drops them
        if self._gm_k > 1 and self._gm_count % self._gm_k:
            return
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def _attach_step(self, step):
        """A ``ShardedTrainStep`` whose window this wrapper discards."""
        self._attached_steps.append(step)

    def discard_merge_window(self):
        """Drops the open gradient-merge window: the eager gradients, the
        window's count, and the fp32 sums of every attached step."""
        if self._gm_k > 1:
            self._gm_count -= self._gm_count % self._gm_k
        self._inner_opt.clear_grad()
        for step in self._attached_steps:
            if hasattr(step, "discard_accum_window"):
                step.discard_accum_window()

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        self.step()
        return None, None


class HybridParallelGradScaler:
    """The scaler, as given (the step runs its state machine)."""

    def __init__(self, scaler, hcg=None):
        self._scaler = scaler

    def __getattr__(self, item):
        return getattr(self._scaler, item)
