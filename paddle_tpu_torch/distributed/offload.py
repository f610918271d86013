"""Optimizer-state offload for ``ShardedTrainStep`` (port of
``paddle_tpu/distributed/parallel.py:205-256, 722-816``).

``group_sharded_parallel(..., offload=True)`` marks the optimizer; the
step then keeps this rank's fp32 master of each trainable tensor it
updates (under ZeRO its shard or slice) and the optimizer's state in host
memory, page-locked where CUDA runs, and streams the update per group:

- the forward, the backward and the gradients' reduction run as the
  resident step runs them (on a CUDA model one captured graph a call);
- a global-norm clip is taken over the full gradient set before the walk,
  as the reference clips before its per-group update (``:767-772``);
- the walk goes over ``plan_stream_groups`` of the masters' fp32 bytes
  (``segment_size``, ``buffer_max_size``). While group i's update runs,
  the lane uploads group i + 1's master and state into the other of two
  device staging buffers, then downloads group i's new master and state;
  each group's new parameters are written in place on the device, so
  nothing is uploaded for them.

**The update runs on the card.** The reference runs it on its CPU
backend; here it is ``optimizer.make_master_update``, the rule's
multi-tensor CUDA kernels over the staged fp32 masters and states (on CPU
tensors their plain versions), so no plain PyTorch optimizer runs on the
path. The numbers are the same fp32 rule either way: at fp32 the
offloaded step equals the resident one bit for bit (elementwise rules over
whole tensors, one clip over all of them). The lane's schedule is
therefore (h2d state i, d2h state i), not the reference's (d2h gradients,
h2d parameters): ``ShardedTrainStep.stream_schedule()`` gives this order.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from ..jit.offload_stream import StreamLane, pin, plan_stream_groups, unpin
from ..kernels import optimizer as _kopt
from ..optimizer.optimizer import make_master_update

__all__ = ["OffloadedState", "OFFLOAD_AMP_ERROR"]

OFFLOAD_AMP_ERROR = (
    "ShardedTrainStep: in-graph GradScaler / per-call accum_steps windows "
    "are not supported together with optimizer-state offload; run the "
    "scaler eagerly, or use the fused step.accumulate(k) which composes "
    "with the streaming offload executor")

_ALIGN = 64  # elements: every staged tensor starts on a 256-byte boundary


def _env_on(name: str) -> bool:
    return os.environ.get(name, "1").strip().lower() not in ("0", "false",
                                                             "off")


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


class _Slot:
    """Where one tensor of a group lies in the group's flat region: its
    offset from the region's start, its shape."""

    __slots__ = ("off", "shape")

    def __init__(self, off, shape):
        self.off, self.shape = off, tuple(shape)

    def view(self, flat: torch.Tensor) -> torch.Tensor:
        n = 1
        for d in self.shape:
            n *= d
        return flat[self.off:self.off + n].view(self.shape)


class OffloadedState:
    """The host side of an offloaded optimizer for one step: one flat fp32
    host buffer (page-locked on a CUDA run) holding, group by group, each
    tensor's master and its state; two device staging buffers of the
    largest group; the lane; the groups. The optimizer's state dict
    (``optimizer._state``) holds the host views, so its ``state_dict``
    and the sharded checkpoints read the offloaded state."""

    def __init__(self, step, segment_size: int, buffer_max_size: int,
                 overlap: bool):
        opt = step.optimizer
        self.step = step
        self.live = [j for j, e in enumerate(step._plan)
                     if step._held(e).requires_grad]
        self.entries = [step._plan[j] for j in self.live]
        tensors = [e.opt for e in self.entries]
        if not tensors:
            raise ValueError("offload: the optimizer has no trainable tensor")
        self.device = tensors[0].device
        self.groups = plan_stream_groups(
            [t.numel() * 4 for t in tensors], segment_size, buffer_max_size)
        # the layout: per group a flat region, per tensor master + states
        protos = [opt._init_state(torch.empty(t.shape, dtype=torch.float32,
                                              device="meta"))
                  for t in tensors]
        self.master_at: List[_Slot] = [None] * len(tensors)
        self.state_at: List[Dict[str, _Slot]] = [None] * len(tensors)
        self.region = []  # (offset, size) of each group in the host buffer
        off = 0
        for grp in self.groups:
            start = off
            for k in grp:
                self.master_at[k] = _Slot(off - start, tensors[k].shape)
                off += _padded(tensors[k].numel())
                self.state_at[k] = {}
                for name, v in protos[k].items():
                    self.state_at[k][name] = _Slot(off - start, v.shape)
                    off += _padded(v.numel())
            self.region.append((start, off - start))
        cuda = self.device.type == "cuda"
        host = torch.empty(off, dtype=torch.float32)
        self.host = pin(host) if cuda else host
        with torch.no_grad():
            for gi, grp in enumerate(self.groups):
                flat = self._host_region(gi)
                for k in grp:
                    t = tensors[k]
                    self.master_at[k].view(flat).copy_(t.detach().float())
                    have = opt._state.get(id(t))
                    init = have if have is not None else opt._init_state(
                        torch.empty(t.shape, dtype=torch.float32))
                    for name, slot in self.state_at[k].items():
                        slot.view(flat).copy_(init[name])
        for gi, grp in enumerate(self.groups):
            flat = self._host_region(gi)
            for k in grp:
                opt._state[id(tensors[k])] = {
                    name: slot.view(flat)
                    for name, slot in self.state_at[k].items()}
        size = max(n for _, n in self.region)
        self.staging = [torch.empty(size, dtype=torch.float32,
                                    device=self.device) for _ in range(2)]
        self.lane = StreamLane(overlap=overlap)
        self._ups: Dict[int, object] = {}
        self._downs: Dict[int, object] = {}  # this walk's downloads

    # -- the buffers ------------------------------------------------------------
    def _host_region(self, gi: int) -> torch.Tensor:
        start, size = self.region[gi]
        return self.host[start:start + size]

    def _staged(self, gi: int) -> torch.Tensor:
        return self.staging[gi % 2][:self.region[gi][1]]

    def masters(self) -> List[torch.Tensor]:
        """The fp32 masters in the host buffer (a host read: waits for the
        downloads in flight)."""
        self._drain()
        out = [None] * len(self.entries)
        for gi, grp in enumerate(self.groups):
            flat = self._host_region(gi)
            for k in grp:
                out[k] = self.master_at[k].view(flat)
        return out

    def _drain(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the lane ---------------------------------------------------------------
    def _up(self, gi: int):
        """Group ``gi``'s master and state up to its staging buffer, after
        the download of the group that used the buffer before it."""
        return self.lane.submit("h2d", [self._host_region(gi)],
                                [self._staged(gi)], tag=gi,
                                after=[self._downs.get(gi - 2)])

    def _down(self, gi: int):
        """Group ``gi``'s new master and state back to the host buffer."""
        return self.lane.submit("d2h", [self._staged(gi)],
                                [self._host_region(gi)], tag=gi)

    def prefetch(self):
        """Uploads the first two groups (called before the step's forward:
        they overlap it). Returns once the worker has issued them, so that
        it makes no CUDA call while the step captures its graph."""
        for gi in range(min(2, len(self.groups))):
            if gi not in self._ups:
                self._ups[gi] = self._up(gi)
                self._ups[gi].wait_dispatched()

    # -- the walk ----------------------------------------------------------------
    def _group_norms(self, norms, idx):
        n = (norms.numel() - 1) // 2
        pick = torch.tensor(idx, dtype=torch.long, device=norms.device)
        return torch.cat([norms[pick], norms[n + pick], norms[2 * n:]])

    def _group_split(self, gi, views):
        """The step's ``TensorSplits`` keyed by this group's staged masters
        (None where no tensor is split)."""
        splits = self.step._splits
        if splits is None:
            return None
        axes = []
        for pg, n, dims in splits.axes:
            mine = {}
            for k, v in zip(self.groups[gi], views):
                d = dims.get(id(self.entries[k].opt))
                if d is not None:
                    mine[id(v)] = d
            axes.append((pg, n, mine))
        return _kopt.TensorSplits(axes)

    @torch.no_grad()
    def walk(self, grads: List[Optional[torch.Tensor]], lr: float,
             step_no: int, clip, norms):
        """One update over every group: ``grads`` one per live entry (the
        reduced gradient, shaped as the tensor the optimizer updates, or
        None), ``clip`` / ``norms`` the clip over all of them."""
        self.prefetch()
        self._downs = {}
        n_groups = len(self.groups)
        for gi, grp in enumerate(self.groups):
            self._ups.pop(gi).wait()
            flat = self._staged(gi)
            live = [k for k in grp if grads[k] is not None]
            if live:
                masters = [self.master_at[k].view(flat) for k in live]
                states = [{name: s.view(flat) for name, s in
                           self.state_at[k].items()} for k in live]
                kw = {}
                if clip[0] != "none":
                    kw["clip"] = clip
                    kw["norms"] = None if norms is None else \
                        self._group_norms(norms, live)
                kw["split"] = self._group_split(gi, masters)
                tensors = [self.entries[k].opt for k in live]
                update = make_master_update(self.step.optimizer, tensors,
                                            [t.dtype for t in tensors],
                                            with_clip=False)
                _, _, new = update(masters, [grads[k] for k in live], states,
                                   lr, step_no, **kw)
                for k, p in zip(live, new):
                    self.entries[k].opt.copy_(p)
            self._downs[gi] = self._down(gi)
            if gi + 2 < n_groups:
                self._ups[gi + 2] = self._up(gi + 2)
        for h in self._downs.values():
            if h is not None:
                h.wait()
        self._downs = {}

    def close(self):
        """Stops the lane's worker and releases the host buffer's lock (the
        state stays readable, pageable)."""
        self.lane.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            unpin(self.host)
