"""One training step (port of ``paddle_tpu/jit`` ``TrainStep``).

The JAX ``TrainStep`` traces forward, backward and the optimizer update into
one compiled executable. PyTorch runs eagerly, so here the step is the same
three phases in order, with autograd as the tape. The update is fused as
the JAX package fuses it: ``optimizer.step()`` applies the gradient clip,
the weight decay and the rule to every parameter in a few launches of the
multi-tensor kernels (``kernels/optimizer.py``), with the learning rate and
the step number read on the device. Capturing the whole step in a CUDA
graph is later work.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer); loss = step(*batch)``.

    ``loss_fn(model, *batch)`` returns a scalar loss. A call puts the model
    in training mode, runs the forward and the backward, applies one
    optimizer update, clears the gradients and returns the loss as a
    detached fp32 scalar (on the model's device; reading it synchronises).
    """

    def __init__(self, model: torch.nn.Module, loss_fn: Callable, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def __call__(self, *batch):
        self.model.train()
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach().float()
