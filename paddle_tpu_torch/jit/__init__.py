"""``TrainStep``: one training step of a model, its loss and optimizer.

Counterpart of ``paddle_tpu/jit/__init__.py`` ``TrainStep`` :602. The
JAX class traces forward, backward and the optimizer update into one
compiled program; the port runs the same step eagerly: forward,
``loss_fn``, ``backward``, ``optimizer.step()``, clear the gradients.
Capturing the step (CUDA graphs) is later work.
"""
from __future__ import annotations

import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer)``; ``step(x, labels=y)``
    runs one step and returns the loss; ``loss_fn`` receives the model's
    outputs, then the labels when they are given."""

    def __init__(self, model, loss_fn, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer

    def __call__(self, *args, labels=None):
        out = self.model(*args)
        outs = out if isinstance(out, tuple) else (out,)
        loss = (self.loss_fn(*outs) if labels is None
                else self.loss_fn(*outs, labels))
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()

    def run(self, *args, steps, labels=None):
        """``steps`` steps in a row; returns the (steps,) losses."""
        return torch.stack([self(*args, labels=labels)
                            for _ in range(int(steps))])
