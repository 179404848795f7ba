"""``TrainStep``: one training step of a model, its loss and optimizer.

Counterpart of ``paddle_tpu/jit/__init__.py`` ``TrainStep`` :602. The
JAX class traces forward, backward, the clip and the optimizer update into
one compiled program; the port runs the same step eagerly: forward,
``loss_fn``, ``backward``, ``optimizer.step()`` (which clips, then
launches the update kernel once a group of parameters), clear the
gradients. Capturing the step (CUDA graphs) is later work.

JAX takes ``jax.value_and_grad`` over every trainable parameter, so one
that the loss never reads (BERT's ``pre_ln`` in post-LN mode, its
token-type table when no ``token_type_ids`` are given) gets a zero
gradient: its moments advance and decoupled decay moves it. Autograd
leaves such a gradient None, and ``Optimizer.step`` skips a None gradient
as the JAX eager ``Optimizer.step`` does; so the step hands each such
parameter a zero gradient first, made once and kept (the optimizer only
reads a gradient).
"""
from __future__ import annotations

import torch

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, loss_fn, optimizer)``; ``step(x, labels=y)``
    runs one step and returns the loss; ``loss_fn`` receives the model's
    outputs, then the labels when they are given (one object: a tuple of
    several labels stays one argument). Positional and keyword arguments
    go to the model, so that ``TrainStep(model, lambda loss: loss,
    opt).run(ids, None, None, ids, steps=4)`` trains a LLaMA on its own
    ``labels`` loss, as bench.py does."""

    def __init__(self, model, loss_fn, optimizer):
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self._zero_grads = {}  # parameter -> its kept zero gradient

    def __call__(self, *args, labels=None, **kwargs):
        out = self.model(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        loss = (self.loss_fn(*outs) if labels is None
                else self.loss_fn(*outs, labels))
        loss.backward()
        for p in self.model.parameters():
            if p.requires_grad and p.grad is None:
                zero = self._zero_grads.get(p)
                if zero is None or zero.dtype != p.dtype or (
                        zero.device != p.device):
                    zero = self._zero_grads[p] = torch.zeros_like(p)
                p.grad = zero
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()

    def run(self, *args, steps, labels=None, **kwargs):
        """``steps`` steps in a row; returns the (steps,) losses."""
        return torch.stack([self(*args, labels=labels, **kwargs)
                            for _ in range(int(steps))])

    def _indices(self):
        """Parameter name -> the optimizer's index, for every trainable
        parameter of the model that the optimizer holds."""
        index = self.optimizer._param_index
        return {k: index[id(p)] for k, p in self.model.named_parameters()
                if p.requires_grad and id(p) in index}

    def state_dict(self):
        """The optimizer's state under JAX's ``TrainStep`` keys (:779):
        ``slot@name`` and ``master@name`` by the model's parameter names,
        and ``@step_count``; copies, as JAX's are."""
        opt, names = self.optimizer, self._indices()
        opt._ensure_state(names.values())
        out = {}
        for name, i in names.items():
            for slot in opt._accumulator_names:
                out[f"{slot}@{name}"] = opt._accumulators[
                    f"{slot}@{i}"].clone()
            if i in opt._master_weights:
                out[f"master@{name}"] = opt._master_weights[i].clone()
        out["@step_count"] = opt._step_count
        return out

    def set_state_dict(self, state):
        """Load a state dict of :meth:`state_dict`'s keys (a JAX
        ``TrainStep.state_dict()``, its arrays as numpy arrays, included)."""
        names = self._indices()
        mapped = {}
        for key, v in state.items():
            if key == "@step_count":
                mapped[key] = v
                continue
            slot, name = key.split("@", 1)
            mapped[f"{slot}@{names[name]}"] = v
        self.optimizer.set_state_dict(mapped)
