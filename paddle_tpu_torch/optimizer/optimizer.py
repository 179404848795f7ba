"""Optimizers: the ``Optimizer`` base, ``Adam`` and ``AdamW``.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: ``Optimizer`` :30
(``get_lr`` :118, ``step`` :365, ``clear_grad`` :482, master weights
:145 and :548), ``Adam`` :663 (``_rule`` :682) and ``AdamW`` :724
(``_rule`` :745), with the same update: decoupled decay
``p *= 1 - lr * coeff`` for every parameter that ``apply_decay_param_fun``
does not exempt, then Adam with bias correction by the step t (from 1)
and epsilon outside the square root. With ``multi_precision=True`` each
bf16/f16 parameter keeps an f32 master and f32 moments; the update runs
on the master and the parameter becomes the master cast back.

The JAX package jits the whole update into one program; the port updates
each parameter in place, eagerly. Not ported yet: learning-rate
schedules (``optimizer/lr.py``; the learning rate is a float),
``grad_clip`` (``nn/clip.py``), ``acc_dtype``, ``Adam``'s coupled L2
``weight_decay``, parameter groups, sparse gradients, and the state dict.
"""
from __future__ import annotations

import torch

__all__ = ["Optimizer", "Adam", "AdamW"]


class Optimizer:
    """Base: holds the parameters, their accumulator slots and f32
    masters, and the step count. ``parameters`` is an iterable of tensors,
    or of ``(name, tensor)`` pairs as ``named_parameters()`` gives them
    (the names that ``AdamW``'s ``apply_decay_param_fun`` sees); a tensor
    without a name is named by its index in the list."""

    _accumulator_names: tuple = ()

    def __init__(self, learning_rate=0.001, parameters=None,
                 multi_precision=False):
        if parameters is None:
            raise ValueError("parameters must be provided")
        items = list(parameters)
        named = [it if isinstance(it, tuple) else (str(i), it)
                 for i, it in enumerate(items)]
        self._parameter_list = [p for _, p in named]
        self._names = [n for n, _ in named]
        self._learning_rate = float(learning_rate)
        self._multi_precision = multi_precision
        self._accumulators: dict[str, torch.Tensor] = {}  # "slot@index"
        self._master_weights: dict[int, torch.Tensor] = {}  # index -> f32
        self._step_count = 0

    def get_lr(self) -> float:
        return self._learning_rate

    def _state(self, i, p):
        """(work tensor, slot dict) of parameter ``i``, made on first use:
        the f32 master (or the parameter itself) and zero moments, f32
        under multi_precision, else in the parameter's dtype."""
        if (self._multi_precision and i not in self._master_weights
                and p.dtype in (torch.bfloat16, torch.float16)):
            self._master_weights[i] = p.detach().float()
        work = self._master_weights.get(i, p)
        dtype = torch.float32 if self._multi_precision else p.dtype
        slots = {}
        for slot in self._accumulator_names:
            key = f"{slot}@{i}"
            if key not in self._accumulators:
                self._accumulators[key] = torch.zeros_like(p, dtype=dtype)
            slots[slot] = self._accumulators[key]
        return work, slots

    def _decay_flag(self, name) -> bool:
        return True

    def _update(self, p, g, slots, lr, t, apply_decay):
        """Update ``p`` and ``slots`` in place (the JAX ``_rule``)."""
        raise NotImplementedError

    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter that has a gradient."""
        self._step_count += 1
        lr, t = self.get_lr(), self._step_count
        for i, p in enumerate(self._parameter_list):
            if not p.requires_grad or p.grad is None:
                continue
            work, slots = self._state(i, p)
            self._update(work, p.grad.to(work.dtype), slots, lr, t,
                         self._decay_flag(self._names[i]))
            if work is not p:
                p.copy_(work)

    def clear_grad(self):
        for p in self._parameter_list:
            p.grad = None


class Adam(Optimizer):
    _accumulator_names = ("moment1", "moment2")

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, multi_precision=False):
        super().__init__(learning_rate, parameters, multi_precision)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _update(self, p, g, slots, lr, t, apply_decay):
        b1, b2 = self._beta1, self._beta2
        m, v = slots["moment1"], slots["moment2"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        p.sub_(lr * mhat / (vhat.sqrt() + self._epsilon))


class AdamW(Adam):
    """Adam with decoupled weight decay (default coefficient 0.01);
    ``apply_decay_param_fun(name) -> bool`` exempts parameters by name."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, multi_precision=False):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         multi_precision)
        self._coeff_wd = float(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_flag(self, name):
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(name))
        return True

    def _update(self, p, g, slots, lr, t, apply_decay):
        if apply_decay and self._coeff_wd:
            p.mul_(1.0 - lr * self._coeff_wd)
        super()._update(p, g, slots, lr, t, apply_decay)
