"""Optimizers: the ``Optimizer`` base, ``Adam`` and ``AdamW``.

Counterpart of ``paddle_tpu/optimizer/optimizer.py``: ``Optimizer`` :30
with JAX's constructor ``(learning_rate, parameters, weight_decay,
grad_clip, multi_precision, name)``, ``Adam`` :663 and ``AdamW`` :724.

- ``learning_rate`` is a float or an ``optimizer.lr`` scheduler
  (``get_lr`` :118, ``set_lr``, ``set_lr_scheduler``).
- ``parameters`` is an iterable of tensors, of ``(name, tensor)`` pairs as
  ``named_parameters()`` gives them (the names that ``AdamW``'s
  ``apply_decay_param_fun`` sees; an unnamed tensor is named by its index
  in the flat list), or of parameter groups: dicts with JAX's keys
  (``params``, ``learning_rate``, ``weight_decay``, ``grad_clip``,
  ``name``; :34-95). A group's ``learning_rate`` multiplies the
  optimizer's; its ``weight_decay`` and ``grad_clip`` override the
  optimizer's for its parameters.
- ``grad_clip`` (``nn.clip``) clips each (group, clip object) apart
  (``_partition_by_clip`` :349), inside ``step``.
- ``weight_decay`` is a float or an object with ``.coeff``: coupled L2
  folded into the gradient for ``Adam`` (``_decay_grad`` :176), decoupled
  decay ``p *= 1 - lr * coeff`` for ``AdamW`` where
  ``apply_decay_param_fun`` does not exempt the parameter.
- ``multi_precision=True`` keeps an f32 master and f32 moments for each
  bf16/f16 parameter; the update runs on the master and the parameter
  becomes its cast.
- ``state_dict``/``set_state_dict`` use JAX's keys (:562): ``slot@index``,
  ``master@index``, ``@step_count`` and ``LR_Scheduler``; a JAX state dict
  with its arrays as numpy arrays loads as it is.

The JAX package jits the whole update into one XLA program per parameter
list (``_build_update`` :251). The port's counterpart is one launch of a
hand-written multi-tensor kernel per group of parameters that share their
dtypes (``ops/cuda/multi_tensor_adam.py``), over a table of the tensors
built once per parameter list; the learning rate, t and the clip scales
reach it through a small device buffer, so the step never waits for the
card. Sparse gradients are not ported (``lazy_mode=True`` raises).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.cuda.multi_tensor_adam import AdamTensors, multi_tensor_adam
from .lr import LRScheduler

__all__ = ["Optimizer", "Adam", "AdamW"]

def _as_dtype(d):
    """None, a torch dtype, or a dtype's name ("bfloat16") as a dtype."""
    t = getattr(torch, d, None) if isinstance(d, str) else d
    if t is not None and not isinstance(t, torch.dtype):
        raise TypeError(f"unsupported dtype {d!r}")
    return t


def _as_tensor(v, like):
    """A state-dict value (a tensor or a numpy array, bf16 ones included)
    as a tensor of ``like``'s dtype and device."""
    if not isinstance(v, torch.Tensor):
        v = torch.from_numpy(np.array(v, dtype=np.float32))
    return v.to(device=like.device, dtype=like.dtype).clone()


class Optimizer:
    """Base: the parameters and their groups, the accumulator slots, the
    f32 masters, the step count and the state dict. A subclass gives
    ``_accumulator_names`` and ``_update``."""

    _accumulator_names: tuple = ()
    _group_keys = frozenset(
        {"params", "learning_rate", "weight_decay", "grad_clip", "name"})

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        items = list(parameters)
        # parameter index -> its group's override, when the group has one
        self._group_wd: dict[int, object] = {}
        self._group_clip: dict[int, object] = {}
        self._group_lr: dict[int, float] = {}
        self._group_index: dict[int, int] = {}
        entries = []
        if items and isinstance(items[0], dict):
            seen = set()
            for gi, group in enumerate(items):
                if not isinstance(group, dict) or "params" not in group:
                    raise ValueError(
                        "each parameter group must be a dict with a 'params' "
                        f"key, got {group!r}")
                unknown = set(group) - self._group_keys
                if unknown:
                    raise ValueError(
                        f"unsupported parameter-group keys {sorted(unknown)}; "
                        f"supported: {sorted(self._group_keys)}")
                ps = group["params"]
                one = isinstance(ps, torch.Tensor) or (
                    isinstance(ps, tuple) and len(ps) == 2
                    and isinstance(ps[0], str))
                for it in [ps] if one else list(ps):
                    p = it[1] if isinstance(it, tuple) else it
                    if id(p) in seen:
                        raise ValueError("some parameters appear in more "
                                         "than one parameter group")
                    seen.add(id(p))
                    i = len(entries)
                    if "learning_rate" in group:
                        self._group_lr[i] = float(group["learning_rate"])
                    if "weight_decay" in group:
                        self._group_wd[i] = group["weight_decay"]
                    if "grad_clip" in group:
                        self._group_clip[i] = group["grad_clip"]
                    self._group_index[i] = gi
                    entries.append(it)
        else:
            for it in items:
                if isinstance(it, dict):
                    raise ValueError(
                        "parameters mixes plain tensors and dict groups; "
                        "pass either a flat list or a list of group dicts")
            entries = items
        named = [it if isinstance(it, tuple) else (str(i), it)
                 for i, it in enumerate(entries)]
        self._parameter_list = [p for _, p in named]
        self._names = [n for n, _ in named]
        self._param_index = {id(p): i
                             for i, p in enumerate(self._parameter_list)}
        self._learning_rate = learning_rate
        self._weight_decay = weight_decay
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self._acc_dtype = None
        self._accumulators: dict[str, torch.Tensor] = {}  # "slot@index"
        self._master_weights: dict[int, torch.Tensor] = {}  # index -> f32
        self._step_count = 0
        self._state_version = 0  # bumped when a state tensor is replaced
        self._groups = {}  # launch groups, per parameter set and state
        self._state_bufs = {}  # device -> [lr, t, clip scales...] f32

    # ------------------------------------------------ lr

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return float(self._learning_rate())
        return float(self._learning_rate)

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("optimizer's learning rate is a scheduler; "
                               "use scheduler.step()")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler):
        self._learning_rate = scheduler

    # ------------------------------------------------ per-parameter facts

    @staticmethod
    def _wd_to_coeff(wd):
        """A weight_decay (float, an object with ``.coeff``, None or a
        string) as a float."""
        if wd is None or isinstance(wd, str):
            return 0.0
        return float(wd.coeff) if hasattr(wd, "coeff") else float(wd)

    def _lr_scale(self, i) -> float:
        """Parameter ``i``'s learning-rate multiplier: its group's
        ``learning_rate``, else 1."""
        return self._group_lr.get(i, 1.0)

    def _effective_clip(self, i):
        """Parameter ``i``'s clip: its group's, else the optimizer's."""
        return self._group_clip.get(i, self._grad_clip)

    def _group_of(self, i) -> int:
        return self._group_index.get(i, 0)

    def _decay_coeff(self, i) -> float:
        """Parameter ``i``'s decay coefficient in the update (0: none)."""
        wd = self._group_wd.get(i)
        return self._wd_to_coeff(self._weight_decay if wd is None else wd)

    @staticmethod
    def _partition_by_clip(items, clip_of, group_of):
        """[(clip, [item, ...])] by (parameter group, clip object); items
        whose clip is None are dropped. Each group clips apart, even where
        groups share one clip object (JAX :349)."""
        parts: dict[tuple, tuple] = {}
        for it in items:
            c = clip_of(it)
            if c is not None:
                parts.setdefault((group_of(it), id(c)), (c, []))[1].append(it)
        return list(parts.values())

    # ------------------------------------------------ state

    def _slot_dtype(self, slot, p):
        return torch.float32 if self._multi_precision else p.dtype

    def _ensure_state(self, indices):
        for i in indices:
            p = self._parameter_list[i]
            for slot in self._accumulator_names:
                key = f"{slot}@{i}"
                if key not in self._accumulators:
                    self._accumulators[key] = torch.zeros_like(
                        p, dtype=self._slot_dtype(slot, p),
                        memory_format=torch.contiguous_format)
                    self._state_version += 1
            if (self._multi_precision and i not in self._master_weights
                    and p.dtype in (torch.bfloat16, torch.float16)):
                self._master_weights[i] = p.detach().float()
                self._state_version += 1

    def state_dict(self):
        """JAX's keys: ``slot@index``, ``master@index``, ``@step_count``
        and, with a scheduler, ``LR_Scheduler``. The tensors are copies,
        as JAX's arrays are values: later steps, which update the state
        in place, do not change them."""
        out = {k: v.clone() for k, v in self._accumulators.items()}
        for i, v in self._master_weights.items():
            out[f"master@{i}"] = v.clone()
        out["@step_count"] = self._step_count
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        return out

    def set_state_dict(self, state):
        """Load a state dict of :meth:`state_dict`'s keys (JAX's): tensors
        or numpy arrays, each cast to the dtype this optimizer keeps that
        slot in (a JAX ``acc_dtype`` moment2 widens to the work dtype) on
        its parameter's device."""
        for key, v in state.items():
            if key == "@step_count":
                self._step_count = int(v)
            elif key == "LR_Scheduler":
                if isinstance(self._learning_rate, LRScheduler):
                    self._learning_rate.set_state_dict(dict(v))
            elif key.startswith("master@"):
                i = int(key[len("master@"):])
                self._master_weights[i] = _as_tensor(
                    v, torch.empty(0, device=self._parameter_list[i].device))
            else:
                slot, i = key.rsplit("@", 1)
                p = self._parameter_list[int(i)]
                self._accumulators[key] = _as_tensor(
                    v, torch.empty(0, dtype=self._slot_dtype(slot, p),
                                   device=p.device))
        self._state_version += 1

    # ------------------------------------------------ step

    def _clip(self, indices, grads):
        """Apply each (group, clip)'s clip to ``grads`` (index -> grad).
        A norm clip gives scales, which the update applies: returns
        ``(slot_of, pieces)``, the index of each clipped parameter's scale
        and the f32 scale vectors in slot order. A clip that is no scale
        (``ClipGradByValue``) replaces the gradients here."""
        slot_of, pieces, n = {}, [], 0
        for clip, members in self._partition_by_clip(
                indices, self._effective_clip, self._group_of):
            ps = [self._parameter_list[i] for i in members]
            gs = [grads[i] for i in members]
            scales = clip._scales(gs, ps)
            if scales is None:
                grads.update(zip(members, clip._clip_arrays(gs, ps)))
                continue
            vec, owner = scales
            for i, o in zip(members, owner):
                if o is not None:
                    slot_of[i] = n + o
            pieces.append(vec.float().reshape(-1))
            n += vec.numel()
        return slot_of, pieces

    def _device_state(self, device, pieces):
        """The update's f32 buffer on ``device``: ``[lr, t, scales...]``.
        lr and t go over in one copy from pinned memory, the scales by one
        concatenation on the card: nothing waits for the card."""
        n = 2 + sum(v.numel() for v in pieces)
        buf = self._state_bufs.get(device)
        if buf is None or buf.numel() < n:
            buf = self._state_bufs[device] = torch.empty(
                max(n, 64), dtype=torch.float32, device=device)
        head = torch.tensor([self.get_lr(), float(self._step_count)],
                            dtype=torch.float32)
        if device.type == "cuda":
            buf[:2].copy_(head.pin_memory(), non_blocking=True)
        else:
            buf[:2].copy_(head)
        if pieces:
            torch.cat(pieces, out=buf[2:n])
        return buf[:n]

    @torch.no_grad()
    def step(self):
        """One update of every trainable parameter that has a gradient:
        clip, then the update, as JAX's eager ``step`` :365."""
        indices = [i for i, p in enumerate(self._parameter_list)
                   if p.requires_grad and p.grad is not None]
        if not indices:
            self._step_count += 1
            return
        grads = {i: self._parameter_list[i].grad for i in indices}
        slot_of, pieces = self._clip(indices, grads)
        self._ensure_state(indices)
        self._step_count += 1
        by_device = {}
        for i in indices:
            by_device.setdefault(self._parameter_list[i].device, []).append(i)
        for device, idx in by_device.items():
            dev_pieces = [v.to(device) for v in pieces]
            self._update(idx, [grads[i] for i in idx],
                         [slot_of.get(i, -1) for i in idx],
                         self._device_state(device, dev_pieces))

    def _update(self, indices, grads, slots, state):
        """Update parameters ``indices`` with ``grads`` in place; ``slots``
        index each one's clip scale in ``state`` past ``[lr, t]``."""
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        """Drop every gradient. As in JAX (which keeps reference Paddle's
        signature), ``set_to_zero`` is accepted and not read."""
        for p in self._parameter_list:
            p.grad = None

    clear_gradients = clear_grad


class Adam(Optimizer):
    """Adam (JAX ``Adam`` :663). ``weight_decay`` is coupled L2 folded into
    the gradient. ``acc_dtype`` narrows the storage of **moment1 only**
    (optax's ``mu_dtype``): moment2 stays in the work dtype, where JAX
    narrows it too (a defect of the reference: a bf16 moment2 puts ~0.4%
    error into sqrt(v) each step). Every update computes in f32; bf16
    parameters without ``multi_precision`` store themselves and both
    moments in bf16 (JAX computes that case in bf16, where beta2 = 0.999
    rounds to 1 and the first step gives NaN). ``lazy_mode=True`` (sparse
    gradients) is not ported and raises."""

    _accumulator_names = ("moment1", "moment2")
    _coupled = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 acc_dtype=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision, name)
        if lazy_mode:
            raise NotImplementedError(
                "lazy_mode=True updates the rows of sparse gradients, which "
                "the port does not have")
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._acc_dtype = _as_dtype(acc_dtype)

    def _slot_dtype(self, slot, p):
        if slot == "moment1" and self._acc_dtype is not None:
            return self._acc_dtype
        return super()._slot_dtype(slot, p)

    def _launch_groups(self, indices, slots):
        """The update's launch groups for these parameters and clip slots,
        built once per parameter list and state (JAX caches one program
        per parameter list, ``_step_group`` :452)."""
        key = (tuple(indices), tuple(slots), self._state_version,
               tuple(self._parameter_list[i].data_ptr() for i in indices))
        groups = self._groups.get(key)
        if groups is None:
            # drop the groups of replaced state (they hold its tensors)
            self._groups = {k: v for k, v in self._groups.items()
                            if k[2] == self._state_version}
            if len(self._groups) > 64:
                self._groups.clear()
            by_kind = {}
            for pos, i in enumerate(indices):
                p = self._parameter_list[i]
                kind = (p.dtype, i in self._master_weights,
                        self._accumulators[f"moment1@{i}"].dtype)
                by_kind.setdefault(kind, []).append(pos)
            groups = self._groups[key] = []
            for members in by_kind.values():
                idx = [indices[k] for k in members]
                groups.append((members, AdamTensors(
                    [self._parameter_list[i].detach() for i in idx],
                    [self._master_weights.get(i) for i in idx],
                    [self._accumulators[f"moment1@{i}"] for i in idx],
                    [self._accumulators[f"moment2@{i}"] for i in idx],
                    [self._lr_scale(i) for i in idx],
                    [self._decay_coeff(i) for i in idx],
                    [slots[k] for k in members])))
        return groups

    def _update(self, indices, grads, slots, state):
        for members, group in self._launch_groups(indices, slots):
            multi_tensor_adam(group, [grads[k] for k in members], state,
                              beta1=self._beta1, beta2=self._beta2,
                              epsilon=self._epsilon, coupled=self._coupled)


class AdamW(Adam):
    """Adam with decoupled weight decay (default coefficient 0.01; a group's
    ``weight_decay`` overrides it); ``apply_decay_param_fun(name) -> bool``
    exempts parameters by name. JAX accepts ``lr_ratio`` and reads it
    nowhere (``optimizer.py:728-733``); the port raises on a value other
    than None rather than ignore it."""

    _coupled = False

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, acc_dtype=None,
                 name=None):
        if lr_ratio is not None:
            raise NotImplementedError(
                "lr_ratio is not ported: the JAX package accepts it and "
                "reads it nowhere")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         None, grad_clip, lazy_mode, multi_precision,
                         acc_dtype, name)
        self._coeff = self._wd_to_coeff(weight_decay)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _decay_flag(self, name) -> bool:
        """Whether decoupled decay applies to the parameter of this name."""
        if self._apply_decay_param_fun is not None:
            return bool(self._apply_decay_param_fun(name))
        return True

    def _decay_coeff(self, i):
        if not self._decay_flag(self._names[i]):
            return 0.0
        wd = self._group_wd.get(i)
        return self._coeff if wd is None else self._wd_to_coeff(wd)
