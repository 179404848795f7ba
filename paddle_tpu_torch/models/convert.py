"""Carry a JAX model's weights into the port's model.

The port keeps the JAX package's parameter names and its ``(in, out)``
Linear layout, so loading is a copy by name: the parameter dict of
``paddle_tpu``'s ``Layer.raw_state()`` (``nn/layer_base.py`` :357), with
each array turned into numpy by the caller, goes straight in.

The optimizer's state follows the same way: a JAX ``TrainStep``'s
``state_dict()`` (``moment1@name``, ``moment2@name``, ``master@name``,
``@step_count``) or an optimizer's (``slot@index``, ``master@index``,
``@step_count``, ``LR_Scheduler``), its arrays as numpy arrays, loads
into the port's ``TrainStep.set_state_dict`` or
``Optimizer.set_state_dict`` as it is, and the port resumes JAX's
trajectory from there.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_paddle_tpu"]


def params_from_paddle_tpu(np_params: dict, model: torch.nn.Module):
    """Copy ``np_params`` (name -> numpy array) into ``model``'s
    parameters, cast to each parameter's dtype and device. Raises on a
    missing or unexpected name or a shape mismatch. Returns ``model``."""
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(np_params))
    unexpected = sorted(set(np_params) - set(own))
    if missing or unexpected:
        raise KeyError(f"parameter names differ: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(np_params[name], dtype=np.float32)
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} does not match "
                                 f"the parameter's {tuple(p.shape)}")
            p.copy_(torch.tensor(arr))
    return model
