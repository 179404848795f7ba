"""Where the port runs: the card unless the caller asks for the CPU.

Counterpart of ``paddle_tpu/core/place.py``. The JAX package runs on its
default backend; the port's entry points take an explicit ``device`` and,
when it is None, use the GPU, raising if there is none. They never carry
on quietly on the CPU: the CPU is for tests, which ask for it by name.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "seed", "placed"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA
    device, and raises when there is no GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on the GPU and found none; pass "
                "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def seed(s: int, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``s``: the port's
    counterpart of ``paddle.seed``, passed explicitly instead of set
    globally."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(int(s))
    return g


def placed(device=None, generator=None):
    """``(device, generator)`` of a model's constructor: ``device`` as
    :func:`resolve_device` gives it, and ``generator`` or, when it is
    None, ``seed(0)`` on that device."""
    device = resolve_device(device)
    return device, seed(0, device) if generator is None else generator
