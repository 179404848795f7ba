"""Gradient clipping strategies.

Counterpart of ``paddle_tpu/nn/clip.py`` :19-120: ``ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm`` and ``clip_grad_norm_``, with
the ``need_clip`` exemption (``_need_clip_mask`` :19: a parameter whose
``need_clip`` attribute is False keeps its gradient). JAX computes the
clips in ``jnp``, so the port's are plain torch: every norm is a device
reduction and nothing waits for the card. A clipped gradient keeps its
dtype and JAX's rounding: ``(g.float() * scale).to(g.dtype)``.

Beside JAX's ``_clip_arrays`` each norm clip has ``_scales``: the same
scales as one f32 vector, which the optimizer hands to its update kernel
instead of writing clipped gradients (``optimizer/optimizer.py``).
"""
from __future__ import annotations

import math

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm", "clip_grad_norm_"]


def _need_clip_mask(grads, params):
    """Per-parameter clip exemption: ``need_clip=False`` on a parameter
    keeps its gradient, in every strategy."""
    if params is None:
        return [True] * len(grads)
    return [getattr(p, "need_clip", True) for p in params]


def _norms(grads):
    """(len(grads),) f32 L2 norms, each taken in f32."""
    return torch.stack(torch._foreach_norm(grads, 2.0, dtype=torch.float32))


def _scaled(g, scale):
    return (g.float() * scale).to(g.dtype)


class ClipGradBase:
    def _clip_arrays(self, grads: list, params=None) -> list:
        raise NotImplementedError

    def _scales(self, grads: list, params=None):
        """``(scales, owner)``: an f32 vector of scales on the gradients'
        device and, for each gradient, the index of its scale or None
        (exempt), such that ``_clip_arrays`` gives ``(g.float() *
        scales[owner]).to(g.dtype)``; or None where the clip is not a
        scale."""
        return None

    def __call__(self, params_grads):
        """Paddle's interface: a list of (param, grad) pairs in, the same
        pairs with the gradients clipped out."""
        params = [p for p, _ in params_grads]
        clipped = self._clip_arrays([g for _, g in params_grads], params)
        return list(zip(params, clipped))


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _clip_arrays(self, grads, params=None):
        mask = _need_clip_mask(grads, params)
        return [torch.clamp(g, self.min, self.max) if m else g
                for g, m in zip(grads, mask)]


class ClipGradByNorm(ClipGradBase):
    """Per-tensor L2-norm clip: ``scale = min(clip_norm / max(norm,
    1e-12), 1)``."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _scales(self, grads, params=None):
        mask = _need_clip_mask(grads, params)
        sel = [g for g, m in zip(grads, mask) if m]
        owner, k = [], 0
        for m in mask:
            owner.append(k if m else None)
            k += bool(m)
        if not sel:
            return torch.empty(0, device=grads[0].device), owner
        norms = _norms(sel)
        scales = torch.full_like(norms, self.clip_norm).div_(
            norms.clamp(min=1e-12)).clamp_(max=1.0)
        return scales, owner

    def _clip_arrays(self, grads, params=None):
        if not grads:
            return grads
        scales, owner = self._scales(grads, params)
        return [g if o is None else _scaled(g, scales[o])
                for g, o in zip(grads, owner)]


class ClipGradByGlobalNorm(ClipGradBase):
    """Global L2-norm clip over every gradient that is not exempt:
    ``scale = clip_norm / max(global_norm, clip_norm)``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.auto_skip_clip = auto_skip_clip

    def global_norm(self, grads):
        """sqrt of the sum of every gradient's squares, in f32."""
        if not grads:
            return torch.zeros((), dtype=torch.float32)
        return torch.linalg.vector_norm(_norms(grads))

    def _scales(self, grads, params=None):
        mask = _need_clip_mask(grads, params)
        owner = [0 if m else None for m in mask]
        sel = [g for g, m in zip(grads, mask) if m]
        if not sel:  # a global norm of 0: the scale is 1
            return torch.ones(1, device=grads[0].device), owner
        gnorm = self.global_norm(sel).reshape(1)
        scale = torch.full_like(gnorm, self.clip_norm).div_(
            gnorm.clamp(min=self.clip_norm))
        return scale, owner

    def _clip_arrays(self, grads, params=None):
        if not grads:
            return grads
        scale, owner = self._scales(grads, params)
        return [g if o is None else _scaled(g, scale[0])
                for g, o in zip(grads, owner)]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Clip the live ``.grad`` of ``parameters`` (a tensor or an iterable
    of them) in place by their total ``norm_type`` norm, as torch's
    utility does; returns the total norm (before clipping), or None when
    no parameter has a gradient. As in JAX, ``error_if_nonfinite`` is
    accepted and not read."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return None
    if norm_type == math.inf:
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        total = torch.stack([
            g.float().abs().pow(norm_type).sum() for g in grads]).sum().pow(
                1.0 / norm_type)
    scale = torch.full_like(total, max_norm).div_(
        total.clamp(min=1e-6)).clamp_(max=1.0)
    for g in grads:
        g.copy_(_scaled(g, scale))
    return total
