"""Neox rotary embedding of q and k and its adjoint: the hand-written
kernel (``csrc/rope.cu``), its plain PyTorch version, the wrapper that
picks between them by device, and the ``torch.autograd.Function`` that
joins the two directions.

Counterpart of ``_rope_kernel`` in ``paddle_tpu/ops/pallas/fused_ops.py``
(``inverse=False`` forward, ``inverse=True`` in ``_rope_one_bwd``) and of
the position-id gather in ``paddle_tpu/ops/nn_kernels.py``
``rotary_position_embedding``: both are the same function of a (B, S)
position tensor.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_rope", "fused_rope_plain", "RopeFunction"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _rope_one(x, c, s, inverse):
    half = x.shape[-1] // 2
    xf = _build.upcast(x)
    x1, x2 = xf[..., :half], xf[..., half:]
    # adjoint rotation [x2, -x1]; neox rotate-half [-x2, x1]
    rot = torch.cat([x2, -x1] if inverse else [-x2, x1], dim=-1)
    return (xf * c + rot * s).to(x.dtype)


def fused_rope_plain(q, k, cos, sin, positions, inverse=False):
    """q (B, S, H, D), k (B, S, KVH, D); cos/sin (P, D) f32 tables;
    positions (B, S) int. Rows are gathered at the positions, clamped into
    the table as a jnp gather clamps them. ``inverse`` rotates the other
    way: the adjoint, which takes (dq, dk) to the inputs' gradients."""
    pos = positions.long().clamp(0, cos.shape[0] - 1)
    c = _build.upcast(cos)[pos][:, :, None, :]
    s = _build.upcast(sin)[pos][:, :, None, :]
    return _rope_one(q, c, s, inverse), _rope_one(k, c, s, inverse)


def fused_rope(q, k, cos, sin, positions, inverse=False):
    """Rotate q and k at ``positions`` (see :func:`fused_rope_plain`). A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 q/k, f32 tables, int32 positions, all contiguous) or raises.
    The two directions count as ``fused_rope`` and ``fused_rope_bwd``."""
    if q.device.type == "cpu":
        return fused_rope_plain(q, k, cos, sin, positions, inverse)
    name = "fused_rope_bwd" if inverse else "fused_rope"
    _build.expect(name, "q", q, torch.bfloat16, 4)
    _build.expect(name, "k", k, torch.bfloat16, 4)
    _build.expect(name, "cos", cos, torch.float32, 2)
    _build.expect(name, "sin", sin, torch.float32, 2)
    _build.expect(name, "positions", positions, torch.int32, 2)
    b, s, h, d = q.shape
    if (k.shape[:2] != (b, s) or k.shape[3] != d or d % 2
            or tuple(positions.shape) != (b, s)
            or cos.shape != sin.shape or cos.shape[1] != d):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"positions {tuple(positions.shape)}, tables "
                         f"{tuple(cos.shape)}")
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    fn = _build.function("ptt_rope_bwd" if inverse else "ptt_rope_fwd",
                         [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), q_out.data_ptr(),
                    k_out.data_ptr(), positions.data_ptr(), cos.data_ptr(),
                    sin.data_ptr(), b * s, h, k.shape[2], d, cos.shape[0],
                    _build.stream_of(q)), name)
    _build.launch_counts[name] += 1
    return q_out, k_out


class RopeFunction(torch.autograd.Function):
    """``(q, k) -> fused_rope(q, k, ...)``; its backward rotates (dq, dk)
    back in one launch of the adjoint. The tables and positions take no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, positions):
        ctx.save_for_backward(cos, sin, positions)
        return fused_rope(q, k, cos, sin, positions)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin, positions = ctx.saved_tensors
        dq, dk = fused_rope(dq.contiguous(), dk.contiguous(), cos, sin,
                            positions, inverse=True)
        return dq, dk, None, None, None
