"""RMSNorm forward and backward: the hand-written kernels
(``csrc/rms_norm.cu``), their plain PyTorch versions, the wrappers that
pick between them by device, and the ``torch.autograd.Function`` that
joins them.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``: ``_fwd_kernel`` and
``_bwd_kernel`` behind the ``rms_norm`` custom_vjp.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "RMSNormFunction"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
STRIP_ROWS = 16  # rows per block of the backward; each writes f32 partials
MAX_D = 16384  # the backward keeps a strip's 2 * D column sums in smem


def rms_norm_plain(x, weight=None, bias=None, epsilon=1e-6):
    """(N, D) x -> (y, r): ``y = x * r * w + b`` in f32, cast to x's dtype,
    with ``r = rsqrt(mean(x^2) + eps)`` per row as (N, 1) f32. A weight of
    None scales by 1; a bias of None adds nothing."""
    xf = _build.upcast(x)
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + epsilon)
    y = xf * r
    if weight is not None:
        y = y * _build.upcast(weight)
    if bias is not None:
        y = y + _build.upcast(bias)
    return y.to(x.dtype), r


def _ptr(t):
    return None if t is None else t.data_ptr()


def rms_norm(x, weight=None, bias=None, epsilon=1e-6):
    """RMSNorm over the rows of a 2-D ``x``; returns ``(y, r)`` as
    :func:`rms_norm_plain`. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (bf16, contiguous; weight and bias bf16 (D,)
    or None; any D and alignment) or raises."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, bias, epsilon)
    _build.expect("rms_norm", "x", x, torch.bfloat16, 2)
    n, d = x.shape
    for arg, t in (("weight", weight), ("bias", bias)):
        if t is not None:
            _build.expect("rms_norm", arg, t, torch.bfloat16, 1)
            if t.shape[0] != d:
                raise ValueError(f"rms_norm: x {tuple(x.shape)} with {arg} "
                                 f"{tuple(t.shape)}")
    if n == 0:
        raise ValueError("rms_norm: x has no rows")
    y = torch.empty_like(x)
    r = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    fn = _build.function("ptt_rms_norm_fwd",
                         [_P, _P, _P, _P, _P, _I, _I, _F, _P])
    _build.check(fn(x.data_ptr(), _ptr(weight), _ptr(bias), y.data_ptr(),
                    r.data_ptr(), n, d, float(epsilon), _build.stream_of(x)),
                 "rms_norm")
    _build.launch_counts["rms_norm"] += 1
    return y, r


def rms_norm_bwd_plain(x, weight, r, g):
    """Gradients of ``y = x * r * w`` at (N, D) ``x``, given the forward's
    (N, 1) ``r`` and the output gradient ``g``, with the math in f32:
    ``dx = r * (g*w - x * r^2 * mean(g*w*x))`` in x's dtype, and
    ``dw = sum_rows g*x*r``, ``db = sum_rows g`` cast to w's dtype."""
    xf, gf = _build.upcast(x), _build.upcast(g)
    rf = _build.upcast(r)
    gw = gf * _build.upcast(weight)
    inner = (gw * xf).mean(-1, keepdim=True)
    dx = rf * (gw - xf * (rf * rf) * inner)
    dw = (gf * xf * rf).sum(0)
    db = gf.sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype), db.to(weight.dtype)


def rms_norm_bwd(x, weight, r, g):
    """``(dx, dw, db)`` as :func:`rms_norm_bwd_plain`. A CPU tensor takes
    the plain version; a CUDA tensor launches the backward kernel (bf16
    x/w/g, f32 r, all contiguous, D <= 16384) or raises."""
    if x.device.type == "cpu":
        return rms_norm_bwd_plain(x, weight, r, g)
    name = "rms_norm_bwd"
    _build.expect(name, "x", x, torch.bfloat16, 2)
    _build.expect(name, "weight", weight, torch.bfloat16, 1)
    _build.expect(name, "r", r, torch.float32, 2)
    _build.expect(name, "g", g, torch.bfloat16, 2)
    n, d = x.shape
    if (weight.shape[0] != d or tuple(r.shape) != (n, 1) or g.shape != x.shape
            or n == 0 or d > MAX_D):
        raise ValueError(f"{name}: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, r {tuple(r.shape)}, g "
                         f"{tuple(g.shape)}; D at most {MAX_D}")
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(weight), torch.empty_like(weight)
    strips = -(-n // STRIP_ROWS)
    partial = torch.empty((strips, 2, d), dtype=torch.float32,
                          device=x.device)
    fn = _build.function("ptt_rms_norm_bwd",
                         [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    _build.check(fn(x.data_ptr(), weight.data_ptr(), r.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), dw.data_ptr(), db.data_ptr(),
                    partial.data_ptr(), n, d, STRIP_ROWS,
                    _build.stream_of(x)), name)
    _build.launch_counts[name] += 1
    return dx, dw, db


class RMSNormFunction(torch.autograd.Function):
    """``y = rms_norm(x, weight, bias, epsilon)[0]`` with
    :func:`rms_norm_bwd` as its gradient: dx, and dw and db for the weight
    and bias that were given (a weight of None takes the backward kernel
    with a scale of ones)."""

    @staticmethod
    def forward(ctx, x, weight, bias, epsilon):
        y, r = rms_norm(x, weight, bias, epsilon)
        ctx.has = (weight is not None, bias is not None)
        ctx.save_for_backward(x, weight, r)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, r = ctx.saved_tensors
        has_w, has_b = ctx.has
        w = weight if has_w else torch.ones(x.shape[1], dtype=x.dtype,
                                            device=x.device)
        dx, dw, db = rms_norm_bwd(x, w, r, g.contiguous())
        return dx, dw if has_w else None, db if has_b else None, None
