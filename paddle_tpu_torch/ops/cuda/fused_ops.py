"""The two fused ops of ``paddle_tpu/ops/pallas/fused_ops.py``, each a
hand-written kernel beside its plain PyTorch version, a wrapper that picks
between them by device, and a ``torch.autograd.Function``:

- Neox rotary embedding of q and k and its adjoint (``csrc/rope.cu``):
  counterpart of ``_rope_kernel`` (``inverse=False`` forward,
  ``inverse=True`` in ``_rope_one_bwd``) and of the position-id gather in
  ``paddle_tpu/ops/nn_kernels.py`` ``rotary_position_embedding``: both are
  the same function of a (B, S) position tensor.
- Bias + dropout + residual + LayerNorm (``csrc/bias_dropout_residual_ln.cu``):
  counterpart of ``_bdrln_kernel`` :112 and the ``_bdrln`` custom_vjp
  :169-198 behind ``bias_dropout_residual_ln`` :203. The backward is plain
  PyTorch, as the JAX package's is XLA.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["fused_rope", "fused_rope_plain", "RopeFunction",
           "bias_dropout_residual_ln", "bias_dropout_residual_ln_fwd",
           "bias_dropout_residual_ln_plain", "BiasDropoutResidualLNFunction"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _rope_one(x, c, s, inverse):
    half = x.shape[-1] // 2
    xf = _build.upcast(x)
    x1, x2 = xf[..., :half], xf[..., half:]
    # adjoint rotation [x2, -x1]; neox rotate-half [-x2, x1]
    rot = torch.cat([x2, -x1] if inverse else [-x2, x1], dim=-1)
    return (xf * c + rot * s).to(x.dtype)


def fused_rope_plain(q, k, cos, sin, positions, inverse=False):
    """q (B, S, H, D), k (B, S, KVH, D) or None; cos/sin (P, D) f32 tables;
    positions (B, S) int. Rows are gathered at the positions, clamped into
    the table as a jnp gather clamps them. ``inverse`` rotates the other
    way: the adjoint, which takes (dq, dk) to the inputs' gradients. A k
    of None gives ``(rotated q, None)``, as JAX's ``fused_rope``."""
    pos = positions.long().clamp(0, cos.shape[0] - 1)
    c = _build.upcast(cos)[pos][:, :, None, :]
    s = _build.upcast(sin)[pos][:, :, None, :]
    return (_rope_one(q, c, s, inverse),
            None if k is None else _rope_one(k, c, s, inverse))


def fused_rope(q, k, cos, sin, positions, inverse=False):
    """Rotate q and k at ``positions`` (see :func:`fused_rope_plain`). A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 q/k, f32 tables, int32 positions, all contiguous) or raises.
    With k None the kernel rotates q alone (a null k and 0 kv heads) and
    the call returns ``(q_out, None)``. The two directions count as
    ``fused_rope`` and ``fused_rope_bwd``."""
    if q.device.type == "cpu":
        return fused_rope_plain(q, k, cos, sin, positions, inverse)
    name = "fused_rope_bwd" if inverse else "fused_rope"
    _build.expect(name, "q", q, torch.bfloat16, 4)
    if k is not None:
        _build.expect(name, "k", k, torch.bfloat16, 4)
    _build.expect(name, "cos", cos, torch.float32, 2)
    _build.expect(name, "sin", sin, torch.float32, 2)
    _build.expect(name, "positions", positions, torch.int32, 2)
    b, s, h, d = q.shape
    if ((k is not None and (k.shape[:2] != (b, s) or k.shape[3] != d))
            or d % 2 or tuple(positions.shape) != (b, s)
            or cos.shape != sin.shape or cos.shape[1] != d):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{None if k is None else tuple(k.shape)}, "
                         f"positions {tuple(positions.shape)}, tables "
                         f"{tuple(cos.shape)}")
    q_out = torch.empty_like(q)
    k_out = None if k is None else torch.empty_like(k)
    fn = _build.function("ptt_rope_bwd" if inverse else "ptt_rope_fwd",
                         [_P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P])
    _build.check(fn(q.data_ptr(), None if k is None else k.data_ptr(),
                    q_out.data_ptr(),
                    None if k_out is None else k_out.data_ptr(),
                    positions.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                    b * s, h, 0 if k is None else k.shape[2], d,
                    cos.shape[0], _build.stream_of(q)), name)
    _build.launch_counts[name] += 1
    return q_out, k_out


class RopeFunction(torch.autograd.Function):
    """``(q, k) -> fused_rope(q, k, ...)``; its backward rotates (dq, dk)
    back in one launch of the adjoint. The tables and positions take no
    gradient; a k of None stays None, and so does its gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, positions):
        ctx.save_for_backward(cos, sin, positions)
        return fused_rope(q, k, cos, sin, positions)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin, positions = ctx.saved_tensors
        dq, dk = fused_rope(dq.contiguous(),
                            None if dk is None else dk.contiguous(), cos,
                            sin, positions, inverse=True)
        return dq, dk, None, None, None


# ------------------------------------------- bias + dropout + residual + LN

_FLOATS = (torch.bfloat16, torch.float32)


def _keep(rate, training):
    """The dropout scale 1/(1-rate), or None when no mask applies."""
    return 1.0 / (1.0 - rate) if training and rate > 0.0 else None


def bias_dropout_residual_ln_plain(x2, res2, bias, scale, lnb, mask, rate,
                                   eps, training):
    """(rows, H) x2 and res2; (H,) or (1, H) bias, scale, lnb; (rows, H)
    bool or 0/1 uint8 mask, read only when training with rate > 0. In f32
    (f64 for f64 inputs): ``z = (x2 + bias) * mask * keep + res2`` with
    keep = 1/(1-rate), then LayerNorm with the two-pass variance. Returns
    ``(y in x2's dtype, mean (rows,), rstd (rows,))``."""
    z = _build.upcast(x2) + _build.upcast(bias).reshape(-1)
    keep = _keep(rate, training)
    if keep is not None:
        z = z * mask.to(z.dtype) * keep
    z = z + _build.upcast(res2)
    mean = z.mean(-1, keepdim=True)
    rstd = torch.rsqrt((z - mean).square().mean(-1, keepdim=True) + eps)
    y = ((z - mean) * rstd * _build.upcast(scale).reshape(-1)
         + _build.upcast(lnb).reshape(-1))
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def _aligned(t, nbytes):
    return t.data_ptr() % nbytes == 0


def bias_dropout_residual_ln_fwd(x2, res2, bias, scale, lnb, mask, rate, eps,
                                 training):
    """``(y, mean, rstd)`` as :func:`bias_dropout_residual_ln_plain`. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel or
    raises. The kernel takes x2 and res2 both bf16 or both f32 (rows, H);
    bias, scale and lnb bf16 or f32 with H elements; a bool or uint8
    (rows, H) mask when training with rate > 0; all contiguous. It holds
    a row in registers when H % 8 == 0, H <= 4096 and every pointer is
    16-byte aligned (the mask 8-byte), and strides it otherwise."""
    if x2.device.type == "cpu":
        return bias_dropout_residual_ln_plain(x2, res2, bias, scale, lnb,
                                              mask, rate, eps, training)
    name = "bias_dropout_residual_ln"
    if x2.dtype not in _FLOATS:
        raise TypeError(f"{name}: x must be bfloat16 or float32, got "
                        f"{x2.dtype}")
    _build.expect(name, "x", x2, x2.dtype, 2)
    _build.expect(name, "residual", res2, x2.dtype, 2)
    rows, h = x2.shape
    if res2.shape != x2.shape or rows == 0 or h == 0:
        raise ValueError(f"{name}: x {tuple(x2.shape)}, residual "
                         f"{tuple(res2.shape)}")
    params = {"bias": bias, "scale": scale, "lnb": lnb}
    flags = 0
    for bit, (arg, p) in enumerate(params.items()):
        if p.dtype not in _FLOATS:
            raise TypeError(f"{name}: {arg} must be bfloat16 or float32, "
                            f"got {p.dtype}")
        _build.expect(name, arg, p, p.dtype, p.dim())
        if p.numel() != h:
            raise ValueError(f"{name}: {arg} has {p.numel()} elements, "
                             f"want {h}")
        flags |= (p.dtype == torch.bfloat16) << bit
    keep = _keep(rate, training)
    vec = h % 8 == 0 and all(_aligned(t, 16)
                             for t in (x2, res2, *params.values()))
    if keep is not None:
        if mask is None or mask.dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"{name}: training with rate {rate} needs a bool "
                            f"or uint8 mask, got "
                            f"{None if mask is None else mask.dtype}")
        _build.expect(name, "mask", mask, mask.dtype, 2)
        if mask.shape != x2.shape:
            raise ValueError(f"{name}: mask {tuple(mask.shape)}, x "
                             f"{tuple(x2.shape)}")
        vec = vec and _aligned(mask, 8)
    y = torch.empty_like(x2)
    mean = torch.empty(rows, dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mean)
    fn = _build.function("ptt_bdrln_fwd",
                         [_P] * 9 + [_I] * 5 + [_F, _F, _I, _P])
    _build.check(fn(x2.data_ptr(), res2.data_ptr(), bias.data_ptr(),
                    scale.data_ptr(), lnb.data_ptr(),
                    mask.data_ptr() if keep is not None else None,
                    y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), rows, h,
                    int(x2.dtype == torch.bfloat16), flags,
                    int(keep is not None), keep or 1.0, float(eps), int(vec),
                    _build.stream_of(x2)), name)
    _build.launch_counts[name] += 1
    return y, mean, rstd


class BiasDropoutResidualLNFunction(torch.autograd.Function):
    """``y = bias_dropout_residual_ln_fwd(...)[0]``; saves the inputs,
    mean and rstd (the mask only when it applies). Its backward is plain PyTorch, the
    counterpart of ``_bdrln_bwd`` :181-198: with ``xhat = (z - mean) *
    rstd`` and ``dyw = dy * scale``, ``dz = rstd * (dyw - mean(dyw) - xhat
    * mean(dyw * xhat))``; ``dx = dz * mask * keep``, ``dres = dz``,
    ``dbias = sum_rows dx``, ``dscale = sum_rows dy * xhat``, ``dlnb =
    sum_rows dy``, each in its input's dtype and shape."""

    @staticmethod
    def forward(ctx, x2, res2, bias, scale, lnb, mask, rate, eps, training):
        y, mean, rstd = bias_dropout_residual_ln_fwd(
            x2, res2, bias, scale, lnb, mask, rate, eps, training)
        ctx.keep = _keep(rate, training)
        ctx.save_for_backward(x2, res2, bias, scale, lnb, mean, rstd,
                              mask if ctx.keep is not None else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, res2, bias, scale, lnb, mean, rstd, mask = ctx.saved_tensors
        up = _build.upcast
        z = up(x2) + up(bias).reshape(-1)
        if ctx.keep is not None:
            m = mask.to(z.dtype) * ctx.keep
            z = z * m
        z = z + up(res2)
        xhat = (z - mean[:, None]) * rstd[:, None]
        dyf = up(dy)
        dyw = dyf * up(scale).reshape(-1)
        dz = rstd[:, None] * (dyw - dyw.mean(-1, keepdim=True)
                              - xhat * (dyw * xhat).mean(-1, keepdim=True))
        dx = dz * m if ctx.keep is not None else dz
        return (dx.to(x2.dtype), dz.to(res2.dtype),
                dx.sum(0).reshape(bias.shape).to(bias.dtype),
                (dyf * xhat).sum(0).reshape(scale.shape).to(scale.dtype),
                dyf.sum(0).reshape(lnb.shape).to(lnb.dtype),
                None, None, None, None)


def bias_dropout_residual_ln(x, residual, bias=None, ln_scale=None,
                             ln_bias=None, dropout_rate=0.5, ln_epsilon=1e-5,
                             training=True, generator=None):
    """``layer_norm(residual + dropout(x + bias))`` over the last axis of
    x and residual (any leading shape), upscale_in_train dropout, in one
    kernel launch on the card. The mask is drawn here, outside the kernel,
    as in JAX: keep where ``torch.rand(..., generator=generator) < 1 -
    dropout_rate`` (``generator`` None draws from torch's default
    generator of x's device). A missing bias is zeros in x's dtype, a
    missing scale ones and a missing ln_bias zeros in f32, as in JAX."""
    h = x.shape[-1]
    x2 = x.reshape(-1, h).contiguous()
    res2 = residual.reshape(-1, h).contiguous()
    if bias is None:
        bias = torch.zeros(h, dtype=x.dtype, device=x.device)
    if ln_scale is None:
        ln_scale = torch.ones(h, dtype=torch.float32, device=x.device)
    if ln_bias is None:
        ln_bias = torch.zeros(h, dtype=torch.float32, device=x.device)
    mask = None
    if _keep(dropout_rate, training) is not None:
        mask = torch.rand(x2.shape, generator=generator,
                          device=x.device) < 1.0 - dropout_rate
    args = (x2, res2, bias, ln_scale, ln_bias, mask, float(dropout_rate),
            float(ln_epsilon), bool(training))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, residual, bias, ln_scale, ln_bias)):
        y = BiasDropoutResidualLNFunction.apply(*args)
    else:
        y = bias_dropout_residual_ln_fwd(*args)[0]
    return y.reshape(x.shape)
