"""Flash attention, forward and backward: the hand-written kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``), their
plain PyTorch versions, the wrappers that pick between them by device,
and the ``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: the public
:func:`flash_attention` (JAX's :431, same signature, returns ``out`` and is
differentiable), :func:`flash_attention_fwd` (JAX's ``_fwd`` :137 over
``_fwd_kernel``: out and lse), and ``_bwd_dkdv_kernel`` and
``_bwd_dq_kernel`` behind its custom_vjp. Layout is the public
(B, S, H, D) of ``scaled_dot_product_attention``; the kernels read it in
place, so no transpose runs around them. Segment-id masking (``seq_lens``,
``segment_ids``) is not ported yet: the public function raises on it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_bwd_dkdv",
           "flash_attention_bwd_dq", "FlashAttentionFunction",
           "refuse_segments"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
NEG_INF = -1e30
HEAD_DIMS = (64, 128)  # the kernels' instantiations


def _causal_keep(sq, sk, device):
    """(Sq, Sk) bool: row r sees keys ``c <= r + (Sk - Sq)``."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(sk - sq)


def flash_attention_fwd_plain(q, k, v, causal=True):
    """q (B, Sq, H, D), k/v (B, Sk, KVH, D) -> (out like q, lse (B, H, Sq)
    f32). Softmax in f32 of ``(q * scale) . k``; causal rows see keys
    ``c <= r + (Sk - Sq)``; query head h reads kv head ``h // (H // KVH)``."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    qf = _build.upcast(q).transpose(1, 2) * (1.0 / math.sqrt(d))
    kf = _build.upcast(k).transpose(1, 2).repeat_interleave(group, dim=1)
    vf = _build.upcast(v).transpose(1, 2).repeat_interleave(group, dim=1)
    s = qf @ kf.transpose(-1, -2)
    if causal:
        s = s.masked_fill(~_causal_keep(sq, sk, q.device), NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.softmax(s, dim=-1) @ vf
    return out.transpose(1, 2).to(q.dtype), lse


def _check(name, q, k, v):
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _build.expect(name, arg, t, torch.bfloat16, 4)
        if t.data_ptr() % 16:  # the kernels copy rows 16 bytes at a time
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    b, sq, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or d not in HEAD_DIMS or h % k.shape[2] or sq == 0):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; head_dim must be one of "
                         f"{HEAD_DIMS} and heads a multiple of kv heads")


def flash_attention_fwd(q, k, v, causal=True):
    """Attention forward with lse (see :func:`flash_attention_fwd_plain`).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16, contiguous, 16-byte aligned, D in {64, 128}, H a multiple of
    KVH) or raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    name = "flash_attention"
    _check(name, q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.function("ptt_flash_attention_fwd",
                         [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                          _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, sq, k.shape[1], h, k.shape[2], d,
                    1.0 / math.sqrt(d), int(bool(causal)),
                    _build.stream_of(q)), name)
    _build.launch_counts[name] += 1
    return out, lse


def refuse_segments(seq_lens, segment_ids):
    """Raise on segment masking, which the kernels do not take yet."""
    if seq_lens is not None or segment_ids is not None:
        raise NotImplementedError(
            "flash attention: seq_lens / segment_ids (segment masking) are "
            "not ported yet (ROADMAP Queue 2a item 1)")


def flash_attention(q, k, v, is_causal=False, seq_lens=None,
                    segment_ids=None):
    """(B, S, H, D) attention, the JAX package's public flash attention:
    returns ``out`` only, non-causal unless ``is_causal``, GQA by index.
    Under autograd it records :class:`FlashAttentionFunction` (the forward
    kernel, then dK/dV and dQ); otherwise :func:`flash_attention_fwd`
    alone. ``seq_lens`` and ``segment_ids`` raise ``NotImplementedError``
    on every device."""
    refuse_segments(seq_lens, segment_ids)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, bool(is_causal))
    return flash_attention_fwd(q, k, v, bool(is_causal))[0]


def _delta(out, do):
    """``rowsum(dO * O)`` as (B, H, Sq) in f32, the layout of lse; formed
    outside the kernels, as the JAX package forms it in XLA."""
    return (_build.upcast(do) * _build.upcast(out)).sum(-1).transpose(
        1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True):
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd_plain` from the
    forward's ``out`` and ``lse`` and the output gradient ``do``, by the FA2
    formulas over the full score matrix, in f32: ``P = exp(S - lse)``,
    ``dV = P^T dO``, ``dS = P * (dO V^T - delta) * scale`` with
    ``delta = rowsum(dO * O)``, ``dQ = dS K``, ``dK = dS^T Q``; a GQA kv
    head's dK and dV sum over its group of query heads."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale = 1.0 / math.sqrt(d)
    qf = _build.upcast(q).transpose(1, 2)
    kf = _build.upcast(k).transpose(1, 2).repeat_interleave(group, dim=1)
    vf = _build.upcast(v).transpose(1, 2).repeat_interleave(group, dim=1)
    dof = _build.upcast(do).transpose(1, 2)
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale
                  - _build.upcast(lse)[..., None])
    if causal:
        p = p.masked_fill(~_causal_keep(sq, sk, q.device), 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - _delta(out, do)[..., None]) * scale
    dq = ds @ kf
    dk = (ds.transpose(-1, -2) @ qf).view(b, kvh, group, sk, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(b, kvh, group, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _bwd_args(name, q, k, v, do, lse, delta):
    _check(name, q, k, v)
    _build.expect(name, "do", do, torch.bfloat16, 4)
    if do.data_ptr() % 16:
        raise ValueError(f"{name}: do must be 16-byte aligned")
    _build.expect(name, "lse", lse, torch.float32, 3)
    _build.expect(name, "delta", delta, torch.float32, 3)
    b, sq, h, d = q.shape
    if do.shape != q.shape or lse.shape != (b, h, sq) or delta.shape != (
            b, h, sq):
        raise ValueError(f"{name}: q {tuple(q.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)}")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _bwd_sizes(q, k, causal):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d, 1.0 / math.sqrt(d),
            int(bool(causal)), _build.stream_of(q))


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=True):
    """Launch the dK/dV kernel (CUDA tensors only): ``(dk, dv)`` like k
    and v, from ``delta = rowsum(dO * O)`` (B, H, Sq) f32."""
    name = "flash_attention_bwd_dkdv"
    ptrs = _bwd_args(name, q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("ptt_" + name, [_P] * 8 + [_I] * 6 + [_F, _I, _P])
    _build.check(fn(*ptrs, dk.data_ptr(), dv.data_ptr(),
                    *_bwd_sizes(q, k, causal)), name)
    _build.launch_counts[name] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True):
    """Launch the dQ kernel (CUDA tensors only): ``dq`` like q."""
    name = "flash_attention_bwd_dq"
    ptrs = _bwd_args(name, q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    fn = _build.function("ptt_" + name, [_P] * 7 + [_I] * 6 + [_F, _I, _P])
    _build.check(fn(*ptrs, dq.data_ptr(), *_bwd_sizes(q, k, causal)), name)
    _build.launch_counts[name] += 1
    return dq


def flash_attention_bwd(q, k, v, out, lse, do, causal=True):
    """``(dq, dk, dv)`` as :func:`flash_attention_bwd_plain`. A CPU tensor
    takes the plain version; a CUDA tensor forms ``delta`` in torch and
    launches the dK/dV kernel and the dQ kernel (what the forward takes,
    plus bf16 ``out``/``do`` like q and f32 ``lse`` (B, H, Sq), all
    contiguous) or raises."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    _build.expect("flash_attention_bwd", "out", out, torch.bfloat16, 4)
    if out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out "
                         f"{tuple(out.shape)}")
    delta = _delta(out, do)
    dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """``out = flash_attention_fwd(q, k, v, causal)[0]``; saves q, k, v,
    out and lse, and its backward is :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_fwd(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None
