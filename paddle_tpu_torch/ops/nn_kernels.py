"""The model-facing ops that the port's kernels serve, and the plain ops
around them, with the JAX package's signatures (``paddle_tpu/ops/
nn_kernels.py`` ``gelu`` :53, ``layer_norm`` :150, ``rms_norm`` :162,
``dropout`` :293, ``fused_bias_dropout_residual_layer_norm`` :316,
``scaled_dot_product_attention`` :732, ``rotary_position_embedding``
:804, ``softmax_with_cross_entropy`` :859). Where JAX draws dropout masks
from a key, the port takes an explicit ``torch.Generator``. Each kernel
op routes through its kernel's wrapper, which launches the kernel on a
CUDA tensor and runs the plain version on a CPU tensor. When autograd
records the call, it goes through the kernel's ``torch.autograd.Function``,
whose backward is the backward kernel (or its plain version on the CPU);
otherwise (under ``torch.no_grad``, as in serving) the forward launches
alone.

The port runs eagerly, so RMSNorm takes its kernel on every call: the
counterpart of the JAX package's eager dispatch, not of its traced
programs (which keep the jnp composition).
"""
from __future__ import annotations

import math

import torch

from .cuda._build import upcast
from .cuda.flash_attention import MAX_HEAD_DIM, build_segments, flash_attention
from .cuda.fused_ops import (
    RopeFunction,
    bias_dropout_residual_ln,
    fused_rope_at,
)
from .cuda.rms_norm import rms_norm as _rms_norm

__all__ = ["gelu", "layer_norm", "rms_norm", "dropout",
           "fused_bias_dropout_residual_layer_norm",
           "scaled_dot_product_attention", "rotary_position_embedding",
           "softmax_with_cross_entropy"]


def _records(*tensors):
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def gelu(x, approximate=False):
    """GELU; exact (erf) unless ``approximate``, as ``jax.nn.gelu``."""
    return torch.nn.functional.gelu(x,
                                    approximate="tanh" if approximate
                                    else "none")


def layer_norm(x, weight=None, bias=None, epsilon=1e-05, begin_norm_axis=-1):
    """LayerNorm over the axes from ``begin_norm_axis`` on: ``(x - mean) *
    rsqrt(var + eps) * weight + bias`` with the biased variance. JAX
    composes it in jnp and XLA fuses it; the port calls
    ``torch.nn.functional.layer_norm``, one launch, which on the card
    computes in f32 for bf16 inputs."""
    axis = begin_norm_axis % x.dim()
    return torch.nn.functional.layer_norm(x, x.shape[axis:], weight, bias,
                                          epsilon)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train", *,
            generator=None):
    """Zero each element with probability ``p``: keep where ``torch.rand(
    mask_shape, generator=generator) < 1 - p``; ``upscale_in_train``
    scales the kept ones by 1/(1-p). ``axis`` draws the mask over those
    axes only and broadcasts it over the rest. The identity when not
    training or when p is 0."""
    if not training or p == 0.0:
        return x
    if axis is None:
        shape = x.shape
    else:
        axes = {a % x.dim() for a in ((axis,) if isinstance(axis, int)
                                      else axis)}
        shape = [n if i in axes else 1 for i, n in enumerate(x.shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", *, generator=None):
    """``layer_norm(residual + dropout(x + bias))`` over the last axis.
    ``upscale_in_train`` runs the fused kernel
    (``ops/cuda/fused_ops.py`` ``bias_dropout_residual_ln``); other modes
    compose dropout and layer_norm, as in JAX."""
    if mode == "upscale_in_train":
        return bias_dropout_residual_ln(
            x, residual, bias, ln_scale, ln_bias, dropout_rate=dropout_rate,
            ln_epsilon=ln_epsilon, training=training, generator=generator)
    h = x + bias if bias is not None else x
    h = dropout(h, p=dropout_rate, training=training, mode=mode,
                generator=generator)
    return layer_norm(h + residual, ln_scale, ln_bias, epsilon=ln_epsilon)


def rms_norm(x, weight=None, bias=None, epsilon=1e-06):
    """Root-mean-square norm over the last axis of ``x`` (any leading
    shape): ``x * rsqrt(mean(x^2) + epsilon) * weight + bias`` with the
    math in f32 and the output in x's dtype; a weight of None scales by 1
    and a bias of None adds nothing (the kernel module's ``rms_norm``, with
    ``has_bias`` when a bias is given)."""
    return _rms_norm(x, weight, bias, epsilon, has_bias=bias is not None)


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, *,
                                 seq_lens=None, segment_ids=None,
                                 generator=None):
    """Attention core in the (B, S, H, D) layout, GQA when H > KVH, with
    the JAX package's argument order. ``generator`` is the port's
    counterpart of JAX's ``rng_key``: the ``torch.Generator`` that dropout
    on the probabilities draws from. ``seq_lens`` (B,) and ``segment_ids``
    (one (B, S) array, or a ``(q_ids, k_ids)`` pair) mask by segment on
    both routes, as in JAX.

    As in JAX, the arguments pick the route: with no ``attn_mask`` and
    ``dropout_p`` 0 it takes :func:`flash_attention` (the forward kernel,
    and dK/dV and dQ under autograd, masked by segment when ids are
    given); otherwise the plain composition, the counterpart of JAX's XLA
    route: f32 scores, a causal -inf mask, a boolean ``attn_mask`` masks
    with -inf and any other is added, then -1e30 where the segments
    differ, softmax, dropout on the probabilities when ``training``, drawn
    from ``generator``. On that route a row with no visible key is JAX's
    (a uniform softmax over its -1e30 entries); on the kernel route it is
    0. JAX also sends lengths that are not multiples of its block of 128
    to the composition; the port's flash kernels take any length, so the
    port does not. A head dim past 256 takes the composition on both
    devices, as JAX's router sends it there (``flash_attention_supported``);
    the flash kernels take up to 256."""
    if (attn_mask is None and not dropout_p > 0.0
            and q.shape[-1] <= MAX_HEAD_DIM):
        return flash_attention(q, k, v, is_causal=is_causal,
                               seq_lens=seq_lens, segment_ids=segment_ids)
    b, sq, d = q.shape[0], q.shape[1], q.shape[3]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    if kh.shape[1] != qh.shape[1]:
        rep = qh.shape[1] // kh.shape[1]
        kh = kh.repeat_interleave(rep, dim=1)
        vh = vh.repeat_interleave(rep, dim=1)
    logits = upcast((qh @ kh.transpose(-1, -2)) * (1.0 / math.sqrt(d)))
    sk = kh.shape[2]
    if is_causal:
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~causal, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.to(logits.dtype)
    q_seg, k_seg = build_segments(b, sq, sk, seq_lens, segment_ids,
                                  device=q.device)
    if q_seg is not None:
        # -1e30, not -inf: a row with no visible key stays finite, as JAX's
        logits = logits.masked_fill(
            q_seg[:, None, :, None] != k_seg[:, None, None, :], -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    probs = dropout(probs, p=dropout_p, training=training,
                    generator=generator)
    return (probs @ vh).transpose(1, 2)


def rotary_position_embedding(q, k, cos, sin, position_ids=None,
                              use_neox_rotary_style=True):
    """Neox RoPE of q (B, S, H, D) and k (B, S, KVH, D) from (P, D) f32
    cos/sin tables. ``position_ids`` is (B, S) or (S,); None means
    ``arange(S)`` for every row. A k of None rotates q alone and returns
    ``(q_rot, None)``, as JAX does. ``use_neox_rotary_style=False`` (the
    interleaved pairs) raises ``NotImplementedError``: not ported yet
    (ROADMAP Queue 2a item 4)."""
    if not use_neox_rotary_style:
        raise NotImplementedError(
            "rotary_position_embedding: use_neox_rotary_style=False (the "
            "interleaved pairs) is not ported yet (ROADMAP Queue 2a item 4)")
    b, s = q.shape[:2]
    if position_ids is None:
        position_ids = torch.arange(s, device=q.device)
    pos = position_ids.to(torch.int32).expand(b, s).contiguous()
    if _records(q, k):
        return RopeFunction.apply(q, k, cos, sin, pos)
    return fused_rope_at(q, k, cos, sin, pos)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, axis=-1):
    """Cross-entropy over ``axis`` of ``logits``, kept there as size 1,
    from the f32 log-softmax, with JAX's signature and semantics. Soft
    labels (a distribution like ``logits``) give ``-sum(label * logp)``.
    Hard labels are class indices; a singleton label axis at ``axis`` is
    squeezed; entries equal to ``ignore_index`` give 0 and are gathered at
    a safe index. Plain torch, as the JAX package computes it in jnp."""
    logp = torch.log_softmax(upcast(logits), dim=axis)
    if soft_label:
        return -(upcast(label) * logp).sum(axis, keepdim=True)
    lab = label
    if lab.dim() == logits.dim() and lab.shape[axis] == 1:
        lab = lab.squeeze(axis)
    lab = lab.long()
    ignored = (lab == ignore_index).unsqueeze(axis)
    safe = lab.masked_fill(lab == ignore_index, 0).unsqueeze(axis)
    picked = logp.gather(axis, safe)
    return (-picked).masked_fill(ignored, 0.0)
