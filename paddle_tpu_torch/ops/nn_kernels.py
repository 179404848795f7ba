"""The model-facing ops that the port's kernels serve, with the JAX
package's signatures (``paddle_tpu/ops/nn_kernels.py`` ``rms_norm`` :162,
``scaled_dot_product_attention`` :732, ``rotary_position_embedding``
:804, ``softmax_with_cross_entropy`` :859). Each kernel op routes through
its kernel's wrapper, which launches the kernel on a CUDA tensor and runs
the plain version on a CPU tensor. When autograd records the call, it
goes through the kernel's ``torch.autograd.Function``, whose backward is
the backward kernel (or its plain version on the CPU); otherwise (under
``torch.no_grad``, as in serving) the forward launches alone.

The port runs eagerly, so RMSNorm takes its kernel on every call: the
counterpart of the JAX package's eager dispatch, not of its traced
programs (which keep the jnp composition).
"""
from __future__ import annotations

import torch

from .cuda._build import upcast
from .cuda.flash_attention import FlashAttentionFunction, flash_attention
from .cuda.fused_ops import RopeFunction, fused_rope
from .cuda.rms_norm import RMSNormFunction
from .cuda.rms_norm import rms_norm as _rms_norm_rows

__all__ = ["rms_norm", "scaled_dot_product_attention",
           "rotary_position_embedding", "softmax_with_cross_entropy"]


def _records(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def rms_norm(x, weight, epsilon=1e-6):
    """Root-mean-square norm over the last axis of ``x`` (any leading
    shape); math in f32, output in x's dtype."""
    x2 = x.reshape(-1, x.shape[-1])
    if _records(x, weight):
        y = RMSNormFunction.apply(x2, weight, epsilon)
    else:
        y, _ = _rms_norm_rows(x2, weight, epsilon)
    return y.reshape(x.shape)


def scaled_dot_product_attention(q, k, v, is_causal=False):
    """Attention core in the (B, S, H, D) layout, GQA when H > KVH."""
    if _records(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, is_causal)
    out, _ = flash_attention(q, k, v, causal=is_causal)
    return out


def rotary_position_embedding(q, k, cos, sin, position_ids=None):
    """Neox RoPE of q (B, S, H, D) and k (B, S, KVH, D) from (P, D) f32
    cos/sin tables. ``position_ids`` is (B, S) or (S,); None means
    ``arange(S)`` for every row."""
    b, s = q.shape[:2]
    if position_ids is None:
        position_ids = torch.arange(s, device=q.device)
    pos = position_ids.to(torch.int32).expand(b, s).contiguous()
    if _records(q, k):
        return RopeFunction.apply(q, k, cos, sin, pos)
    return fused_rope(q, k, cos, sin, pos)


def softmax_with_cross_entropy(logits, label, ignore_index=-100):
    """Per-position cross-entropy over the last axis, kept as size 1:
    the negated f32 log-softmax of ``logits`` at the label; labels equal to
    ``ignore_index`` give 0 (and are gathered at a safe index). A label
    with a trailing singleton axis is accepted. Plain torch, as the JAX
    package computes it in jnp."""
    logp = torch.log_softmax(upcast(logits), dim=-1)
    lab = (label[..., 0] if label.dim() == logits.dim() else label).long()
    ignored = (lab == ignore_index)[..., None]
    picked = logp.gather(-1, lab[..., None].masked_fill(ignored, 0))
    return (-picked).masked_fill(ignored, 0.0)
