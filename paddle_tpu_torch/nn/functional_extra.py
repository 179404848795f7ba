"""The packed-QKV flash-attention entries of ``paddle_tpu/nn/
functional_extra.py`` (:799-866): ``flash_attn_qkvpacked`` and
``flash_attn_varlen_qkvpacked``, which runs a packed batch of sequences as
one segment-masked flash call.
"""
from __future__ import annotations

import math

import torch

from ..ops.nn_kernels import scaled_dot_product_attention

__all__ = ["flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked"]


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, *, training=True,
                         generator=None):
    """Packed-QKV flash attention (JAX's :799): ``qkv`` is (B, S, 3, H, D).
    Returns ``(out, None)`` as ``nn.functional.flash_attention``."""
    from .functional import flash_attention

    q, k, v = (qkv[:, :, i].contiguous() for i in range(3))
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           training=training, generator=generator)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False, *, training=True,
                                generator=None):
    """Varlen packed flash attention (JAX's :811): sequences concatenated
    along dim 0 of ``qkv`` (total, 3, H, D) at the ``cu_seqlens_q``
    boundaries; each attends within itself. Returns ``(out, None)``, out
    (total, H, D).

    A custom softmax ``scale`` folds into q as ``scale * sqrt(D)``, since
    the attention takes 1/sqrt(D). With dropout inert the packed buffer
    runs as ONE batch-1 flash call with segment ids from the boundaries
    (within a segment global causal equals local causal, the positions
    being monotone): the segment-masked kernels, which skip the tiles
    between sequences. Dropout > 0 in training, or a buffer that reaches
    past ``cu_seqlens[-1]``, runs the per-segment loop, dropout drawn from
    ``generator``. JAX also loops when ``total % 128 != 0``, where its
    Pallas kernel does not serve; the port's kernels take any length, so
    the port takes the fused route there: the function is the same.
    ``cu_seqlens_k``, ``max_seqlen_q`` and ``max_seqlen_k`` are taken for
    the signature and not read, as in JAX."""
    cu = torch.as_tensor(cu_seqlens_q).to(torch.long)
    bounds = cu.tolist()
    total, d = qkv.shape[0], qkv.shape[-1]
    # one copy makes q, k and v contiguous, as the kernels take them; its
    # backward is one copy too
    q_all, k_all, v_all = qkv.transpose(0, 1).contiguous().unbind(0)
    if scale is not None:
        q_all = q_all * (float(scale) * math.sqrt(d))
    dropout_inert = dropout == 0.0 or not training
    if (dropout_inert and len(bounds) >= 2 and bounds[0] == 0
            and bounds[-1] == total):
        pos = torch.arange(total, device=qkv.device)
        seg = torch.searchsorted(cu[1:].to(qkv.device), pos, right=True)
        out = scaled_dot_product_attention(
            q_all[None], k_all[None], v_all[None], is_causal=causal,
            segment_ids=seg.to(torch.int32)[None])
        return out[0], None
    outs = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        out = scaled_dot_product_attention(
            q_all[None, lo:hi], k_all[None, lo:hi], v_all[None, lo:hi],
            is_causal=causal, dropout_p=dropout, training=training,
            generator=generator)
        outs.append(out[0])
    return torch.cat(outs, 0), None
