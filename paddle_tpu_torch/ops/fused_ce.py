"""Blockwise fused lm-head + softmax cross-entropy.

Counterpart of ``paddle_tpu/ops/fused_ce.py`` ``fused_linear_cross_entropy``
(:212, custom_vjp :102-195): the (N, V) logits never exist whole. The
forward walks the vocab one block at a time with an online (max,
sum-exp) accumulator and picks the label's logit in the block that holds
it; the backward recomputes each block's logits from the saved
log-sum-exp, forms ``softmax * g`` block by block, and subtracts the
one-hot term at the end. Peak memory is O(N * block + V * H) instead of
O(N * V). The JAX package has no Pallas kernel here, so this is plain
torch: the block products are library GEMMs, as XLA's are.

Block logits are f32: the operands are raised to f32 first, so each logit
is the f32 sum of the products, as the JAX ``dot_general`` with
``preferred_element_type=f32`` computes it. The last block is simply
shorter, where the JAX package pads the weight. The vocab-sharded (TP)
branch waits for tensor parallelism.
"""
from __future__ import annotations

import torch

from .cuda._build import upcast

__all__ = ["fused_linear_cross_entropy"]


def _pick_block(v):
    """Largest 128-multiple block <= 4096 that divides the 128-rounded
    vocab (32000 -> 3200), else 4096 (the JAX package's rule)."""
    vpad = -(-v // 128) * 128
    for d in range(32, 7, -1):
        if vpad % (128 * d) == 0:
            return 128 * d
    return min(vpad, 4096)


def _blocks(v, block):
    return [(start, min(start + block, v)) for start in range(0, v, block)]


def _block_weight(weight, start, end, transpose_y):
    """The block's weight as (H, block), whatever the layout."""
    if transpose_y:  # (V, H)
        return upcast(weight[start:end]).t()
    return upcast(weight[:, start:end])  # (H, V)


class _FusedLinearCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2d, weight, labels, transpose_y, ignore_index, block):
        v = weight.shape[0] if transpose_y else weight.shape[1]
        xf = upcast(x2d)
        n = xf.shape[0]
        m = torch.full((n,), torch.finfo(xf.dtype).min, dtype=xf.dtype,
                       device=xf.device)
        s = torch.zeros_like(m)
        picked = torch.zeros_like(m)
        for start, end in _blocks(v, block):
            logits = xf @ _block_weight(weight, start, end, transpose_y)
            nm = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - nm) + torch.exp(
                logits - nm[:, None]).sum(-1)
            m = nm
            rel = labels - start
            inb = (rel >= 0) & (rel < end - start)
            pick = logits.gather(1, rel.clamp(0, end - start - 1)[:, None])
            picked = picked + torch.where(inb, pick[:, 0], 0.0)
        lse = m + torch.log(s)
        valid = labels != ignore_index
        ctx.save_for_backward(x2d, weight, labels, lse)
        ctx.args = (transpose_y, ignore_index, block)
        return torch.where(valid, lse - picked, 0.0)

    @staticmethod
    def backward(ctx, g):
        x2d, weight, labels, lse = ctx.saved_tensors
        transpose_y, ignore_index, block = ctx.args
        v = weight.shape[0] if transpose_y else weight.shape[1]
        xf = upcast(x2d)
        valid = labels != ignore_index
        gv = torch.where(valid, g.to(xf.dtype), 0.0)
        dx = torch.zeros_like(xf)
        dw = torch.empty(weight.shape, dtype=xf.dtype, device=xf.device)
        for start, end in _blocks(v, block):
            wb = _block_weight(weight, start, end, transpose_y)  # (H, blk)
            pg = torch.exp(xf @ wb - lse[:, None]) * gv[:, None]
            dx += pg @ wb.t()
            if transpose_y:
                dw[start:end] = pg.t() @ xf
            else:
                dw[:, start:end] = xf.t() @ pg
        # the one-hot term of softmax - onehot, scaled by g
        safe = labels.masked_fill(~valid, 0)
        corr = gv[:, None] * xf
        if transpose_y:
            dx -= gv[:, None] * upcast(weight[safe])
            dw.index_add_(0, safe, -corr)
        else:
            dx -= gv[:, None] * upcast(weight[:, safe]).t()
            dw.index_add_(1, safe, -corr.t())
        return (dx.to(x2d.dtype), dw.to(weight.dtype), None, None, None,
                None)


def fused_linear_cross_entropy(x, weight, label, transpose_y=True,
                               ignore_index=-100, block_size=0):
    """``cross_entropy(x @ W(^T), label)`` without the whole logits.

    ``x`` is (..., H); ``weight`` is (V, H) with ``transpose_y`` (the
    tied-embedding layout) or (H, V) (the ``Linear`` layout); ``label`` is
    (...) or (..., 1) integer ids, and ``ignore_index`` positions give 0.
    ``block_size`` is the vocab block (0: the JAX package's choice).
    Returns the per-position loss, shape (...), in f32."""
    lead = x.shape[:-1]
    h = x.shape[-1]
    v = weight.shape[0] if transpose_y else weight.shape[1]
    if label.dim() == x.dim() and label.shape[-1] == 1:
        label = label[..., 0]
    if tuple(label.shape) != tuple(lead):
        raise ValueError(f"label shape {tuple(label.shape)} must match x "
                         f"leading dims {tuple(lead)}")
    block = int(block_size) or _pick_block(v)
    loss = _FusedLinearCE.apply(x.reshape(-1, h), weight,
                                label.reshape(-1).long(), bool(transpose_y),
                                int(ignore_index), block)
    return loss.reshape(lead)
