"""Fused transformer layers.

Counterpart of ``paddle_tpu/incubate/nn/fused_transformer.py``:
``FusedMultiHeadAttention``, ``FusedFeedForward``,
``FusedTransformerEncoderLayer``, ``FusedMultiTransformer`` and
``FusedBiasDropoutResidualLayerNorm``, with the JAX layers' parameter
names, pre/post-LN wiring and epsilon 1e-5. The attention core takes the
flash kernels when no mask or attention dropout is given, and the plain
composition otherwise (``ops/nn_kernels.py``);
``FusedBiasDropoutResidualLayerNorm`` runs the bias-dropout-residual-
LayerNorm kernel. Everything else is plain PyTorch, as JAX leaves it to
XLA.

Each constructor also takes ``device`` (None: the GPU), ``dtype`` and a
``generator`` that draws the weights and then the dropout masks (None:
``seed(0)`` on the device). The JAX constructors' initializer attributes,
``kdim``/``vdim``/``need_weights`` (which JAX ignores too) and the
tensor-parallel ``nranks``/``ring_id`` are not taken.
"""
from __future__ import annotations

import torch
from torch import nn

from ...core.place import placed
from ...nn.layers import Dropout, LayerNorm, Linear
from ...ops.nn_kernels import gelu, scaled_dot_product_attention
from .functional import fused_bias_dropout_residual_layer_norm

__all__ = ["FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm"]

_ACTIVATIONS = {"relu": torch.relu, "gelu": gelu}


class FusedMultiHeadAttention(nn.Module):
    """(optional pre-LN) -> qkv projection -> attention -> out projection
    -> dropout -> residual (-> post-LN). ``pre_ln`` exists in post-LN mode
    too, as in JAX, where it takes no part in the forward."""

    def __init__(self, embed_dim, num_heads, dropout_rate=0.5,
                 attn_dropout_rate=0.5, normalize_before=False,
                 pre_ln_epsilon=1e-5, ln_epsilon=1e-5, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        device, generator = placed(device, generator)
        init = dict(bias=True, generator=generator, device=device,
                    dtype=dtype)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.normalize_before = normalize_before
        self.generator = generator
        self.qkv_proj = Linear(embed_dim, 3 * embed_dim, **init)
        self.out_proj = Linear(embed_dim, embed_dim, **init)
        self.pre_ln = LayerNorm(embed_dim, pre_ln_epsilon, device=device,
                                dtype=dtype)
        self.ln = LayerNorm(embed_dim, ln_epsilon, device=device, dtype=dtype)
        self.dropout = Dropout(dropout_rate, generator=generator)
        self.attn_dropout_rate = attn_dropout_rate

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        residual = query
        x = self.pre_ln(query) if self.normalize_before else query
        b, s, _ = x.shape
        qkv = self.qkv_proj(x).view(b, s, 3, self.num_heads, self.head_dim)
        # JAX slices qkv[:, :, i]; one copy to (3, B, S, H, D) gives the
        # same q, k, v, each contiguous, as the flash kernels take them
        q, k, v = qkv.permute(2, 0, 1, 3, 4).contiguous().unbind(0)
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask,
            dropout_p=self.attn_dropout_rate if self.training else 0.0,
            training=self.training, generator=self.generator)
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        out = residual + self.dropout(out)
        if not self.normalize_before:
            out = self.ln(out)
        return out


class FusedFeedForward(nn.Module):
    """(optional pre-LN) -> linear -> activation -> dropout -> linear ->
    dropout -> residual (-> post-LN). ``activation`` is "relu" or "gelu"
    (exact)."""

    def __init__(self, d_model, dim_feedforward, dropout_rate=0.1,
                 epsilon=1e-5, activation="relu", act_dropout_rate=None,
                 normalize_before=False, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r} is not one of "
                             f"{sorted(_ACTIVATIONS)}")
        device, generator = placed(device, generator)
        init = dict(bias=True, generator=generator, device=device,
                    dtype=dtype)
        self.linear1 = Linear(d_model, dim_feedforward, **init)
        self.linear2 = Linear(dim_feedforward, d_model, **init)
        self.ln = LayerNorm(d_model, epsilon, device=device, dtype=dtype)
        self.dropout = Dropout(dropout_rate, generator=generator)
        self.act_dropout = Dropout(
            dropout_rate if act_dropout_rate is None else act_dropout_rate,
            generator=generator)
        self.activation = _ACTIVATIONS[activation]
        self.normalize_before = normalize_before

    def forward(self, x):
        residual = x
        if self.normalize_before:
            x = self.ln(x)
        x = self.act_dropout(self.activation(self.linear1(x)))
        x = residual + self.dropout(self.linear2(x))
        if not self.normalize_before:
            x = self.ln(x)
        return x


class FusedTransformerEncoderLayer(nn.Module):
    """``FusedMultiHeadAttention`` then ``FusedFeedForward``: the encoder
    block BERT is built from."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout_rate=0.1,
                 activation="relu", attn_dropout_rate=None,
                 act_dropout_rate=None, normalize_before=False, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        device, generator = placed(device, generator)
        init = dict(device=device, dtype=dtype, generator=generator)
        self.fused_attn = FusedMultiHeadAttention(
            d_model, nhead, dropout_rate=dropout_rate,
            attn_dropout_rate=(dropout_rate if attn_dropout_rate is None
                               else attn_dropout_rate),
            normalize_before=normalize_before, **init)
        self.ffn = FusedFeedForward(
            d_model, dim_feedforward, dropout_rate=dropout_rate,
            activation=activation, act_dropout_rate=act_dropout_rate,
            normalize_before=normalize_before, **init)

    def forward(self, src, src_mask=None, cache=None):
        return self.ffn(self.fused_attn(src, attn_mask=src_mask))


class FusedMultiTransformer(nn.Module):
    """``num_layers`` encoder blocks of one configuration, pre-LN by
    default. ``caches`` is taken and ignored, as in JAX."""

    def __init__(self, embed_dim, num_heads, dim_feedforward,
                 dropout_rate=0.0, activation="gelu", normalize_before=True,
                 num_layers=1, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        device, generator = placed(device, generator)
        self.layers = nn.ModuleList([
            FusedTransformerEncoderLayer(
                embed_dim, num_heads, dim_feedforward,
                dropout_rate=dropout_rate, activation=activation,
                normalize_before=normalize_before, device=device,
                dtype=dtype, generator=generator)
            for _ in range(num_layers)])

    def forward(self, src, attn_mask=None, caches=None):
        x = src
        for layer in self.layers:
            x = layer(x, src_mask=attn_mask)
        return x


class FusedBiasDropoutResidualLayerNorm(nn.Module):
    """``layer_norm(residual + dropout(x + linear_bias))`` with learnable
    ``ln_scale`` (ones) and ``ln_bias`` and ``linear_bias`` (zeros): one
    launch of the fused kernel on the card, its masks drawn from the
    layer's generator."""

    def __init__(self, embed_dim, dropout_rate=0.5, epsilon=1e-5, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if embed_dim <= 0:
            raise ValueError(f"embed_dim must be positive, got {embed_dim}")
        device, generator = placed(device, generator)
        self.embed_dim = embed_dim
        self.dropout_rate = dropout_rate
        self._epsilon = epsilon
        self.generator = generator
        self.linear_bias = nn.Parameter(
            torch.zeros(embed_dim, device=device, dtype=dtype))
        self.ln_scale = nn.Parameter(
            torch.ones(embed_dim, device=device, dtype=dtype))
        self.ln_bias = nn.Parameter(
            torch.zeros(embed_dim, device=device, dtype=dtype))

    def forward(self, x, residual):
        return fused_bias_dropout_residual_layer_norm(
            x, residual, self.linear_bias, self.ln_scale, self.ln_bias,
            dropout_rate=self.dropout_rate, ln_epsilon=self._epsilon,
            training=self.training, generator=self.generator)

    def extra_repr(self):
        return f"embed_dim={self.embed_dim}, dropout_rate={self.dropout_rate}"
