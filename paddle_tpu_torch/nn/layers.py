"""The layers the LLaMA and BERT slices need: ``Linear``, ``Embedding``,
``RMSNorm``, ``LayerNorm`` and ``Dropout``.

Counterparts of ``paddle_tpu/nn/layers_common.py`` ``Linear`` :68,
``Embedding`` :92 and ``Dropout`` :128 and ``paddle_tpu/nn/layers_norm.py``
``LayerNorm`` :52 and ``RMSNorm`` :74. ``Linear`` keeps the JAX package's
``(in, out)`` weight layout, so a parameter dict moves between the two
packages by name alone. The LLaMA's ``Linear`` layers carry no bias and
draw N(0, std); BERT's carry a zero bias and draw XavierNormal, the JAX
default. Parameters are trainable, as the JAX package's are; inference
runs under ``torch.no_grad``. ``Dropout`` draws its masks from an
explicit ``torch.Generator``, never the global one.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.nn_kernels import dropout, layer_norm, rms_norm

__all__ = ["Linear", "Embedding", "RMSNorm", "LayerNorm", "Dropout"]


def _normal(shape, std, generator, device, dtype):
    """N(0, std) parameter, drawn in f32 from ``generator`` then cast."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w.to(dtype))


class Linear(nn.Module):
    """``y = x @ W (+ b)`` with ``W`` of shape (in_features, out_features),
    drawn N(0, std), or XavierNormal (std = sqrt(2 / (in + out))) when
    ``std`` is None; with ``bias``, a zero (out_features,) ``b``."""

    def __init__(self, in_features, out_features, *, std=None, bias=False,
                 generator, device, dtype):
        super().__init__()
        if std is None:
            std = math.sqrt(2.0 / (in_features + out_features))
        self.weight = _normal((in_features, out_features), std, generator,
                              device, dtype)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    def forward(self, x):
        if self.bias is None:
            return x @ self.weight
        # one GEMM with the bias in its epilogue
        return torch.nn.functional.linear(x, self.weight.t(), self.bias)


class Embedding(nn.Module):
    """Lookup table of shape (num_embeddings, embedding_dim)."""

    def __init__(self, num_embeddings, embedding_dim, *, std, generator,
                 device, dtype):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim), std, generator,
                              device, dtype)

    def forward(self, ids):
        return torch.nn.functional.embedding(ids.long(), self.weight)


class RMSNorm(nn.Module):
    """Root-mean-square norm over the last axis, weight initialised to 1.
    ``bias_attr`` False (the default, as in JAX) gives no bias; anything
    else a zero-initialised one."""

    def __init__(self, hidden_size, epsilon=1e-6, *, bias_attr=False,
                 device, dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))
        self.bias = (None if bias_attr is False else nn.Parameter(
            torch.zeros(hidden_size, device=device, dtype=dtype)))

    def forward(self, x):
        return rms_norm(x, self.weight, self.bias, epsilon=self.epsilon)


class LayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape``, weight 1, bias 0."""

    def __init__(self, normalized_shape, epsilon=1e-5, *, device, dtype):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.epsilon,
                          begin_norm_axis=-len(self.normalized_shape))


class Dropout(nn.Module):
    """Dropout with probability ``p`` while training, the identity in
    eval; masks come from ``generator``, which lives on the device of the
    tensors it drops."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", *,
                 generator):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode
        self.generator = generator

    def forward(self, x):
        return dropout(x, p=self.p, axis=self.axis, training=self.training,
                       mode=self.mode, generator=self.generator)
