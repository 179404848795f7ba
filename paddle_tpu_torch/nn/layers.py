"""The layers the LLaMA slice needs: ``Linear``, ``Embedding``, ``RMSNorm``.

Counterparts of ``paddle_tpu/nn/layers_common.py`` ``Linear`` :68 and
``Embedding`` :92 and ``paddle_tpu/nn/layers_norm.py`` ``RMSNorm`` :74.
``Linear`` keeps the JAX package's ``(in, out)`` weight layout, so a
parameter dict moves between the two packages by name alone. The LLaMA
layers carry no biases, and neither do these. Parameters are trainable,
as the JAX package's are; inference runs under ``torch.no_grad``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.nn_kernels import rms_norm

__all__ = ["Linear", "Embedding", "RMSNorm"]


def _normal(shape, std, generator, device, dtype):
    """N(0, std) parameter, drawn in f32 from ``generator`` then cast."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w.to(dtype))


class Linear(nn.Module):
    """``y = x @ W`` with ``W`` of shape (in_features, out_features)."""

    def __init__(self, in_features, out_features, *, std, generator, device,
                 dtype):
        super().__init__()
        self.weight = _normal((in_features, out_features), std, generator,
                              device, dtype)

    def forward(self, x):
        return x @ self.weight


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
    """Root-mean-square norm over the last axis, weight initialised to 1."""

    def __init__(self, hidden_size, epsilon=1e-6, *, device, dtype):
        super().__init__()
        self.epsilon = epsilon
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype))

    def forward(self, x):
        return rms_norm(x, self.weight, self.epsilon)
