"""The fused functional surface, with the names of
``paddle_tpu/incubate/nn/functional.py``: thin names over the port's ops.
``fused_bias_dropout_residual_layer_norm`` runs the hand-written
bias-dropout-residual-LayerNorm kernel; ``fused_rms_norm``,
``fused_rotary_position_embedding`` and ``fused_dot_product_attention``
are the port's kernel ops under their JAX names. Dropout masks come from
an explicit ``generator`` where JAX draws from its global key.
"""
from __future__ import annotations

from ...ops import nn_kernels
from ...ops.fused_ce import fused_linear_cross_entropy
from ...ops.nn_kernels import gelu, layer_norm
from ...ops.nn_kernels import rms_norm as fused_rms_norm
from ...ops.nn_kernels import (
    rotary_position_embedding as fused_rotary_position_embedding,
)
from ...ops.nn_kernels import (
    scaled_dot_product_attention as fused_dot_product_attention,
)

__all__ = ["fused_linear_cross_entropy", "fused_rms_norm",
           "fused_rotary_position_embedding", "fused_dot_product_attention",
           "fused_linear", "fused_feedforward", "fused_layer_norm",
           "fused_bias_dropout_residual_layer_norm"]


def fused_linear(x, weight, bias=None, transpose_weight=False):
    """``x @ weight (+ bias)``; ``weight`` is (in, out), or (out, in) with
    ``transpose_weight``."""
    y = x @ (weight.t() if transpose_weight else weight)
    return y + bias if bias is not None else y


def fused_feedforward(x, linear1_weight, linear2_weight, *args, **kwargs):
    """``gelu(x @ linear1_weight) @ linear2_weight``, exactly as the JAX
    function computes it: no biases, no dropout, whatever else is
    passed."""
    return gelu(x @ linear1_weight) @ linear2_weight


def fused_layer_norm(x, weight, bias, epsilon=1e-5, begin_norm_axis=1):
    return layer_norm(x, weight, bias, epsilon=epsilon,
                      begin_norm_axis=begin_norm_axis)


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode="upscale_in_train", name=None, *, generator=None):
    """``layer_norm(residual + dropout(x + bias))``: one launch of the
    fused kernel for ``upscale_in_train`` (see
    ``ops/nn_kernels.py`` ``fused_bias_dropout_residual_layer_norm``)."""
    return nn_kernels.fused_bias_dropout_residual_layer_norm(
        x, residual, bias, ln_scale, ln_bias, dropout_rate=dropout_rate,
        ln_epsilon=ln_epsilon, training=training, mode=mode,
        generator=generator)
