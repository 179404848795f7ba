from .nn_kernels import (
    dropout,
    fused_bias_dropout_residual_layer_norm,
    gelu,
    layer_norm,
    rms_norm,
    rotary_position_embedding,
    scaled_dot_product_attention,
    softmax_with_cross_entropy,
)

__all__ = ["dropout", "fused_bias_dropout_residual_layer_norm", "gelu",
           "layer_norm", "rms_norm", "rotary_position_embedding",
           "scaled_dot_product_attention", "softmax_with_cross_entropy"]
