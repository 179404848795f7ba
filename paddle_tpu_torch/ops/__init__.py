from .nn_kernels import (
    rms_norm,
    rotary_position_embedding,
    scaled_dot_product_attention,
    softmax_with_cross_entropy,
)

__all__ = ["rms_norm", "rotary_position_embedding",
           "scaled_dot_product_attention", "softmax_with_cross_entropy"]
