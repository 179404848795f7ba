"""paddle_tpu_torch.incubate.nn: the fused layers and their functional
surface, counterpart of ``paddle_tpu/incubate/nn``."""
from . import functional
from .fused_transformer import (
    FusedBiasDropoutResidualLayerNorm,
    FusedFeedForward,
    FusedMultiHeadAttention,
    FusedMultiTransformer,
    FusedTransformerEncoderLayer,
)

__all__ = ["functional", "FusedMultiHeadAttention", "FusedFeedForward",
           "FusedTransformerEncoderLayer", "FusedMultiTransformer",
           "FusedBiasDropoutResidualLayerNorm"]
