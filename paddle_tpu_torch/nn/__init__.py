from . import clip, functional
from .clip import (
    ClipGradByGlobalNorm,
    ClipGradByNorm,
    ClipGradByValue,
    clip_grad_norm_,
)
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm", "clip",
           "clip_grad_norm_", "functional"]
