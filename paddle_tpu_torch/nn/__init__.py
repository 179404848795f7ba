from . import functional
from .layers import Dropout, Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["Dropout", "Embedding", "LayerNorm", "Linear", "RMSNorm",
           "functional"]
