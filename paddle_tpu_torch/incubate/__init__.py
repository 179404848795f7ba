"""paddle_tpu_torch.incubate: the fused-layer surface of
``paddle_tpu/incubate`` (its ``nn`` package)."""
from . import nn

__all__ = ["nn"]
