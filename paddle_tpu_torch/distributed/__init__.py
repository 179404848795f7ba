"""Distributed training: so far only ``fleet.recompute`` (activation
checkpointing), which one card's training uses too. Counterpart of
``paddle_tpu/distributed``."""
from . import fleet

__all__ = ["fleet"]
