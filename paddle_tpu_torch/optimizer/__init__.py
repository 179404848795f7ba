from . import lr
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "lr"]
