"""Recompute (activation checkpointing).

Counterpart of ``paddle_tpu/distributed/fleet/recompute.py``: ``recompute``
:29 and ``recompute_sequential`` :139. JAX rematerialises a traced block
with ``jax.checkpoint`` and an eager one with a grad node of its own that
stores the inputs and the RNG state and reruns the block in its backward.
The port hands the block to ``torch.utils.checkpoint`` in its
non-reentrant form, which does the same: the forward keeps only the
block's inputs, the backward reruns the block with the RNG state of the
first run (``preserve_rng_state``, on by default) and then runs the
block's own backward on the rerun's tensors. With gradients off the block
just runs, as in JAX.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute", "recompute_sequential"]


def recompute(function, *args, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward instead of stored. ``preserve_rng_state`` (default True) is
    taken from ``kwargs``; ``use_reentrant`` is accepted and ignored, as in
    JAX (the port always checkpoints non-reentrantly)."""
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve_rng_state, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Segmented recompute over a sequence of layers (an ``nn.Sequential``
    or any module's children, or a list of callables): split into
    ``ctx["segments"]`` chunks (default 1), each checkpointed by
    :func:`recompute`; each layer takes the previous one's output."""
    segments = (ctx or {}).get("segments", 1)
    if hasattr(functions, "children"):
        functions = list(functions.children())
    functions = list(functions)
    seg_size = max(len(functions) // max(segments, 1), 1)

    def make_seg(fs):
        def run(*xs):
            out = xs[0] if len(xs) == 1 else xs
            for f in fs:
                out = f(out)
            return out

        return run

    out = args[0] if len(args) == 1 else args
    for s in range(0, len(functions), seg_size):
        out = recompute(make_seg(functions[s:s + seg_size]), out, **kwargs)
    return out
