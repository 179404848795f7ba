"""``nn.functional``: the port's counterpart of ``paddle_tpu/nn/
functional.py`` for the attention entries: ``scaled_dot_product_attention``
(the op of ``ops/nn_kernels.py``) and the reference-compatible
``flash_attention`` (JAX's :104), plus the packed-QKV entries of
:mod:`.functional_extra`. The rest of JAX's functional surface is still to
port (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from ..ops.nn_kernels import scaled_dot_product_attention

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_qkvpacked", "flash_attn_varlen_qkvpacked"]


def flash_attention(query, key, value, dropout=0.0, causal=False, *,
                    training=True, generator=None):
    """Reference-compatible alias (JAX's :104-112): the flash-attention
    kernels when ``dropout`` is inert, else the composition with dropout
    on the probabilities, drawn from ``generator``. Returns ``(out,
    None)``, the second the softmax-lse placeholder."""
    out = scaled_dot_product_attention(
        query, key, value, attn_mask=None, dropout_p=dropout,
        is_causal=causal, training=training, generator=generator)
    return out, None


from .functional_extra import *  # noqa: E402,F401,F403
