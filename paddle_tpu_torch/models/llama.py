"""LLaMA: the model, its paged KV cache and cached attention, and its
training loss.

Counterpart of ``paddle_tpu/models/llama.py``: ``LlamaConfig``,
``_rope_tables`` :319, ``PagedKVCache`` :137, ``cached_attention`` :251,
``LlamaAttention``, ``LlamaMLP``, ``LlamaDecoderLayer``, ``LlamaModel``,
``LlamaForCausalLM`` (with the ``labels=`` loss, :578-592),
``causal_lm_loss`` :525 and ``LlamaPretrainingCriterion`` :603. Inside
``megakernel_scope(True)`` (the serving engine's decode steps) a decode
layer over a paged cache with per-sequence depths runs its attention half
as one fused kernel launch (``ops/cuda/decode_megakernel.py``; JAX
``LlamaDecoderLayer._fused_decode_forward`` :457). Parameter
names match the JAX model's, so ``models.convert`` loads its
``raw_state()`` by name. Activations are (batch, seq, hidden); attention
runs in (B, S, H, D). ``use_recompute`` checkpoints each decoder layer
(``distributed/fleet/recompute.py``), as JAX's ``LlamaModel.forward``
:508-516 does; the vocab-sharded loss branch is not ported yet. Every
forward takes JAX's ``attn_mask`` at JAX's position: a given mask sends
attention down the plain composition of
``scaled_dot_product_attention`` (``is_causal=attn_mask is None``), and a
paged cache ignores it, as in JAX.

The port updates the KV pools in place (the JAX cache returns new
arrays): ``PagedKVCache.update`` writes into ``k_pages``/``v_pages`` and
advances ``length``, and ``forward(..., caches=...)`` returns only the
logits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core.place import placed
from ..distributed.fleet.recompute import recompute
from ..nn.layers import Embedding, Linear, RMSNorm
from ..ops.cuda.decode_attention import paged_attention
from ..ops.cuda.decode_megakernel import (
    fused_decode_layer,
    megakernel_enabled,
    megakernel_supported,
)
from ..ops.fused_ce import fused_linear_cross_entropy
from ..ops.nn_kernels import (
    rotary_position_embedding,
    scaled_dot_product_attention,
    softmax_with_cross_entropy,
)

__all__ = ["LlamaConfig", "PagedKVCache", "cached_attention",
           "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM", "LlamaPretrainingCriterion", "causal_lm_loss"]


@dataclasses.dataclass
class LlamaConfig:
    """Architecture hyperparameters, with the JAX config's field names."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int | None = None
    max_position_embeddings: int = 4096
    initializer_range: float = 0.02
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    # JAX's last four fields: use_recompute checkpoints each decoder layer;
    # the other three are stored and read by nothing, as in JAX
    use_recompute: bool = False
    sequence_parallel: bool = False
    use_flash_attention: bool = True
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


class PagedKVCache:
    """Paged KV cache for one attention layer: KV lives in fixed-size pages
    of a shared pool ``(num_pages, page_size, KVH, D)``; ``tables`` (B,
    cols) int32 maps each sequence's logical pages to physical ones.
    Built standalone, page j of sequence b is pool page ``j * batch + b``
    (interleaved, so the indirection is exercised), as in the JAX cache.

    ``length`` is an int (every sequence at the same depth) or a (B,)
    int32 tensor of per-sequence depths (continuous batching).
    ``attn_pages`` caps the table columns attention reads (the engine's
    tables carry write-scratch columns past ``max_len``). ``dump_page`` is
    the engine's sacrificial page id, handed to the fused decode layer for
    parity with the JAX cache (it changes nothing in the port)."""

    __slots__ = ("k_pages", "v_pages", "tables", "page_size", "length",
                 "attn_pages", "dump_page")

    def __init__(self, batch, max_len, kv_heads, head_dim, page_size=128, *,
                 device, dtype):
        page_size = min(page_size, max_len)
        if max_len % page_size:
            raise ValueError(
                f"max_len {max_len} not divisible by page_size {page_size}")
        per_seq = max_len // page_size
        shape = (batch * per_seq, page_size, kv_heads, head_dim)
        self.k_pages = torch.zeros(shape, device=device, dtype=dtype)
        self.v_pages = torch.zeros_like(self.k_pages)
        cols = torch.arange(per_seq, dtype=torch.int32, device=device)
        rows = torch.arange(batch, dtype=torch.int32, device=device)
        self.tables = cols[None, :] * batch + rows[:, None]
        self.page_size = page_size
        self.length = 0
        self.attn_pages = None
        self.dump_page = None

    def update(self, k_new, v_new):
        """Write (B, S, KVH, D) keys/values at positions
        ``[length, length + S)`` of each sequence, in place, and advance
        ``length``. Rows whose table cells point at the same page (the
        engine's dump page) write it in an unspecified order; such pages
        are never read."""
        b, s = k_new.shape[:2]
        steps = torch.arange(s, device=k_new.device)
        if isinstance(self.length, int):
            pos = (self.length + steps).expand(b, s)
        else:
            pos = self.length.long()[:, None] + steps[None, :]
        page_ids = self.tables.gather(1, pos // self.page_size).long()
        off = pos % self.page_size
        self.k_pages[page_ids, off] = k_new.to(self.k_pages.dtype)
        self.v_pages[page_ids, off] = v_new.to(self.v_pages.dtype)
        self.length = self.length + s


def cached_attention(q, k, v, cache, offset, s):
    """Attention over a paged cache after writing the new k/v into it.
    Decode (s == 1) runs the paged decode-attention kernel over the
    post-update lengths; a prefill at static offset 0 attends among its
    own tokens through causal flash attention. A multi-token write at a
    nonzero offset (a chunk of a chunked prefill, or a prefix-cache
    resume, at per-row bases that may sit mid-page) takes JAX's route
    (``paddle_tpu/models/llama.py`` :312-330): the first ``attn_pages``
    table columns gathered into (B, attn_pages * page, KVH, D), a boolean
    mask of column <= base + i for row i, and the plain composition of
    ``scaled_dot_product_attention`` (a dense mask declines the flash
    kernel on both packages)."""
    cache.update(k, v)
    if s == 1:
        clen = cache.length
        lengths = (torch.full((q.shape[0],), clen, dtype=torch.int32,
                              device=q.device)
                   if isinstance(clen, int) else clen.to(torch.int32))
        out = paged_attention(q[:, 0], cache.k_pages, cache.v_pages,
                              cache.tables, lengths,
                              pages_per_seq=cache.attn_pages)
        return out[:, None]
    if isinstance(offset, int) and offset == 0:
        return scaled_dot_product_attention(q, k, v, is_causal=True)
    tables = cache.tables
    ap = cache.attn_pages
    if ap is not None and ap < tables.shape[1]:
        tables = tables[:, :ap]
    b = q.shape[0]
    tables = tables.long()
    k_all = cache.k_pages[tables].reshape(b, -1, *cache.k_pages.shape[2:])
    v_all = cache.v_pages[tables].reshape(b, -1, *cache.v_pages.shape[2:])
    cols = torch.arange(k_all.shape[1], device=q.device)
    steps = torch.arange(s, device=q.device)
    if isinstance(offset, int):
        mask = (cols[None, :] <= (steps[:, None] + offset))[None, None]
    else:  # per-row bases: a (B, 1, s, K) mask
        rows = offset.long()[:, None] + steps[None, :]
        mask = cols[None, None, None, :] <= rows[:, None, :, None]
    return scaled_dot_product_attention(q, k_all, v_all, attn_mask=mask)


def _rope_tables(head_dim, max_pos, theta, device):
    """(max_pos, head_dim) f32 cos/sin tables in the neox layout."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                / head_dim))
    freqs = np.outer(np.arange(max_pos, dtype=np.float64), inv_freq)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.tensor(np.cos(emb), dtype=torch.float32, device=device),
            torch.tensor(np.sin(emb), dtype=torch.float32, device=device))


class LlamaAttention(nn.Module):
    """Multi-head attention with RoPE and grouped-query KV. The rope
    tables stay f32 whatever the model's dtype: the RoPE kernel does its
    math in f32."""

    def __init__(self, config: LlamaConfig, *, generator, device, dtype):
        super().__init__()
        self.config = config
        h, kv, d = (config.num_attention_heads, config.num_key_value_heads,
                    config.head_dim)
        init = dict(std=config.initializer_range, generator=generator,
                    device=device, dtype=dtype)
        self.q_proj = Linear(config.hidden_size, h * d, **init)
        self.k_proj = Linear(config.hidden_size, kv * d, **init)
        self.v_proj = Linear(config.hidden_size, kv * d, **init)
        self.o_proj = Linear(h * d, config.hidden_size, **init)
        cos, sin = _rope_tables(d, config.max_position_embeddings,
                                config.rope_theta, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, hidden_states, attn_mask=None, cache=None):
        cfg = self.config
        b, s, _ = hidden_states.shape
        h, kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        q = self.q_proj(hidden_states).view(b, s, h, d)
        k = self.k_proj(hidden_states).view(b, s, kv, d)
        v = self.v_proj(hidden_states).view(b, s, kv, d)
        if cache is None:
            q, k = rotary_position_embedding(q, k, self.rope_cos,
                                             self.rope_sin)
            out = scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                               is_causal=attn_mask is None)
        else:
            offset = cache.length
            steps = torch.arange(s, device=q.device)
            if isinstance(offset, int):  # one depth for every sequence
                position_ids = None if offset == 0 else steps + offset
            else:  # per-slot depths (continuous batching)
                position_ids = offset.long()[:, None] + steps[None, :]
            q, k = rotary_position_embedding(q, k, self.rope_cos,
                                             self.rope_sin, position_ids)
            out = cached_attention(q, k, v, cache, offset, s)
        return self.o_proj(out.reshape(b, s, h * d))


class LlamaMLP(nn.Module):
    """SwiGLU feed-forward: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig, *, generator, device, dtype):
        super().__init__()
        init = dict(std=config.initializer_range, generator=generator,
                    device=device, dtype=dtype)
        self.gate_proj = Linear(config.hidden_size, config.intermediate_size,
                                **init)
        self.up_proj = Linear(config.hidden_size, config.intermediate_size,
                              **init)
        self.down_proj = Linear(config.intermediate_size, config.hidden_size,
                                **init)

    def forward(self, x):
        return self.down_proj(
            torch.nn.functional.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, *, generator, device, dtype):
        super().__init__()
        init = dict(generator=generator, device=device, dtype=dtype)
        self.self_attn = LlamaAttention(config, **init)
        self.mlp = LlamaMLP(config, **init)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       config.rms_norm_eps, device=device,
                                       dtype=dtype)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, config.rms_norm_eps, device=device,
            dtype=dtype)

    def forward(self, hidden_states, attn_mask=None, cache=None):
        if cache is not None and self._megakernel_step(hidden_states, cache):
            return self._fused_decode_forward(hidden_states, cache)
        hidden_states = hidden_states + self.self_attn(
            self.input_layernorm(hidden_states), attn_mask=attn_mask,
            cache=cache)
        return hidden_states + self.mlp(
            self.post_attention_layernorm(hidden_states))

    def _megakernel_step(self, hidden_states, cache):
        """True when this call is a decode step the fused kernel takes: one
        token over a paged cache with per-sequence depths, inside
        ``megakernel_scope(True)``, on a supported layer."""
        if not isinstance(cache, PagedKVCache) or hidden_states.shape[1] != 1:
            return False
        return megakernel_enabled() and megakernel_supported(self, cache)

    def _fused_decode_forward(self, hidden_states, cache):
        """One fused decode step: the attention half (ln1 -> qkv -> RoPE ->
        paged append -> paged attention -> o_proj -> residual -> ln2) is one
        kernel launch that writes the new k/v rows into the pools; the MLP
        half runs on its ``y2``. The cache's length advances by one, as
        ``cache.update`` advances it."""
        attn = self.self_attn
        h_mid, y2 = fused_decode_layer(
            hidden_states,
            ln1_weight=self.input_layernorm.weight,
            ln1_eps=self.input_layernorm.epsilon,
            wq=attn.q_proj.weight, wk=attn.k_proj.weight,
            wv=attn.v_proj.weight, wo=attn.o_proj.weight,
            rope_cos=attn.rope_cos, rope_sin=attn.rope_sin,
            ln2_weight=self.post_attention_layernorm.weight,
            ln2_eps=self.post_attention_layernorm.epsilon,
            k_pages=cache.k_pages, v_pages=cache.v_pages,
            tables=cache.tables, lengths=cache.length.to(torch.int32),
            heads=attn.config.num_attention_heads,
            attn_pages=cache.attn_pages, dump_page=cache.dump_page)
        cache.length = cache.length + 1
        return h_mid + self.mlp(y2)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, generator, device, dtype):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(
            config.vocab_size, config.hidden_size,
            std=config.initializer_range, generator=generator, device=device,
            dtype=dtype)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, generator=generator, device=device,
                               dtype=dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps,
                            device=device, dtype=dtype)

    def forward(self, input_ids, attn_mask=None, caches=None):
        hidden = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            if caches is not None:
                hidden = layer(hidden, attn_mask=attn_mask, cache=caches[i])
            elif self.config.use_recompute:
                hidden = recompute(layer, hidden, attn_mask=attn_mask)
            else:
                hidden = layer(hidden, attn_mask=attn_mask)
        return self.norm(hidden)


class LlamaForCausalLM(nn.Module):
    """Causal LM head over :class:`LlamaModel`.

    ``device=None`` means the GPU (raising when there is none);
    ``generator`` draws the N(0, initializer_range) weights, defaulting to
    ``seed(0)`` on ``device``. ``dtype`` is f32 unless given, as the JAX
    model's parameters are (``LlamaConfig(dtype="float32")``); bf16 is
    asked for by name."""

    def __init__(self, config: LlamaConfig, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device, generator = placed(device, generator)
        self.config = config
        self.model = LlamaModel(config, generator=generator, device=device,
                                dtype=dtype)
        self.lm_head = (None if config.tie_word_embeddings else Linear(
            config.hidden_size, config.vocab_size,
            std=config.initializer_range, generator=generator, device=device,
            dtype=dtype))

    @property
    def device(self) -> torch.device:
        return self.model.embed_tokens.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.embed_tokens.weight.dtype

    def forward(self, input_ids, attn_mask=None, caches=None, labels=None):
        """(B, S) token ids -> (B, S, vocab) logits. With ``caches`` (one
        :class:`PagedKVCache` per layer) the new tokens' KV is written
        into the caches, which advance in place. With ``labels`` (B, S),
        aligned with the ids, it returns the shifted next-token loss
        through the blockwise lm-head + CE, which never forms the logits."""
        if labels is not None and caches is not None:
            raise ValueError("labels= is a training-path argument; decode "
                             "caches don't apply")
        hidden = self.model(input_ids, attn_mask=attn_mask, caches=caches)
        if labels is not None:
            if self.lm_head is None:
                return causal_lm_loss(hidden, self.model.embed_tokens.weight,
                                      labels, transpose_y=True)
            return causal_lm_loss(hidden, self.lm_head.weight, labels,
                                  transpose_y=False)
        if self.lm_head is None:
            return hidden @ self.model.embed_tokens.weight.T
        return self.lm_head(hidden)


def causal_lm_loss(hidden, w, labels, transpose_y):
    """Shifted next-token CE from hidden states and the lm-head weight
    ((V, H) with ``transpose_y``, else (H, V)) through the blockwise fused
    kernel (no (B, S, V) logits): the JAX function's replicated-weight
    branch."""
    loss = fused_linear_cross_entropy(hidden[:, :-1, :], w, labels[:, 1:],
                                      transpose_y=transpose_y)
    return loss.mean()


class LlamaPretrainingCriterion(nn.Module):
    """Shifted next-token cross-entropy: position t predicts label t + 1,
    averaged over every position (ignored labels count as 0)."""

    def __init__(self, config: LlamaConfig | None = None):
        super().__init__()

    def forward(self, logits, labels):
        loss = softmax_with_cross_entropy(logits[:, :-1, :], labels[:, 1:])
        return loss.mean()

    @staticmethod
    def fused(hidden, lm_weight, labels, transpose_y=True):
        """The same loss from hidden states and the lm-head weight,
        through :func:`causal_lm_loss` (no (B, S, V) logits)."""
        return causal_lm_loss(hidden, lm_weight, labels, transpose_y)
