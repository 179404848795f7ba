"""Text generation: sampling rule, paged-cache views and an eager
prefill-then-decode loop.

Counterpart of ``paddle_tpu/models/generation.py`` (``_sample_rows`` :50,
``_make_paged_cache`` :72-88, ``generate`` :298 with ``cache="paged"`` and
``use_jit=False``). Sampling draws each row from its own seed, so a row's
tokens never depend on what it was batched with; the seeds come from a
counter-based hash of (seed, stream id, token index). The draws are
PyTorch's, not JAX's threefry: a sampled stream is reproducible within
the port and device, not bit-identical to the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["generate", "stream_seed"]

# splitmix64 constants (as the JAX engine's per-request key streams)
_SM64_A = np.uint64(0x9E3779B97F4A7C15)
_SM64_B = np.uint64(0xBF58476D1CE4E5B9)
_SM64_C = np.uint64(0x94D049BB133111EB)


def _mix64(x):
    x = (x ^ (x >> np.uint64(30))) * _SM64_B
    x = (x ^ (x >> np.uint64(27))) * _SM64_C
    return x ^ (x >> np.uint64(31))


def stream_seed(seed, stream, index) -> int:
    """Seed of token ``index`` of stream ``stream`` (a request id, or a row
    of a ``generate`` batch): a pure function of its arguments."""
    # shape-(1,) operands: numpy wraps array uint64 overflow silently (the
    # intended mod-2^64 arithmetic) but warns on scalars
    root = _mix64(np.asarray([seed], np.uint64) * _SM64_A
                  + np.asarray([stream], np.uint64) * _SM64_B + np.uint64(1))
    h = _mix64(root + np.asarray([index], np.uint64) * _SM64_A)
    return int(h[0]) & 0x7FFFFFFFFFFFFFFF


def _sample_rows(logits, seeds, temperature, top_k, top_p, greedy):
    """Next token of each row of ``logits`` (N, V). Greedy is argmax (the
    first index on ties, as ``jnp.argmax``); otherwise
    :func:`_sample_with_noise` on noise that :func:`_fill_noise` draws for
    row i from ``seeds[i]``."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    noise = torch.empty(logits.shape, dtype=torch.float32,
                        device=logits.device)
    _fill_noise(noise, seeds)
    return _sample_with_noise(logits, noise, temperature, top_k, top_p)


def _fill_noise(noise, seeds):
    """Row i of ``noise`` (N, V) f32: V uniform draws of a generator
    seeded ``seeds[i]`` (None skips the row). The serving engine fills its
    decode segment's noise with this, before a captured segment that
    cannot seed a generator itself."""
    for i, s in enumerate(seeds):
        if s is None:
            continue
        g = torch.Generator(device=noise.device)
        g.manual_seed(s)
        noise[i].uniform_(generator=g)


def _sample_with_noise(logits, noise, temperature, top_k, top_p):
    """Temperature, then top-k, then top-p filtering (masked logits -1e30,
    as the JAX rule), then a Gumbel-max draw from ``noise`` (N, V) uniform
    f32. No host sync, so a CUDA graph can capture it."""
    lg = logits.float() / max(temperature, 1e-5)
    if top_k is not None and top_k > 0:
        kth = torch.sort(lg, dim=-1).values[..., -top_k][..., None]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
    if top_p is not None and 0.0 < top_p < 1.0:
        desc = torch.sort(lg, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
        cut_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(desc, -1, cut_idx)
        lg = torch.where(lg < cutoff, torch.full_like(lg, -1e30), lg)
    gumbel = -torch.log(-torch.log(noise.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(lg + gumbel, dim=-1)


def _make_paged_cache(k_pages, v_pages, tables, page_size, length,
                      attn_pages=None, dump_page=None):
    """A :class:`~.llama.PagedKVCache` view over existing pools."""
    from .llama import PagedKVCache

    c = PagedKVCache.__new__(PagedKVCache)
    c.k_pages, c.v_pages, c.tables = k_pages, v_pages, tables
    c.page_size, c.length, c.attn_pages = page_size, length, attn_pages
    c.dump_page = dump_page
    return c


@torch.no_grad()
def generate(model, input_ids, max_new_tokens=20, do_sample=False,
             temperature=1.0, top_k=None, top_p=None, eos_token_id=None,
             seed=0):
    """Decode ``max_new_tokens`` continuations of ``input_ids`` (B, S)
    through a paged KV cache (pages of 128 tokens): one prefill, then one
    forward per token. With ``eos_token_id``, finished rows repeat it and
    the loop stops once every row has finished. Returns (B, S + new)
    ids on the model's device."""
    from .llama import PagedKVCache

    ids = torch.as_tensor(input_ids, device=model.device).long()
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0, got {max_new_tokens}")
    if max_new_tokens == 0:
        return ids
    b, s = ids.shape
    cfg = model.config
    max_len = s + max_new_tokens
    # the last sampled token is never fed back: the highest embedded
    # position is max_len - 2
    if max_len - 1 > cfg.max_position_embeddings:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) would embed "
            f"position {max_len - 2} beyond max_position_embeddings "
            f"({cfg.max_position_embeddings})")
    page = 128
    padded = -(-max_len // page) * page
    caches = [PagedKVCache(b, padded, cfg.num_key_value_heads, cfg.head_dim,
                           page_size=page, device=model.device,
                           dtype=model.dtype)
              for _ in range(cfg.num_hidden_layers)]

    def sample(logits, t):
        seeds = (None if not do_sample
                 else [stream_seed(seed, r, t) for r in range(b)])
        return _sample_rows(logits, seeds, temperature, top_k, top_p,
                            not do_sample)

    tok = sample(model(ids, caches=caches)[:, -1], 0)
    finished = torch.zeros(b, dtype=torch.bool, device=ids.device)
    if eos_token_id is not None:
        finished |= tok == eos_token_id
    out = [ids, tok[:, None]]
    for t in range(1, max_new_tokens):
        tok = sample(model(tok[:, None], caches=caches)[:, -1], t)
        if eos_token_id is not None:
            finished |= tok == eos_token_id
            tok = torch.where(finished, torch.full_like(tok, eos_token_id),
                              tok)
        out.append(tok[:, None])
        if eos_token_id is not None and bool(finished.all()):
            break
    return torch.cat(out, dim=1)
