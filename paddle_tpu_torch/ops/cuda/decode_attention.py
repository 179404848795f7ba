"""Paged decode attention: the hand-written kernel
(``csrc/decode_attention.cu``), its plain PyTorch version, the wrapper
that picks between them by device, and ``masked_decode_attention`` over a
contiguous cache viewed as pages.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``. Layouts:
q (B, H, D) one token per sequence; pools (num_pages, page_size, KVH, D);
block tables (B, cols) int32; lengths (B,) int32.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_plain",
           "masked_decode_attention"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
NEG_INF = -1e30
MAX_HEAD_DIM = 256  # the kernel's lanes hold up to 8 columns each
MAX_GROUP = 8  # query heads per kv head the kernel holds


def paged_attention_plain(q, k_pages, v_pages, block_tables, lengths,
                          pages_per_seq=None):
    """Single-token attention over the paged pool: the walk covers the
    first ``pages_per_seq`` table columns, positions at or past a row's
    length are masked, a row with no visible key gives 0. Softmax in f32.
    Table cells are clamped into the pool before the gather (masked cells
    may hold anything)."""
    b, h, d = q.shape
    n_pages, page, kvh, _ = k_pages.shape
    tables = block_tables[:, :pages_per_seq]
    cols = tables.shape[1]
    ids = tables.long().clamp(0, n_pages - 1)
    group = h // kvh
    kk = k_pages[ids].reshape(b, cols * page, kvh, d).float()
    vv = v_pages[ids].reshape(b, cols * page, kvh, d).float()
    kk = kk.repeat_interleave(group, dim=2)
    vv = vv.repeat_interleave(group, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float() * (1.0 / math.sqrt(d)), kk)
    valid = (torch.arange(cols * page, device=q.device)[None, :]
             < lengths.long()[:, None])[:, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * valid
    out = torch.einsum("bht,bthd->bhd", p, vv)
    return (out / p.sum(-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, lengths,
                    pages_per_seq=None):
    """See :func:`paged_attention_plain`. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (q and pools both bf16 or
    both f32, int32 tables and lengths, all contiguous; any D up to 256,
    read at its own width; at most 8 query heads per kv head) or raises.
    An f32 launch counts as ``paged_attention[f32]``."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     lengths, pages_per_seq)
    name = "paged_attention"
    _build.expect(name, "q", q, _build.FLOATS, 3)
    _build.expect(name, "k_pages", k_pages, q.dtype, 4)
    _build.expect(name, "v_pages", v_pages, q.dtype, 4)
    _build.expect(name, "block_tables", block_tables, torch.int32, 2)
    _build.expect(name, "lengths", lengths, torch.int32, 1)
    b, h, d = q.shape
    n_pages, page, kvh, _ = k_pages.shape
    cols = block_tables.shape[1]
    if (v_pages.shape != k_pages.shape or k_pages.shape[3] != d
            or d > MAX_HEAD_DIM or h % kvh or h // kvh > MAX_GROUP
            or block_tables.shape[0] != b or lengths.shape[0] != b):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
            f"tables {tuple(block_tables.shape)}, lengths "
            f"{tuple(lengths.shape)}; head_dim must be at most "
            f"{MAX_HEAD_DIM}, with at most {MAX_GROUP} query heads per kv "
            f"head")
    walk = cols if pages_per_seq is None else min(pages_per_seq, cols)
    out = torch.empty_like(q)
    fn = _build.function("ptt_paged_attention"
                         + ("_f32" if q.dtype == torch.float32 else ""),
                         [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _F, _P])
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), b, h, kvh, d, page, n_pages, cols,
                    walk * page, 1.0 / math.sqrt(d), _build.stream_of(q)),
                 name)
    _build.count(name, q.dtype)
    return out


def masked_decode_attention(q, k_cache, v_cache, lengths, page_size=None):
    """Decode attention over a contiguous per-sequence cache
    (B, MAX_LEN, KVH, D): the cache viewed, without a copy, as pages of
    the largest size <= 128 that divides MAX_LEN, with row i's table
    holding sequence i's pages."""
    b, max_len, kvh, d = k_cache.shape
    if page_size is None:
        page_size = min(max_len, 128)
        while max_len % page_size:
            page_size -= 1
    if max_len % page_size:
        raise ValueError(f"max_len {max_len} not divisible by page size "
                         f"{page_size}")
    per_seq = max_len // page_size
    k_pages = k_cache.reshape(b * per_seq, page_size, kvh, d)
    v_pages = v_cache.reshape(b * per_seq, page_size, kvh, d)
    tables = (torch.arange(b, dtype=torch.int32, device=q.device)[:, None]
              * per_seq + torch.arange(per_seq, dtype=torch.int32,
                                       device=q.device)[None, :])
    return paged_attention(q, k_pages, v_pages, tables, lengths)
