"""Paged decode attention: the hand-written kernel
(``csrc/decode_attention.cu``), its plain PyTorch version, the wrapper
that picks between them by device, and ``masked_decode_attention`` over a
contiguous cache viewed as pages.

Counterpart of ``paddle_tpu/ops/pallas/decode_attention.py``. Layouts:
q (B, H, D) one token per sequence; pools (num_pages, page_size, KVH, D);
block tables (B, cols) int32; lengths (B,) int32.

The kernel splits each sequence's tokens across blocks by
:func:`split_plan`, a function of the shapes and the card's SM count
alone, and merges a row's splits in split order in the block that
finishes last, so its bits do not depend on which block that is. Its
split partials and per-item counters are kept across calls, one set per
(device, stream): run a call once on a stream before capturing it in a
CUDA graph.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["paged_attention", "paged_attention_plain",
           "masked_decode_attention", "split_plan"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
NEG_INF = -1e30
# the CUDA kernel's limits and split rule (csrc/decode_attention.cu)
MAX_HEAD_DIM = 256  # a block stages q and its K/V rows up to this width
TILE = 32  # key rows a block stages at a time; splits are whole tiles
MAX_CHUNK = 16  # query heads of one kv head a block takes
MAX_SPLITS = 64
BLOCKS_PER_SM = 32  # blocks a full-length call aims at, per SM


def split_plan(b, kv_heads, group, max_tokens, sm_count):
    """How the kernel cuts a call, from the shapes alone (never the
    lengths, so a captured graph stays valid as they grow): the group in
    ``chunks`` chunks of at most ``per`` <= MAX_CHUNK query heads, a block
    each, and each row's first ``max_tokens`` positions in ``nsplit``
    splits of ``ts`` tokens (a multiple of TILE), enough that B x kv heads
    x chunks x splits blocks reach BLOCKS_PER_SM a SM at full length, at
    most MAX_SPLITS and no split shorter than a tile. Returns ``(chunks,
    per, ts, nsplit)``."""
    per = -(-group // -(-group // MAX_CHUNK))
    chunks = -(-group // per)
    tiles = max(1, -(-max_tokens // TILE))
    items = b * kv_heads * chunks
    nsplit = max(1, min(-(-BLOCKS_PER_SM * sm_count // items), tiles,
                        MAX_SPLITS))
    ts = TILE * -(-tiles // nsplit)
    return chunks, per, ts, -(-tiles * TILE // ts)


# (device, stream) -> [partials, counters, retired buffers]
_scratch: dict = {}


def _scratch_for(q, n_part, n_count):
    """The split partials (``n_part`` floats) and ticket counters
    (``n_count`` ints, zeroed once: the kernel leaves them at rest) of
    q's device and current stream, grown when a call needs more; a grown
    set keeps the old buffers alive for graphs captured on them."""
    key = (q.device.index, _build.stream_of(q))
    slot = _scratch.get(key)
    if slot is None or slot[0].numel() < n_part or slot[1].numel() < n_count:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged_attention: no split scratch of this size on the "
                "capturing stream; run the call once on it before capture")
        retired = (slot[2] + [slot[0], slot[1]]) if slot else []
        slot = _scratch[key] = [
            torch.empty(max(n_part, slot[0].numel() if slot else 0),
                        dtype=torch.float32, device=q.device),
            torch.zeros(max(n_count, slot[1].numel() if slot else 0),
                        dtype=torch.int32, device=q.device), retired]
    return slot[0], slot[1]


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
    read at its own width; any number of query heads per kv head, a group
    past 16 cut into chunks of at most 16, a block each; the tokens split
    by :func:`split_plan`) or raises. An f32 launch counts as
    ``paged_attention[f32]``."""
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
            or d > MAX_HEAD_DIM or h % kvh
            or block_tables.shape[0] != b or lengths.shape[0] != b):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
            f"tables {tuple(block_tables.shape)}, lengths "
            f"{tuple(lengths.shape)}; head_dim must be at most "
            f"{MAX_HEAD_DIM}, and the query heads a multiple of the kv "
            f"heads")
    walk = cols if pages_per_seq is None else min(pages_per_seq, cols)
    max_tokens = walk * page
    chunks, per, ts, nsplit = split_plan(b, kvh, h // kvh, max_tokens,
                                         _build.sm_count(q.device))
    # a split's record: acc (per, d rounded up to 4), m (per), l (per),
    # rounded up to 4 floats
    rec = per * (-(-d // 4) * 4) + -(-2 * per // 4) * 4
    part = count = None
    if nsplit > 1:
        items = b * kvh * chunks
        part, count = _scratch_for(q, items * nsplit * rec, items)
    out = torch.empty_like(q)
    fn = _build.function("ptt_paged_attention"
                         + ("_f32" if q.dtype == torch.float32 else ""),
                         [_P] * 8 + [_I] * 13 + [_F, _P])
    _build.check(fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_tables.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), None if part is None else part.data_ptr(),
                    None if count is None else count.data_ptr(), b, h, kvh,
                    d, page, n_pages, cols, max_tokens, chunks, per, ts,
                    nsplit, rec, 1.0 / math.sqrt(d), _build.stream_of(q)),
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
