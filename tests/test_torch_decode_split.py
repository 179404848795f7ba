"""The paged decode kernel's token split and fixed-order merge, emulated
on the CPU and held against the JAX package's Pallas ``paged_attention``.

``csrc/decode_attention.cu`` cuts each row's first ``max_tokens``
positions into the splits of ``split_plan`` (the port's own function,
called here as the wrapper calls it) and its query heads into chunks; a
block attends one split of one chunk in tiles of 32 key rows with an
online softmax in f32. A split that starts at or past its row's length
leaves at once; a row of one non-empty split writes its output directly;
otherwise the non-empty splits' (m, l, acc) are merged in split order, 8
at a time with an online rescaling.
A row of length 0 gives exactly 0. Here that walk runs in f32 torch on
inputs from numpy with a seed and is held against JAX's Pallas kernel in
interpret mode (jitted once a case), at ``chip_smoke.py``'s f32 gate,
|got - want| <= 1e-4 + 1e-4 |want|.

Lengths: 0, 1, each split boundary of both plans below +-1, the walk's
cap and one past it (clamped). Tables hold scattered pages with
dump-page tails. Two SM counts give two plans: the H100's 132 SMs
(splits of one tile) and 4 SMs (splits of two or three tiles).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu_torch.ops.cuda import decode_attention as da

RTOL, ATOL = 1e-4, 1e-4
PAGE, COLS = 64, 6  # the walk's cap: 384 tokens, 12 tiles
MERGE_LOADS = 8  # splits the merging block folds in at a time
# 0, 1, every multiple of the tile +-1 (each split boundary of both plans),
# the cap and a length past it
LENGTHS = [0, 1] + [32 * k + o for k in range(1, 12) for o in (-1, 0, 1)] + [
    384, 450]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The emulation's loops of small torch ops on one intra-op thread,
    which keeps them fast where pytest-xdist's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(group, kvh, d, seed):
    rng = np.random.RandomState(seed)
    b, h = len(LENGTHS), group * kvh
    n_pages = b * COLS + 1
    dump = n_pages - 1
    tables = np.full((b, COLS + 1), dump, np.int32)  # dump-page tails
    perm, used = rng.permutation(b * COLS), 0
    for i, n in enumerate(LENGTHS):
        k = min(-(-n // PAGE), COLS)
        tables[i, :k] = perm[used:used + k]
        used += k
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return (f(b, h, d), f(n_pages, PAGE, kvh, d), f(n_pages, PAGE, kvh, d),
            tables, np.asarray(LENGTHS, np.int32))


def emulate(q, kp, vp, tables, lengths, sm_count):
    """The kernel's walk: split, tile, online softmax, fixed-order merge.
    Returns (out, number of empty splits skipped, largest split count
    merged)."""
    b, h, d = q.shape
    n_pages, page, kvh, _ = kp.shape
    max_tokens = COLS * page
    group = h // kvh
    chunks, per, ts, nsplit = da.split_plan(b, kvh, group, max_tokens,
                                            sm_count)
    qs = q * (1.0 / math.sqrt(d))
    out = torch.empty_like(q)
    empty = merged = 0
    for bi in range(b):
        ln = max(min(int(lengths[bi]), max_tokens), 0)
        nne = -(-ln // ts)
        for kh in range(kvh):
            for c in range(chunks):
                h0 = kh * group + c * per
                hs = slice(h0, kh * group + min((c + 1) * per, group))
                if ln == 0:
                    out[bi, hs] = 0.0
                    continue
                parts = []
                for s in range(nsplit):
                    t0 = s * ts
                    if t0 >= ln:
                        empty += 1
                        continue
                    t_end = min(ln, t0 + ts)
                    cnt = hs.stop - hs.start
                    m = torch.full((cnt,), -1e30)
                    l = torch.zeros(cnt)
                    acc = torch.zeros(cnt, d)
                    for tt in range(t0, t_end, da.TILE):
                        toks = torch.arange(tt, min(t_end, tt + da.TILE))
                        pages = tables[bi, toks // page].long().clamp(
                            0, n_pages - 1)
                        k = kp[pages, toks % page, kh]
                        v = vp[pages, toks % page, kh]
                        sc = qs[bi, hs] @ k.T
                        mn = torch.maximum(m, sc.amax(1))
                        al = torch.exp(m - mn)
                        p = torch.exp(sc - mn[:, None])
                        l = l * al + p.sum(1)
                        acc = acc * al[:, None] + p @ v
                        m = mn
                    parts.append((m, l, acc))
                assert len(parts) == nne
                merged = max(merged, nne)
                if nne == 1:
                    m, l, acc = parts[0]
                    out[bi, hs] = acc / l.clamp_min(1e-30)[:, None]
                    continue
                # MERGE_LOADS splits at a time, folded in with an online
                # rescaling, each in split order
                mx = torch.full((cnt,), -1e30)
                big_l = torch.zeros(cnt)
                val = torch.zeros(cnt, d)
                for s0 in range(0, nne, MERGE_LOADS):
                    chunk = parts[s0:s0 + MERGE_LOADS]
                    mn = torch.maximum(mx, torch.stack(
                        [p_[0] for p_ in chunk]).amax(0))
                    al = torch.exp(mx - mn)
                    big_l, val = big_l * al, val * al[:, None]
                    for m_, l_, acc_ in chunk:
                        e = torch.exp(m_ - mn)
                        big_l = big_l + l_ * e
                        val = val + acc_ * e[:, None]
                    mx = mn
                out[bi, hs] = val / big_l.clamp_min(1e-30)[:, None]
    return out, empty, merged


@functools.lru_cache(maxsize=None)
def _jax_paged():
    return jax.jit(functools.partial(jax_da.paged_attention,
                                     pages_per_seq=COLS))


@pytest.mark.parametrize("group,kvh,d", [(1, 2, 96), (1, 2, 128),
                                         (4, 2, 96), (4, 2, 128),
                                         (12, 1, 96), (12, 1, 128),
                                         (20, 1, 128)])
def test_split_and_merge_match_pallas(group, kvh, d):
    """Both plans against JAX; a group of 20 takes two chunks of 10."""
    args = _inputs(group, kvh, d, seed=group * 1000 + d)
    want = np.asarray(_jax_paged()(*(jnp.asarray(a) for a in args)))
    t = [torch.from_numpy(a) for a in args]
    for sm_count in (132, 4):
        b = t[0].shape[0]
        chunks, _, ts, nsplit = da.split_plan(b, kvh, group, COLS * PAGE,
                                              sm_count)
        assert chunks == -(-group // da.MAX_CHUNK) and nsplit > 1
        assert (ts == da.TILE) == (sm_count == 132)
        got, empty, merged = emulate(*t, sm_count)
        assert empty > 0 and merged > 1  # both kinds of split were taken
        if sm_count == 132:  # a merge of more splits than one load round
            assert merged > MERGE_LOADS
        err = np.abs(got.numpy() - want)
        assert (err <= ATOL + RTOL * np.abs(want)).all(), err.max()
        assert torch.all(got[0] == 0)  # the row of length 0


def test_split_plan_depends_on_shapes_alone():
    """The plan of the serving paths' calls: e2's pool (8 rows, 12 kv
    heads, 4 columns of 128) in splits of one tile, Mistral-Large-2's group
    of 12 in one chunk, multi-query attention's 32 heads in two, and a
    long walk capped at MAX_SPLITS splits."""
    assert da.split_plan(8, 12, 1, 512, 132) == (1, 1, 32, 16)
    assert da.split_plan(8, 8, 12, 512, 132) == (1, 12, 32, 16)
    assert da.split_plan(8, 1, 32, 512, 132) == (2, 16, 32, 16)
    chunks, per, ts, nsplit = da.split_plan(1, 8, 4, 32768, 132)
    assert (chunks, per, nsplit) == (1, 4, da.MAX_SPLITS)
    assert ts * nsplit >= 32768 and ts % da.TILE == 0
    # at most MAX_CHUNK heads a chunk, no chunk empty, every token covered
    for b, kvh, group, mt in ((3, 2, 17, 100), (2, 1, 96, 0),
                              (256, 8, 1, 4096), (1, 1, 257, 33)):
        chunks, per, ts, nsplit = da.split_plan(b, kvh, group, mt, 132)
        assert per <= da.MAX_CHUNK and (chunks - 1) * per < group
        assert chunks * per >= group and 1 <= nsplit <= da.MAX_SPLITS
        assert ts * nsplit >= mt and ts % da.TILE == 0
