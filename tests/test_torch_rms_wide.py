"""RMSNorm at rows wider than a warp holds, and the f32 backward's partial
plan, on the CPU.

The port's plain versions (``rms_norm_plain``, ``rms_norm_bwd_plain``, what
a wrapper runs on a CPU tensor) against the JAX package's Pallas forward
and backward (``_fwd``, ``_bwd_call``, in interpret mode as its own tests
run them, jitted once a case) at Mistral-Large-2's hidden 12288 and at a
width off every vector multiple, 8200, in f32 from numpy with a seed.

Then the plan of ``csrc/rms_norm.cu``'s f32 vector backward, emulated in
f32 torch: a row spread over ``split`` warps (the fewest, a power of 2
up to 8, that hold it at 6 16-byte vectors a lane; 16 a lane past 8
warps), 8 / split groups of warps a block of 256 threads, ``parts`` =
min(blocks that fit the card, groups of rows, the scratch's rows) blocks,
group k of block b walking rows b * groups + k, then every parts * groups
rows on; each lane's column sums in its group's row order, the block's
partial the groups' sums in group order, and dw, db the partials summed
as ``rms_norm_bwd_sum_kernel`` sums them (16 row groups, partials k, k +
16, ..., then the groups in order); mean(g w x) each lane's sum over its
vectors, then over the warp's lanes, then the group's warps in order.
Held against ``rms_norm_bwd_plain`` at two block counts and three widths.

Tolerance |got - want| <= 1e-5 + 1e-5 |want|: f32 sums in other orders
(~1e-6 relative at these sizes).
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import rms_norm as jrn
from paddle_tpu_torch.ops.cuda import rms_norm as rn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This module's torch work, its module fixtures' included, on one
    intra-op thread: where pytest-xdist's workers share the cores, each
    worker's thread pool otherwise spin-waits against the others', and
    small ops run several times slower. The tolerances hold on any number
    of threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ATOL = RTOL = 1e-5
THREADS = 256  # the backward's block
REG_VECS, MAX_VECS = 6, 16  # vectors a lane: sums in registers; at most
SUM_GROUPS = 16  # row groups of rms_norm_bwd_sum_kernel


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               atol=ATOL, rtol=RTOL)


def _inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    b = (0.1 * rng.randn(d)).astype(np.float32)
    g = rng.randn(n, d).astype(np.float32)
    return x, w, b, g


@jax.jit
def _jax_fwd_bwd(x, w, b, g):
    y, r = jrn._fwd(x, w, b, 1e-6)
    return (y, r) + tuple(jrn._bwd_call(x, w, r, g))


@pytest.mark.parametrize("n,d", [(8, 12288), (3, 8200)])
def test_wide_rows_match_pallas(n, d):
    """y and r of the forward with weight and bias, then dx, dw and db
    given JAX's r, against JAX's Pallas kernels."""
    x, w, b, g = _inputs(n, d, d)
    want_y, want_r, want_dx, want_dw, want_db = _jax_fwd_bwd(x, w, b, g)
    y, r = rn.rms_norm_rows(*map(torch.from_numpy, (x, w, b)), epsilon=1e-6)
    _close(y, want_y)
    _close(r, want_r)
    dx, dw, db = rn.rms_norm_bwd(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(np.array(want_r)),
                                 torch.from_numpy(g))
    _close(dx, want_dx)
    _close(dw, want_dw)
    _close(db, want_db)


def _plan(n, d, blocks, cap):
    """(split, vectors a lane, parts): the kernel's split of a row over
    warps and the blocks it launches."""
    nvec = d // 4
    split = 1
    while split < THREADS // 32 and nvec > REG_VECS * 32 * split:
        split *= 2
    vecs = -(-nvec // (32 * split))
    assert vecs <= MAX_VECS
    groups = THREADS // 32 // split
    return split, vecs, max(1, min(blocks, -(-n // groups), cap))


def _emulate_bwd(x, w, r, g, blocks, cap):
    """dx, dw, db as the f32 vector backward computes them at ``blocks``
    blocks that fit the card and ``cap`` rows of scratch."""
    n, d = x.shape
    split, vecs, parts = _plan(n, d, blocks, cap)
    groups, span = THREADS // 32 // split, 32 * split
    # column c of vector v = i * span + warp_in_group * 32 + lane
    cols = torch.arange(vecs * span * 4).view(vecs, split, 32, 4)
    live = cols < d
    cols = cols.clamp(max=d - 1)
    dx = torch.empty_like(x)
    partial = torch.zeros(parts, 2, d)
    for blk in range(parts):
        sums = torch.zeros(groups, 2, d)  # each group's lanes' sums
        for k in range(groups):
            for row in range(blk * groups + k, n, parts * groups):
                gwx = torch.where(live, g[row, cols] * w[cols] * x[row, cols],
                                  torch.zeros(()))
                lane = torch.zeros(split, 32)
                for i in range(vecs):  # each lane's vectors in order
                    for e in range(4):
                        lane = lane + gwx[i, :, :, e]
                inner = torch.zeros(())
                for warp_sum in lane.sum(-1):  # the group's warps in order
                    inner = inner + warp_sum
                c2 = r[row, 0] * r[row, 0] * (inner / d)
                dx[row] = r[row, 0] * (g[row] * w - x[row] * c2)
                sums[k, 0] += g[row] * x[row] * r[row, 0]
                sums[k, 1] += g[row]
        for k in range(groups):  # the block's partial, in group order
            partial[blk] += sums[k]
    acc = torch.zeros(SUM_GROUPS, 2, d)
    for q in range(SUM_GROUPS):
        for p in range(q, parts, SUM_GROUPS):
            acc[q] += partial[p]
    total = torch.zeros(2, d)
    for q in range(SUM_GROUPS):
        total += acc[q]
    return dx, total[0], total[1]


@pytest.mark.parametrize("n,d,blocks", [
    (203, 1536, 5),    # 2 warps a row, ten rows a group
    (203, 1536, 16),   # the same rows over more blocks
    (61, 3072, 7),     # 4 warps a row
    (9, 16384, 3),     # a block a row, 16 vectors a lane
])
def test_f32_bwd_partial_plan_matches_plain(n, d, blocks):
    """The emulated plan covers each row once and sums dw and db in its
    fixed order within the f32 gate of the plain backward; the scratch is
    the wrapper's (at least a strip of STRIP_ROWS rows a partial)."""
    x, w, _, g = (torch.from_numpy(a) for a in _inputs(n, d, n + d))
    _, r = rn.rms_norm_plain(x, w, epsilon=1e-6)
    cap = max(-(-n // rn.STRIP_ROWS), min(n, rn.F32_PARTS_PER_SM * blocks))
    got = _emulate_bwd(x, w, r, g, blocks, cap)
    for a, want in zip(got, rn.rms_norm_bwd_plain(x, w, r, g)):
        _close(a, want)
