"""Segment masking in the port (``seq_lens``, ``segment_ids``) against the
JAX package, and the port's one definition of a query row that sees no
key.

The JAX side is its Pallas flash attention in interpret mode (the
``masked=True`` kernels, ``paddle_tpu/ops/pallas/flash_attention.py``),
its ``build_segments``, its ``scaled_dot_product_attention`` composition
and its ``nn.functional`` / ``functional_extra`` entries; the port's side
runs its plain versions, as every wrapper does on a CPU tensor. Inputs
come from numpy with a seed, in f32, at S = 128 or 256 (JAX's Pallas
kernel takes multiples of 128). Tolerance 1e-5 against a Pallas kernel
(online softmax and blocked sums in another order); ids exactly.

JAX leaves a row with no visible key "finite garbage" whose value depends
on its tiles: such rows are compared only where JAX's value is defined
(the composition route), and the gradients are taken with ``dout`` zero on
them, JAX's own precondition. The port gives them out = 0, lse = -1e30
and no gradient, in its plain versions as in its kernels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn import functional as jax_F
from paddle_tpu.nn import functional_extra as jax_Fx
from paddle_tpu.ops import nn_kernels as jax_nn
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu_torch import nn
from paddle_tpu_torch.ops import nn_kernels
from paddle_tpu_torch.ops.cuda import flash_attention as fa


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


KERNEL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _jax_flash_lowered_once():
    """One ``jax.jit`` around JAX's flash custom_vjp, so that its Pallas
    kernels (interpret mode) lower once per shape rather than at every
    eager call. The function computed is the JAX package's own."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fa, "_flash_bhsd",
               jax.jit(jax_fa._flash_bhsd, static_argnums=(5, 6)))
    yield
    mp.undo()


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol=KERNEL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _packed(rng, b, s, lo, hi):
    """(b, s) int32 ids of packed documents of lo..hi-1 tokens."""
    ids = np.empty((b, s), np.int32)
    for i in range(b):
        pos, doc = 0, 0
        while pos < s:
            n = rng.randint(lo, hi)
            ids[i, pos:pos + n] = doc
            pos, doc = pos + n, doc + 1
    return ids


SEGMENTS = {  # name -> (b, sq, sk, kwargs of build_segments) from an rng
    "seq_lens": lambda r: (2, 128, 128, dict(seq_lens=np.array([37, 128]))),
    "shared_ids": lambda r: (2, 128, 128, dict(
        segment_ids=_packed(r, 2, 128, 5, 60))),
    "pair": lambda r: (2, 128, 256, dict(segment_ids=(
        np.sort(r.randint(0, 4, (2, 128)), 1).astype(np.int32),
        np.sort(r.randint(0, 4, (2, 256)), 1).astype(np.int32)))),
    "both": lambda r: (2, 128, 128, dict(
        seq_lens=np.array([100, 64]),
        segment_ids=_packed(r, 2, 128, 5, 60))),
    "pair_and_seq_lens": lambda r: (2, 128, 256, dict(
        seq_lens=np.array([90, 128]), segment_ids=(
            np.sort(r.randint(0, 4, (2, 128)), 1).astype(np.int32),
            np.sort(r.randint(0, 4, (2, 256)), 1).astype(np.int32)))),
}


@pytest.mark.parametrize("case", sorted(SEGMENTS) + ["shared_needs_sq_eq_sk"])
def test_build_segments_matches_jax(case):
    """The (B, S) int32 ids equal JAX's exactly; padding is -1; a shared
    array with sq != sk raises ValueError on both sides."""
    if case == "shared_needs_sq_eq_sk":
        ids = np.zeros((1, 128), np.int32)
        with pytest.raises(ValueError, match="sq == sk"):
            jax_fa.build_segments(1, 128, 256, segment_ids=ids)
        with pytest.raises(ValueError, match="sq == sk"):
            fa.build_segments(1, 128, 256, segment_ids=_t(ids))
        return
    b, sq, sk, kw = SEGMENTS[case](np.random.RandomState(20))
    want = jax_fa.build_segments(b, sq, sk, **kw)
    got = fa.build_segments(b, sq, sk, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert fa.build_segments(b, sq, sk) == (None, None)


FLASH_CASES = {  # name -> (segments case, causal, kv heads of 4)
    "seq_lens_causal_mha": ("seq_lens", True, 4),
    "seq_lens_gqa": ("seq_lens", False, 2),
    "packed_causal_gqa": ("shared_ids", True, 1),
    "packed_mha": ("shared_ids", False, 4),
    "both_causal_gqa": ("both", True, 2),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_segments_match_jax(case):
    """The public ``flash_attention`` with ``seq_lens`` and/or packed
    ``segment_ids`` (every row sees at least itself, padding its row's
    padding): out against JAX's Pallas flash (interpret mode) and dq, dk,
    dv through ``FlashAttentionFunction`` against ``jax.vjp``."""
    seg_case, causal, kvh = FLASH_CASES[case]
    rng = np.random.RandomState(21)
    b, s, _, kw = SEGMENTS[seg_case](rng)
    q, g = _np(rng, b, s, 4, 32), _np(rng, b, s, 4, 32)
    k, v = _np(rng, b, s, kvh, 32), _np(rng, b, s, kvh, 32)
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_fa.flash_attention(
        q_, k_, v_, causal, **kw), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    ts = [_t(a, True) for a in (q, k, v)]
    got = fa.flash_attention(*ts, causal, **kw)
    _close(got, want)
    got.backward(_t(g))
    for t, w in zip(ts, vjp(jnp.asarray(g))):
        _close(t.grad, w)


def test_flash_attention_pair_matches_jax_on_rows_with_a_key():
    """Cross attention with a ``(q_ids, k_ids)`` pair in which query
    segment 3 is missing from the keys: JAX on the rows that see a key,
    the port's 0 on the rest; gradients with ``dout`` zero on the rows
    with no key."""
    rng = np.random.RandomState(22)
    q_ids = np.sort(rng.randint(0, 5, (2, 128)), 1).astype(np.int32)
    k_ids = np.sort(rng.randint(0, 5, (2, 256)), 1).astype(np.int32)
    k_ids[k_ids == 3] = 4
    ids = (q_ids, k_ids)
    q = _np(rng, 2, 128, 4, 32)
    k, v = _np(rng, 2, 256, 2, 32), _np(rng, 2, 256, 2, 32)
    seen = (q_ids != 3)[:, :, None, None]
    g = _np(rng, 2, 128, 4, 32) * seen
    want, vjp = jax.vjp(lambda q_, k_, v_: jax_fa.flash_attention(
        q_, k_, v_, segment_ids=ids), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    ts = [_t(a, True) for a in (q, k, v)]
    got = fa.flash_attention(*ts, segment_ids=(_t(q_ids), _t(k_ids)))
    assert (~seen).any() and bool((got.detach()[~seen[..., 0, 0]] == 0)
                                  .all())
    _close(got * _t(seen), np.asarray(want) * seen)
    got.backward(_t(g))
    for t, w in zip(ts, vjp(jnp.asarray(g))):
        _close(t.grad, w)


SDPA_SEG_CALLS = {  # name -> kwargs of the composition route
    "bool_mask_seq_lens": lambda m, ids: dict(attn_mask=m,
                                              seq_lens=np.array([50, 128])),
    "additive_mask_segment_ids": lambda m, ids: dict(
        attn_mask=np.where(m, 0.0, -1e9).astype(np.float32),
        segment_ids=ids),
    "causal_mask_pair_missing_segment": lambda m, ids: dict(
        attn_mask=m, is_causal=True, segment_ids=(
            ids, np.where(ids == 1, 2, ids).astype(np.int32))),
}


@pytest.mark.parametrize("case", sorted(SDPA_SEG_CALLS))
def test_sdpa_composition_segments_match_jax(case):
    """With an ``attn_mask`` both sides compose: the causal -inf and the
    mask, then -1e30 where the segments differ, then softmax. The port
    equals JAX on every row, rows with no visible key (a uniform softmax
    over their -1e30 entries) included."""
    rng = np.random.RandomState(23)
    q = _np(rng, 2, 128, 4, 32)
    k, v = _np(rng, 2, 128, 2, 32), _np(rng, 2, 128, 2, 32)
    mask = rng.rand(2, 4, 128, 128) < 0.8
    mask[..., 0] = True
    ids = _packed(rng, 2, 128, 10, 70)
    kw = SDPA_SEG_CALLS[case](mask, ids)

    def conv(a, f):
        if isinstance(a, tuple):
            return tuple(f(x) for x in a)
        return f(a) if isinstance(a, np.ndarray) else a

    want = jax_nn.scaled_dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        **{n: conv(a, jnp.asarray) for n, a in kw.items()})
    got = nn_kernels.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), **{n: conv(a, _t) for n, a in kw.items()})
    assert torch.isfinite(got).all()
    _close(got, want)


VARLEN = {  # name -> (bounds, causal): JAX's own cases
    "aligned": ([0, 96, 224, 256], False),
    "aligned_causal": ([0, 96, 224, 256], True),
    "unaligned": ([0, 40, 100], False),
    "unaligned_causal": ([0, 40, 100], True),
}


@pytest.mark.parametrize("case", sorted(VARLEN))
def test_flash_attn_varlen_qkvpacked_matches_jax(case):
    """JAX's ``tests/test_nn_functional_extra.py`` cases (totals 256 and
    100, causal and not): the port runs both as one segment-masked call,
    JAX the aligned one fused and the unaligned one as its per-segment
    loop; the function is the same."""
    bounds, causal = VARLEN[case]
    total = bounds[-1]
    qkv = _np(np.random.RandomState(24), total, 3, 2, 32)
    cu = np.asarray(bounds, np.int32)
    n = max(np.diff(bounds))
    want, none = jax_Fx.flash_attn_varlen_qkvpacked(
        paddle.to_tensor(qkv), paddle.to_tensor(cu), paddle.to_tensor(cu),
        n, n, causal=causal)
    got, port_none = nn.functional.flash_attn_varlen_qkvpacked(
        _t(qkv), _t(cu), _t(cu), n, n, causal=causal)
    assert none is None and port_none is None
    _close(got, np.asarray(want._value))


def test_flash_attn_varlen_scale_and_packed_entries_match_jax():
    """A custom ``scale`` folds into q on both sides; ``flash_attn_qkvpacked``
    and ``nn.functional.flash_attention`` return ``(out, None)`` as JAX's
    do, and under autograd the varlen gradient reaches qkv."""
    rng = np.random.RandomState(25)
    qkv = _np(rng, 128, 3, 2, 32)
    cu = np.asarray([0, 50, 128], np.int32)
    want, _ = jax_Fx.flash_attn_varlen_qkvpacked(
        paddle.to_tensor(qkv), paddle.to_tensor(cu), paddle.to_tensor(cu),
        78, 78, scale=1.0)
    x = _t(qkv, True)
    got, _ = nn.functional.flash_attn_varlen_qkvpacked(
        x, _t(cu), _t(cu), 78, 78, scale=1.0)
    _close(got, np.asarray(want._value))
    got.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()

    packed = _np(rng, 2, 128, 3, 2, 32)
    want, none = jax_Fx.flash_attn_qkvpacked(paddle.to_tensor(packed),
                                             causal=True)
    got, port_none = nn.functional.flash_attn_qkvpacked(_t(packed),
                                                        causal=True)
    assert none is None and port_none is None
    _close(got, np.asarray(want._value))
    q, k, v = (packed[:, :, i] for i in range(3))
    want, none = jax_F.flash_attention(*(paddle.to_tensor(a)
                                         for a in (q, k, v)))
    got, port_none = nn.functional.flash_attention(*(_t(a) for a in (q, k, v)))
    assert none is None and port_none is None
    _close(got, np.asarray(want._value))


NO_KEY = {  # name -> (sq, sk, causal, q_ids, k_ids): rows that see no key
    "causal_sq_gt_sk": (7, 4, True, None, None),
    "pair_missing_segment": (6, 5, False, [[0, 0, 1, 2, 2, 3]],
                             [[0, 0, 2, 3, 3]]),
}


@pytest.mark.parametrize("case", sorted(NO_KEY))
def test_rows_without_a_key_are_zero(case):
    """Part of the port's contract, where JAX has none: a row with no
    visible key gets out = 0 and lse = -1e30 from the plain forward, its
    dQ is 0, and its dO reaches no dK or dV."""
    sq, sk, causal, q_ids, k_ids = NO_KEY[case]
    rng = np.random.RandomState(26)
    q, g = _np(rng, 1, sq, 2, 16), _np(rng, 1, sq, 2, 16)
    k, v = _np(rng, 1, sk, 1, 16), _np(rng, 1, sk, 1, 16)
    segs = ((torch.tensor(q_ids, dtype=torch.int32),
             torch.tensor(k_ids, dtype=torch.int32)) if q_ids else (None,
                                                                   None))
    none = (np.arange(sq) < sq - sk if causal
            else ~np.isin(q_ids[0], k_ids[0]))
    assert none.any()
    out, lse = fa.flash_attention_fwd_plain(_t(q), _t(k), _t(v), causal,
                                            *segs)
    assert bool((out[0, none] == 0).all())
    assert bool((lse[0, :, none] == fa.NEG_INF).all())
    assert torch.isfinite(out).all()

    def grads(dout):
        ts = [_t(a, True) for a in (q, k, v)]
        fa.FlashAttentionFunction.apply(*ts, causal, *segs).backward(
            _t(dout))
        return [t.grad for t in ts]

    dq, dk, dv = grads(g)
    assert bool((dq[0, none] == 0).all())
    g2 = g.copy()
    g2[0, none] += 1.0  # a change on rows with no key moves nothing
    for a, b in zip((dq, dk, dv), grads(g2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("ids", ["random", "packed"])
def test_segment_ranges_skip_only_pairs_without_equal_ids(ids):
    """The host table (min, max per 32 positions) is exact, and a tile
    pair the kernels skip (64- or 32-row tiles whose id ranges do not
    meet) holds no equal pair of ids; packed ids leave pairs to skip."""
    rng = np.random.RandomState(27)
    a = (rng.randint(-1, 6, (2, 300)) if ids == "random"
         else _packed(rng, 2, 300, 3, 90)).astype(np.int32)
    b = (rng.randint(-1, 6, (2, 200)) if ids == "random"
         else _packed(rng, 2, 200, 3, 90)).astype(np.int32)
    for x in (a, b):
        lo, hi = fa.segment_ranges(_t(x))
        n = -(-x.shape[1] // fa.CHUNK)
        for c in range(n):
            part = x[:, c * fa.CHUNK:(c + 1) * fa.CHUNK]
            np.testing.assert_array_equal(lo[:, c].numpy(), part.min(1))
            np.testing.assert_array_equal(hi[:, c].numpy(), part.max(1))
    (alo, ahi), (blo, bhi) = fa.segment_ranges(_t(a)), fa.segment_ranges(_t(b))
    skipped = 0
    for tq, tk in ((64, 64), (64, 32)):
        for r in range(2):
            for i in range(0, 300, tq):
                qa = a[r, i:i + tq]
                qlo = alo[r, i // 32:-(-(i + tq) // 32)].min()
                qhi = ahi[r, i // 32:-(-(i + tq) // 32)].max()
                for j in range(0, 200, tk):
                    kb = b[r, j:j + tk]
                    klo = blo[r, j // 32:-(-(j + tk) // 32)].min()
                    khi = bhi[r, j // 32:-(-(j + tk) // 32)].max()
                    if klo > qhi or khi < qlo:
                        skipped += 1
                        assert not np.isin(qa, kb).any()
    assert skipped > 0 or ids == "random"  # random ids fill each range
