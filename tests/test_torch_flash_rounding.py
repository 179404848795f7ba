"""The rounding points of the flash kernels' tensor-core design, emulated
on the CPU and held against the JAX package's Pallas flash attention.

``csrc/flash_attention.cu`` computes every product with bf16 operands and
f32 sums. P enters ``P V`` as two bf16 terms, its bf16 rounding and the
bf16 rounding of what that left over (the row sum l adds P in f32).
``csrc/flash_attention_bwd.cu`` does the same with P and dS before
``dV += P^T dO`` and ``dK += dS^T Q``, and with dS before ``dQ += dS K``.
The Pallas kernels keep P and dS in f32. Here the kernels' tile loops (64
query rows by 64 keys, online rescaling, causal tiles skipped past the
limit, the dK/dV loop over the GQA group and the causal range of query
tiles, the dQ loop over the causal range of key tiles) run in f32 torch
with those roundings, on bf16-valued inputs from numpy with a seed, and
are held against JAX's ``_fwd`` and the backward rule of ``_flash_bhsd``
(``_bwd``, what ``jax.vjp`` through it runs) in interpret mode, the
latter with the emulated forward's out and lse as its residuals, as the
plain version on the card takes the kernel's. A single bf16 rounding of
P and dS, as FA2 does, misses the gate here: early causal rows average
few keys, and outputs, dK and dQ entries that cancel to near zero keep
its 2^-9 relative error per term.

Tolerance: ``chip_smoke.py``'s kernel gate, |got - want| <= 1e-3 + 2^-7
|want| with both sides rounded to bf16 (as the kernel's output and the
plain version's are on the card), and lse within 1e-3 absolute.

The f32 forward (``csrc/flash_attention_f32.cu``) takes both of its
products, Q K^T and P V, on the tensor cores in 3xTF32: each f32 operand
is split into hi, its TF32 rounding (to nearest, ties away, as cvt.rna),
and lo, the rest, which the tensor core truncates to TF32; a b is hi hi +
hi lo + lo hi. Its tile loop
(64 query rows by 64 keys up to D = 64, 32 past it) is emulated the same
way on f32 inputs and held against JAX's ``_fwd`` in f32 at
``chip_smoke.py``'s f32 gate, |got - want| <= 1e-4 + 1e-4 |want| (out and
lse); one TF32 product (1xTF32) misses it.

The f32 backward (``csrc/flash_attention_bwd_f32.cu``, dK/dV, and
``csrc/flash_attention_bwd_dq_f32.cu``) takes all five of
its products in 3xTF32 the same way. Its tile loops (dK/dV: BK key rows of
one kv head over the group's query heads and the causal range of 64-row
query tiles, BK = 64, or 32 where 64-row tiles would leave the H100's
132 SMs idle, as at both cases here; dQ: 64 query rows over the causal
range of key tiles, 64 keys up to D = 64, 32 up to 128, 16 past it) are
emulated on f32 inputs from JAX's f32 forward residuals and held against
JAX's ``_bwd`` in f32 at the f32 gate (dQ, dK and dV); one TF32 product
misses it.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_fa

RTOL, ATOL = 2.0 ** -7, 1e-3
BQ = BK = 64  # the kernels' query and key tiles
NEG_INF = -1e30

CASES = {  # b, s, heads, kv heads, d, causal
    "causal_d128": (1, 256, 2, 2, 128, True),
    "gqa_d64": (2, 128, 4, 2, 64, False),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's torch work on one intra-op thread: the emulations' loops
    of small ops give the same bits on one thread as on several (checked
    at 1, 3 and 8), and run several times faster where pytest-xdist's
    workers share the cores, as each worker's thread pool otherwise
    spin-waits against the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    """``x`` rounded to bf16, kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _operand(p, split):
    """P (or dS) as the kernels feed it to a product: its bf16 rounding,
    plus the bf16 rounding of the rest when ``split``."""
    hi = _bf16(p)
    return hi + _bf16(p - hi) if split else hi


def _inputs(b, s, h, kvh, d):
    rng = np.random.RandomState(5)
    q, do = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, s, kvh, d).astype(np.float32) for _ in range(2))
    return tuple(_bf16(torch.from_numpy(a)) for a in (q, k, v, do))


def emulate_fwd(q, k, v, causal, split=True):
    """The forward kernel's tile loop: (out bf16 (B, Sq, H, D), lse f32
    (B, H, Sq))."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    scale, off = 1.0 / math.sqrt(d), sk - sq
    out = torch.zeros_like(q)
    lse = torch.zeros(b, h, sq)
    for bi in range(b):
        for hi in range(h):
            kh = hi // group
            for q0 in range(0, sq, BQ):
                rows = torch.arange(q0, min(q0 + BQ, sq))
                qt = q[bi, rows, hi]
                k_end = (max(min(sk, int(rows[-1]) + 1 + off), 0) if causal
                         else sk)
                m = torch.full((len(rows),), NEG_INF)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), d)
                for k0 in range(0, k_end, BK):
                    cols = torch.arange(k0, min(k0 + BK, sk))
                    s = (qt @ k[bi, cols, kh].T) * scale
                    if causal:
                        s = torch.where(cols[None] <= rows[:, None] + off, s,
                                        NEG_INF)
                    m_new = torch.maximum(m, s.max(1).values)
                    alpha = torch.exp(m - m_new)
                    base = torch.where(m_new == NEG_INF, 0.0, m_new)
                    p = torch.exp(s - base[:, None])
                    l = l * alpha + p.sum(1)
                    acc = (acc * alpha[:, None]
                           + _operand(p, split) @ v[bi, cols, kh])
                    m = m_new
                out[bi, rows, hi] = acc / l.clamp(min=1e-30)[:, None]
                lse[bi, hi, rows] = m + torch.log(l.clamp(min=1e-30))
    return _bf16(out), lse


def emulate_dkdv(q, k, v, do, lse, delta, causal, split=True):
    """The dK/dV kernel's loop: one key tile of one (b, kv head) at a time,
    over its group's query heads and the causal range of query tiles."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale, off = 1.0 / math.sqrt(d), sk - sq
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for kh in range(kvh):
            for k0 in range(0, sk, BK):
                cols = torch.arange(k0, min(k0 + BK, sk))
                dk_t = torch.zeros(len(cols), d)
                dv_t = torch.zeros(len(cols), d)
                q_first = max(k0 - off, 0) // BQ * BQ if causal else 0
                for hi in range(kh * group, (kh + 1) * group):
                    for q0 in range(q_first, sq, BQ):
                        rows = torch.arange(q0, min(q0 + BQ, sq))
                        qt, dot = q[bi, rows, hi], do[bi, rows, hi]
                        s = qt @ k[bi, cols, kh].T
                        p = torch.exp(s * scale - lse[bi, hi, rows][:, None])
                        if causal:
                            p = torch.where(
                                cols[None] <= rows[:, None] + off, p, 0.0)
                        dp = dot @ v[bi, cols, kh].T
                        ds = p * (dp - delta[bi, hi, rows][:, None]) * scale
                        dv_t += _operand(p, split).T @ dot
                        dk_t += _operand(ds, split).T @ qt
                dk[bi, cols, kh] = dk_t
                dv[bi, cols, kh] = dv_t
    return _bf16(dk), _bf16(dv)


def emulate_dq(q, k, v, do, lse, delta, causal, split=True):
    """The dQ kernel's loop: one query tile of one (b, h) at a time, over
    the causal range of key tiles of its kv head; dS fed to ``dQ += dS K``
    as one bf16 rounding or, with ``split``, as two bf16 parts."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    scale, off = 1.0 / math.sqrt(d), sk - sq
    dq = torch.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            kh = hi // group
            for q0 in range(0, sq, BQ):
                rows = torch.arange(q0, min(q0 + BQ, sq))
                qt, dot = q[bi, rows, hi], do[bi, rows, hi]
                k_end = (max(min(sk, int(rows[-1]) + 1 + off), 0) if causal
                         else sk)
                acc = torch.zeros(len(rows), d)
                for k0 in range(0, k_end, BK):
                    cols = torch.arange(k0, min(k0 + BK, sk))
                    kt = k[bi, cols, kh]
                    p = torch.exp((qt @ kt.T) * scale
                                  - lse[bi, hi, rows][:, None])
                    if causal:
                        p = torch.where(cols[None] <= rows[:, None] + off,
                                        p, 0.0)
                    dp = dot @ v[bi, cols, kh].T
                    ds = p * (dp - delta[bi, hi, rows][:, None]) * scale
                    acc += _operand(ds, split) @ kt
                dq[bi, rows, hi] = acc
    return _bf16(dq)


def _bhsd(t):
    return jnp.swapaxes(jnp.asarray(t.numpy()), 1, 2)


def _gate_misses(got, want):
    """Elements of ``got`` beyond the kernel gate around ``want``."""
    want = _bf16(want)
    return int(((got - want).abs() > ATOL + RTOL * want.abs()).sum())


def _back(a):
    return torch.from_numpy(np.swapaxes(np.asarray(a), 1, 2).copy())


@functools.lru_cache(maxsize=None)
def _reference_fwd(case):
    """JAX's out and lse for ``case`` (the Pallas forward, interpreted)."""
    b, s, h, kvh, d, causal = CASES[case]
    q, k, v, _ = (_bhsd(t) for t in _inputs(b, s, h, kvh, d))
    out, lse = jax_fa._fwd(q, k, v, causal, 1.0 / math.sqrt(d))
    return _back(out), torch.from_numpy(np.asarray(lse)[..., 0].copy())


def _reference_bwd(case, out, lse):
    """JAX's dQ, dK and dV for ``case``: the backward rule of
    ``_flash_bhsd`` (the Pallas backward kernels, interpreted) with ``out``
    and ``lse`` as its residuals, as the plain version on the card takes
    the forward kernel's."""
    b, s, h, kvh, d, causal = CASES[case]
    q, k, v, do = (_bhsd(t) for t in _inputs(b, s, h, kvh, d))
    res = (q, k, v, None, None, _bhsd(out), jnp.asarray(lse.numpy())[..., None])
    dq, dk, dv, _, _ = jax_fa._bwd(causal, 1.0 / math.sqrt(d), res, do)
    return _back(dq), _back(dk), _back(dv)


def _emulate(case, split):
    """out, lse, dK, dV and dQ through the kernels' loops with P and dS
    split (or rounded once)."""
    b, s, h, kvh, d, causal = CASES[case]
    q, k, v, do = _inputs(b, s, h, kvh, d)
    out, lse = emulate_fwd(q, k, v, causal, split)
    delta = (do * out).sum(-1).transpose(1, 2)
    return ((out, lse) + emulate_dkdv(q, k, v, do, lse, delta, causal, split)
            + (emulate_dq(q, k, v, do, lse, delta, causal, split),))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_rounding_fits_the_kernel_gate(case):
    got_o, got_lse, _, _, _ = _emulate(case, split=True)
    want_o, want_lse = _reference_fwd(case)
    assert _gate_misses(got_o, want_o) == 0
    torch.testing.assert_close(got_lse, want_lse, rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dkdv_rounding_fits_the_kernel_gate(case):
    out, lse, got_dk, got_dv, _ = _emulate(case, split=True)
    _, want_dk, want_dv = _reference_bwd(case, out, lse)
    assert _gate_misses(got_dk, want_dk) == 0
    assert _gate_misses(got_dv, want_dv) == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_dq_rounding_fits_the_kernel_gate(case):
    out, lse, _, _, got_dq = _emulate(case, split=True)
    want_dq, _, _ = _reference_bwd(case, out, lse)
    assert _gate_misses(got_dq, want_dq) == 0


def test_one_bf16_rounding_of_ds_misses_the_gate_for_dq():
    """dQ = dS K with dS rounded once to bf16, as FA2 feeds it, misses the
    gate at both cases (47 and 3 elements): the dQ kernel splits dS."""
    for case in sorted(CASES):
        out, lse, _, _, got_dq = _emulate(case, split=False)
        want_dq, _, _ = _reference_bwd(case, out, lse)
        assert _gate_misses(got_dq, want_dq) > 0


def test_one_bf16_rounding_of_p_and_ds_misses_the_gate():
    out, lse, got_dk, got_dv, _ = _emulate("causal_d128", split=False)
    assert _gate_misses(out, _reference_fwd("causal_d128")[0]) > 0
    _, want_dk, want_dv = _reference_bwd("causal_d128", out, lse)
    assert _gate_misses(got_dk, want_dk) > 0
    assert _gate_misses(got_dv, want_dv) > 0


F32_RTOL = F32_ATOL = 1e-4  # chip_smoke.py's f32 gate


def _tf32(x, nearest=True):
    """``x`` rounded to TF32 (10 mantissa bits), kept in f32: to nearest
    with ties away from zero, as ``cvt.rna.tf32.f32``, or toward zero, as
    the tensor core reads an f32 register as TF32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if nearest else 0)) & -0x2000).view(
        torch.float32)


def _mm(a, b, mode):
    """``a @ b`` as the f32 kernel multiplies: ``"3x"`` in 3xTF32 (hi
    rounded to nearest, lo the rest, truncated), ``"1x"`` as one TF32
    product."""
    ah, bh = _tf32(a), _tf32(b)
    if mode == "1x":
        return ah @ bh
    al, bl = _tf32(a - ah, False), _tf32(b - bh, False)
    return al @ bh + ah @ bl + ah @ bh


def emulate_fwd_f32(q, k, v, causal, mode):
    """The f32 forward kernel's tile loop with its products in ``mode``:
    (out f32 (B, Sq, H, D), lse f32 (B, H, Sq))."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    scale, off = 1.0 / math.sqrt(d), sk - sq
    bk = 64 if d <= 64 else 32
    out = torch.zeros_like(q)
    lse = torch.zeros(b, h, sq)
    for bi in range(b):
        for hi in range(h):
            kh = hi // group
            for q0 in range(0, sq, BQ):
                rows = torch.arange(q0, min(q0 + BQ, sq))
                qt = q[bi, rows, hi]
                k_end = (max(min(sk, int(rows[-1]) + 1 + off), 0) if causal
                         else sk)
                m = torch.full((len(rows),), NEG_INF)
                l = torch.zeros(len(rows))
                acc = torch.zeros(len(rows), d)
                for k0 in range(0, k_end, bk):
                    cols = torch.arange(k0, min(k0 + bk, sk))
                    s = _mm(qt, k[bi, cols, kh].T, mode) * scale
                    if causal:
                        s = torch.where(cols[None] <= rows[:, None] + off, s,
                                        NEG_INF)
                    m_new = torch.maximum(m, s.max(1).values)
                    alpha = torch.exp(m - m_new)
                    base = torch.where(m_new == NEG_INF, 0.0, m_new)
                    p = torch.exp(s - base[:, None])
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + _mm(p, v[bi, cols, kh], mode)
                    m = m_new
                out[bi, rows, hi] = acc / l.clamp(min=1e-30)[:, None]
                lse[bi, hi, rows] = m + torch.log(l.clamp(min=1e-30))
    return out, lse


def _f32_inputs(b, s, h, kvh, d):
    rng = np.random.RandomState(6)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k, v = (rng.randn(b, s, kvh, d).astype(np.float32) for _ in range(2))
    return tuple(torch.from_numpy(a) for a in (q, k, v))


@functools.lru_cache(maxsize=None)
def _reference_fwd_f32(case):
    """JAX's f32 out and lse for ``case`` (the Pallas forward,
    interpreted)."""
    b, s, h, kvh, d, causal = CASES[case]
    q, k, v = (_bhsd(t) for t in _f32_inputs(b, s, h, kvh, d))
    out, lse = jax_fa._fwd(q, k, v, causal, 1.0 / math.sqrt(d))
    return _back(out), torch.from_numpy(np.asarray(lse)[..., 0].copy())


def _f32_misses(got, want):
    """Elements of ``got`` beyond the f32 gate around ``want``."""
    return int(((got - want).abs() > F32_ATOL + F32_RTOL * want.abs()).sum())


def _emulate_f32(case, mode):
    b, s, h, kvh, d, causal = CASES[case]
    q, k, v = _f32_inputs(b, s, h, kvh, d)
    return emulate_fwd_f32(q, k, v, causal, mode)


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_forward_3xtf32_fits_the_f32_gate(case):
    got_o, got_lse = _emulate_f32(case, "3x")
    want_o, want_lse = _reference_fwd_f32(case)
    assert got_o.dtype == want_o.dtype == torch.float32
    assert _f32_misses(got_o, want_o) == 0
    assert _f32_misses(got_lse, want_lse) == 0


def test_f32_forward_1xtf32_misses_the_f32_gate():
    """One TF32 product (11 bits) for Q K^T and P V, as ``allow_tf32``
    would give a matmul, misses the f32 gate: the kernel takes three."""
    for case in sorted(CASES):
        got_o, _ = _emulate_f32(case, "1x")
        assert _f32_misses(got_o, _reference_fwd_f32(case)[0]) > 0


SMS = 132  # the H100's SMs: the dK/dV kernel's choice of key tile
BQ_F32 = 64  # the f32 backward's query tile (dK/dV) and query rows (dQ)


def _f32_dout(b, s, h, d):
    rng = np.random.RandomState(7)
    return torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))


def emulate_dkdv_f32(q, k, v, do, lse, delta, causal, mode):
    """The f32 dK/dV kernel's loop with its products in ``mode``: one key
    tile of one (b, kv head), over its group's query heads and the causal
    range of query tiles; S^T = K Q^T and dP^T = V dO^T, then
    dV += P^T dO and dK += dS^T Q."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    scale, off = 1.0 / math.sqrt(d), sk - sq
    bk = 64 if d <= 128 and -(-sk // 64) * kvh * b >= SMS else 32
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for bi in range(b):
        for kh in range(kvh):
            for k0 in range(0, sk, bk):
                cols = torch.arange(k0, min(k0 + bk, sk))
                kt, vt = k[bi, cols, kh], v[bi, cols, kh]
                dk_t, dv_t = torch.zeros(len(cols), d), torch.zeros(len(cols), d)
                q_first = (max(k0 - off, 0) // BQ_F32 * BQ_F32 if causal
                           else 0)
                for hi in range(kh * group, (kh + 1) * group):
                    for q0 in range(q_first, sq, BQ_F32):
                        rows = torch.arange(q0, min(q0 + BQ_F32, sq))
                        qt, dot = q[bi, rows, hi], do[bi, rows, hi]
                        pt = torch.exp(_mm(kt, qt.T, mode) * scale
                                       - lse[bi, hi, rows][None])
                        if causal:
                            pt = torch.where(
                                cols[:, None] <= rows[None] + off, pt, 0.0)
                        dst = pt * (_mm(vt, dot.T, mode)
                                    - delta[bi, hi, rows][None]) * scale
                        dv_t += _mm(pt, dot, mode)
                        dk_t += _mm(dst, qt, mode)
                dk[bi, cols, kh] = dk_t
                dv[bi, cols, kh] = dv_t
    return dk, dv


def emulate_dq_f32(q, k, v, do, lse, delta, causal, mode):
    """The f32 dQ kernel's loop with its products in ``mode``: 64 query
    rows of one (b, h) over the causal range of key tiles; S = Q K^T and
    dP = dO V^T, then dQ += dS K."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    scale, off = 1.0 / math.sqrt(d), sk - sq
    bk = 64 if d <= 64 else 32 if d <= 128 else 16
    dq = torch.zeros_like(q)
    for bi in range(b):
        for hi in range(h):
            kh = hi // group
            for q0 in range(0, sq, BQ_F32):
                rows = torch.arange(q0, min(q0 + BQ_F32, sq))
                qt, dot = q[bi, rows, hi], do[bi, rows, hi]
                k_end = (max(min(sk, int(rows[-1]) + 1 + off), 0) if causal
                         else sk)
                acc = torch.zeros(len(rows), d)
                for k0 in range(0, k_end, bk):
                    cols = torch.arange(k0, min(k0 + bk, sk))
                    kt = k[bi, cols, kh]
                    p = torch.exp(_mm(qt, kt.T, mode) * scale
                                  - lse[bi, hi, rows][:, None])
                    if causal:
                        p = torch.where(cols[None] <= rows[:, None] + off,
                                        p, 0.0)
                    ds = p * (_mm(dot, v[bi, cols, kh].T, mode)
                              - delta[bi, hi, rows][:, None]) * scale
                    acc += _mm(ds, kt, mode)
                dq[bi, rows, hi] = acc
    return dq


@functools.lru_cache(maxsize=None)
def _reference_bwd_f32(case):
    """JAX's f32 dQ, dK and dV for ``case``: ``_bwd`` (the Pallas backward
    kernels, interpreted) with ``_reference_fwd_f32``'s out and lse as its
    residuals."""
    b, s, h, kvh, d, causal = CASES[case]
    q, k, v = (_bhsd(t) for t in _f32_inputs(b, s, h, kvh, d))
    out, lse = _reference_fwd_f32(case)
    res = (q, k, v, None, None, _bhsd(out),
           jnp.asarray(lse.numpy())[..., None])
    dq, dk, dv, _, _ = jax_fa._bwd(causal, 1.0 / math.sqrt(d), res,
                                   _bhsd(_f32_dout(b, s, h, d)))
    return _back(dq), _back(dk), _back(dv)


def _emulate_bwd_f32(case, mode):
    """dQ, dK and dV through the f32 backward kernels' loops from JAX's
    f32 forward residuals."""
    b, s, h, kvh, d, causal = CASES[case]
    q, k, v = _f32_inputs(b, s, h, kvh, d)
    do = _f32_dout(b, s, h, d)
    out, lse = _reference_fwd_f32(case)
    delta = (do * out).sum(-1).transpose(1, 2)
    dk, dv = emulate_dkdv_f32(q, k, v, do, lse, delta, causal, mode)
    return emulate_dq_f32(q, k, v, do, lse, delta, causal, mode), dk, dv


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_backward_3xtf32_fits_the_f32_gate(case):
    got = _emulate_bwd_f32(case, "3x")
    for g, w in zip(got, _reference_bwd_f32(case)):
        assert g.dtype == w.dtype == torch.float32
        assert _f32_misses(g, w) == 0


def test_f32_backward_1xtf32_misses_the_f32_gate():
    """One TF32 product for each of the backward's five products misses
    the f32 gate in dQ, dK and dV at both cases: the kernels take three."""
    for case in sorted(CASES):
        got = _emulate_bwd_f32(case, "1x")
        for g, w in zip(got, _reference_bwd_f32(case)):
            assert _f32_misses(g, w) > 0
