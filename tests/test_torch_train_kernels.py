"""The port's backward kernels against the JAX package's Pallas backward.

On the CPU each wrapper in ``paddle_tpu_torch/ops/cuda`` runs its plain
PyTorch version (the CUDA kernels run only on the card; ``chip_smoke.py``
holds them against these plain versions there). The JAX side is
``jax.vjp`` through the Pallas custom_vjp functions, which run their
backward kernels in interpret mode, as the JAX package's own tests run
them. Inputs and output cotangents come from numpy with a seed, all f32.
Tolerance 2e-5 absolute and relative: f32 sums reassociated over at most
384 rows (the results agree to ~1e-6). Each ``torch.autograd.Function``'s
CPU backward is also held to finite differences by
``torch.autograd.gradcheck`` in f64, where the plain versions compute in
f64.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import fused_ce as jax_ce
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu.ops.pallas import fused_ops as jax_fo
from paddle_tpu.ops.pallas import rms_norm as jax_rn
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.ops import fused_ce, nn_kernels
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import fused_ops as fo
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


TOL = dict(atol=2e-5, rtol=2e-5)


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_rms_norm_bwd_matches_pallas():
    rng = np.random.RandomState(0)
    x, w, b = _np(rng, 256, 256), 1.0 + 0.1 * _np(rng, 256), _np(rng, 256)
    g = _np(rng, 256, 256)
    _, vjp = jax.vjp(lambda x_, w_, b_: jax_rn.rms_norm(x_, w_, b_, 1e-6,
                                                        True),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want_dx, want_dw, want_db = vjp(jnp.asarray(g))
    _, r = rn.rms_norm_rows(_t(x), _t(w), epsilon=1e-6)
    dx, dw, db = rn.rms_norm_bwd(_t(x), _t(w), r, _t(g))
    _close(dx, want_dx)
    _close(dw, want_dw)
    _close(db, want_db)
    # through the model-facing op's Function (no bias: dx and dw)
    xt, wt = _t(x, True), _t(w, True)
    nn_kernels.rms_norm(xt.reshape(4, 64, 256), wt, epsilon=1e-6).backward(
        _t(g).reshape(4, 64, 256))
    _close(xt.grad, want_dx)
    _close(wt.grad, want_dw)


def test_rope_adjoint_matches_pallas():
    rng = np.random.RandomState(1)
    b, s, h, d = 2, 128, 4, 64
    q, k = _np(rng, b, s, h, d), _np(rng, b, s, h, d)
    gq, gk = _np(rng, b, s, h, d), _np(rng, b, s, h, d)
    cos, sin = _rope_tables(d, 256, 10000.0, "cpu")
    _, vjp = jax.vjp(lambda q_, k_: jax_fo.fused_rope(
        q_, k_, jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())),
        jnp.asarray(q), jnp.asarray(k))
    want_q, want_k = vjp((jnp.asarray(gq), jnp.asarray(gk)))
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    dq, dk = fo.fused_rope_at(_t(gq), _t(gk), cos, sin, pos, inverse=True)
    _close(dq, want_q)
    _close(dk, want_k)
    qt, kt = _t(q, True), _t(k, True)
    oq, ok = nn_kernels.rotary_position_embedding(qt, kt, cos, sin)
    torch.autograd.backward([oq, ok], [_t(gq), _t(gk)])
    _close(qt.grad, want_q)
    _close(kt.grad, want_k)


@pytest.mark.parametrize("b,s,h,kvh,causal", [
    (2, 384, 4, 2, True),   # GQA, three 128-blocks: block skipping + group sum
    (1, 256, 4, 4, False),  # MHA, no mask
])
def test_flash_attention_bwd_matches_pallas(b, s, h, kvh, causal):
    rng = np.random.RandomState(2)
    d = 64
    q, k, v = _np(rng, b, s, h, d), _np(rng, b, s, kvh, d), _np(rng, b, s,
                                                                kvh, d)
    g = _np(rng, b, s, h, d)
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_fa.flash_attention(
        q_, k_, v_, is_causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    out, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), causal)
    got = fa.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(g), causal)
    for a, w in zip(got, want):
        _close(a, w)
    ts = [_t(a, True) for a in (q, k, v)]
    nn_kernels.scaled_dot_product_attention(*ts, is_causal=causal).backward(
        _t(g))
    for a, w in zip(ts, want):
        _close(a.grad, w)


@pytest.mark.parametrize("transpose_y", [True, False])
def test_fused_linear_cross_entropy_matches_jax(transpose_y):
    rng = np.random.RandomState(3)
    n, hdim, v = 24, 16, 211  # block 128: two blocks, the last one short
    x = _np(rng, 2, n // 2, hdim)
    w = _np(rng, v, hdim) if transpose_y else _np(rng, hdim, v)
    lab = rng.randint(0, v, (2, n // 2))
    lab[1, -3:] = -100
    gl = _np(rng, 2, n // 2)

    def jf(x_, w_):
        return jax_ce.fused_linear_cross_entropy(
            x_, w_, jnp.asarray(lab), transpose_y=transpose_y,
            block_size=128)

    want, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(gl))
    xt, wt = _t(x, True), _t(w, True)
    got = fused_ce.fused_linear_cross_entropy(
        xt, wt, torch.from_numpy(lab), transpose_y=transpose_y,
        block_size=128)
    _close(got, want)
    got.backward(_t(gl))
    _close(xt.grad, want_dx)
    _close(wt.grad, want_dw)


def test_softmax_with_cross_entropy_matches_jax():
    from paddle_tpu.ops import nn_kernels as jax_nn

    rng = np.random.RandomState(4)
    logits, lab = _np(rng, 2, 5, 7), rng.randint(0, 7, (2, 5, 1))
    lab[0, 2, 0] = -100
    want = jax_nn.softmax_with_cross_entropy(jnp.asarray(logits),
                                             jnp.asarray(lab))
    got = nn_kernels.softmax_with_cross_entropy(_t(logits),
                                                torch.from_numpy(lab))
    _close(got, want)


def _f64(rng, *shape):
    return torch.from_numpy(rng.randn(*shape)).requires_grad_(True)


@pytest.mark.parametrize("case", ["rms_norm", "rope", "flash_causal",
                                  "flash_offset", "fused_ce"])
def test_functions_gradcheck_in_f64(case):
    rng = np.random.RandomState(5)
    if case == "rms_norm":
        fn = lambda x, w: rn.RMSNormFunction.apply(  # noqa: E731
            x, w, None, 1e-6)
        args = (_f64(rng, 4, 8), _f64(rng, 8))
    elif case == "rope":
        cos, sin = (t.double() for t in _rope_tables(4, 8, 10000.0, "cpu"))
        pos = torch.tensor([[0, 3, 7], [1, 2, 9]], dtype=torch.int32)
        fn = lambda q, k: fo.RopeFunction.apply(  # noqa: E731
            q, k, cos, sin, pos)
        args = (_f64(rng, 2, 3, 2, 4), _f64(rng, 2, 3, 1, 4))
    elif case.startswith("flash"):
        sq = 5 if case == "flash_causal" else 3  # 3 queries on 5 keys
        fn = lambda q, k, v: fa.FlashAttentionFunction.apply(  # noqa: E731
            q, k, v, True)
        args = (_f64(rng, 1, sq, 2, 4), _f64(rng, 1, 5, 1, 4),
                _f64(rng, 1, 5, 1, 4))
    else:
        lab = torch.tensor([0, 6, 3, -100, 5, 1])
        fn = lambda x, w: fused_ce.fused_linear_cross_entropy(  # noqa: E731
            x, w, lab, transpose_y=False, block_size=3)
        args = (_f64(rng, 6, 4), _f64(rng, 4, 7))
    assert torch.autograd.gradcheck(fn, args)


def _graph(t):
    """Names of the autograd nodes behind ``t``."""
    names, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None:
            names.add(type(node).__name__)
            todo.extend(n for n, _ in node.next_functions)
    return names


def test_ops_record_functions_only_under_autograd():
    """Under no_grad the ops call the forward wrappers alone (the serving
    path's launches are unchanged); with autograd they record the
    Functions."""
    rng = np.random.RandomState(6)
    x, w = _t(_np(rng, 3, 64), True), _t(1.0 + _np(rng, 64), True)
    q = _t(_np(rng, 1, 4, 2, 64), True)
    cos, sin = _rope_tables(64, 8, 10000.0, "cpu")
    ops = {
        "RMSNormFunctionBackward": lambda: nn_kernels.rms_norm(x, w),
        "FlashAttentionFunctionBackward":
            lambda: nn_kernels.scaled_dot_product_attention(
                q, q, q, is_causal=True),
        "RopeFunctionBackward":
            lambda: nn_kernels.rotary_position_embedding(q, q, cos, sin)[0],
    }
    for name, op in ops.items():
        with torch.no_grad():
            assert op().grad_fn is None
        out = op()
        assert name in _graph(out), _graph(out)
        assert math.isfinite(float(out.sum()))
