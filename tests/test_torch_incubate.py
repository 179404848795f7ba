"""The port's ``incubate`` fused layers and its bias-dropout-residual-
LayerNorm op against the JAX package's.

On the CPU the port's wrapper runs the kernel's plain version
(``bias_dropout_residual_ln_plain``; the CUDA kernel runs only on the
card, where ``chip_smoke.py`` holds it against this plain version). The
JAX side is ``_bdrln_fwd_call`` and the ``_bdrln`` custom_vjp, whose
Pallas kernel runs in interpret mode, as ``tests/test_pallas_fused_ops.py``
runs it, and the JAX ``incubate`` layers, whose attention takes its
Pallas flash kernels at S = 128 (their gate is S % 128 == 0). Both sides
get the same numpy inputs, weights and dropout mask (f32 0/1 for JAX,
bool for the port); all f32.

Tolerances: the op's y, mean and rstd 1e-5 absolute and relative (one
f32 row reduction over at most 100 values, summed in other orders);
its gradients 2e-5 (reductions over 24 rows); the layers' outputs 1e-4
relative + 1e-5 absolute and their gradients 1e-4 relative + 1e-6
absolute (two frameworks, a few f32 matmuls and reductions deep; they
agree to ~1e-6 relative). ``torch.autograd.gradcheck`` holds the
``torch.autograd.Function`` to finite differences in f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import incubate as jax_incubate
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu.ops.pallas import fused_ops as jax_fo
from paddle_tpu_torch import incubate
from paddle_tpu_torch.models import params_from_paddle_tpu
from paddle_tpu_torch.ops.cuda import fused_ops as fo


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


OP_TOL = dict(atol=1e-5, rtol=1e-5)
OP_GRAD_TOL = dict(atol=2e-5, rtol=2e-5)
OUT_TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-3)
ROWS = 24


@pytest.fixture(autouse=True, scope="module")
def _jax_pallas_lowered_once():
    """The JAX eager autograd traces a Pallas call anew each time, and in
    interpret mode lowers it again (~1 s for the flash pair); one
    ``jax.jit`` around the same custom_vjp functions lowers each once per
    shape. The functions computed are the JAX package's own."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fa, "_flash_bhsd",
               jax.jit(jax_fa._flash_bhsd, static_argnums=(5, 6)))
    mp.setattr(jax_fo, "_bdrln",
               jax.jit(jax_fo._bdrln, static_argnums=(6, 7, 8)))
    yield
    mp.undo()


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _op_inputs(h, seed=0):
    """x, res (ROWS, h); bias, scale, lnb (1, h); a keep-0.9 mask."""
    rng = np.random.RandomState(seed)
    x, res = _np(rng, ROWS, h), _np(rng, ROWS, h)
    bias, lnb = _np(rng, 1, h), _np(rng, 1, h)
    scale = 1.0 + 0.1 * _np(rng, 1, h)
    mask = rng.rand(ROWS, h) < 0.9
    return x, res, bias, scale, lnb, mask


@pytest.mark.parametrize("training,h", [(True, 64), (False, 64), (True, 100),
                                        (False, 100)])
def test_bdrln_plain_matches_pallas_kernel(training, h):
    """Rate 0.1 in training (the mask applies) or eval (it does not), at
    H = 64 and at H = 100, which is not a multiple of 8."""
    x, res, bias, scale, lnb, mask = _op_inputs(h)
    want = jax_fo._bdrln_fwd_call(
        *(jnp.asarray(a) for a in (x, res, bias, scale, lnb)),
        jnp.asarray(mask.astype(np.float32)), 0.1, 1e-5, training)
    got = fo.bias_dropout_residual_ln_fwd(
        *(_t(a) for a in (x, res, bias, scale, lnb)), _t(mask), 0.1, 1e-5,
        training)
    assert got[0].shape == (ROWS, h) and got[1].shape == (ROWS,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                   **OP_TOL)


@pytest.mark.parametrize("training", [True, False])
def test_bdrln_backward_matches_pallas_vjp(training):
    """In eval JAX's public function hands ``_bdrln`` a mask of ones (its
    backward multiplies by the mask whatever ``training`` says); the port
    reads no mask in eval."""
    x, res, bias, scale, lnb, mask = _op_inputs(64, seed=1)
    dy = _np(np.random.RandomState(2), ROWS, 64)
    jmask = mask.astype(np.float32) if training else np.ones_like(x)
    _, vjp = jax.vjp(
        lambda *a: jax_fo._bdrln(*a, jnp.asarray(jmask), 0.1, 1e-5,
                                 training),
        *(jnp.asarray(a) for a in (x, res, bias, scale, lnb)))
    want = vjp(jnp.asarray(dy))
    ts = [_t(a, True) for a in (x, res, bias, scale, lnb)]
    y = fo.BiasDropoutResidualLNFunction.apply(*ts, _t(mask), 0.1, 1e-5,
                                               training)
    y.backward(_t(dy))
    for t, w in zip(ts, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   **OP_GRAD_TOL)


@pytest.mark.parametrize("training", [True, False])
def test_bdrln_function_gradcheck_f64(training):
    rng = np.random.RandomState(3)
    x, res = rng.randn(6, 12), rng.randn(6, 12)
    bias, scale, lnb = rng.randn(12), 1 + 0.1 * rng.randn(12), rng.randn(12)
    mask = torch.from_numpy(rng.rand(6, 12) < 0.7)
    ts = [torch.tensor(a, requires_grad=True)
          for a in (x, res, bias, scale, lnb)]
    assert torch.autograd.gradcheck(
        lambda *a: fo.BiasDropoutResidualLNFunction.apply(
            *a, mask, 0.3, 1e-5, training), ts)


def _jax_layer_pair(jax_cls, port_cls, *args, **kw):
    paddle.seed(0)
    jl = jax_cls(*args, **kw)
    tl = port_cls(*args, **kw, device="cpu")
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jl.raw_state()[0].items()}, tl)
    return jl, tl


def _randomize(jl, tl, seed):
    """Give both layers the same random weights (norm scales near 1)."""
    rng = np.random.RandomState(seed)
    new = {}
    for name, p in tl.named_parameters():
        a = 0.1 * _np(rng, *p.shape)
        new[name] = a + 1.0 if "scale" in name or (
            "ln" in name and name.endswith("weight")) else a
    jl.load_raw_state({k: jnp.asarray(v) for k, v in new.items()})
    params_from_paddle_tpu(new, tl)


def test_bias_dropout_residual_layer_norm_layer_matches_jax():
    """Eval at rate 0.3, then training at rate 0: both apply no mask."""
    rng = np.random.RandomState(4)
    x, res = _np(rng, 2, 8, 64), _np(rng, 2, 8, 64)
    for rate, training in ((0.3, False), (0.0, True)):
        jl, tl = _jax_layer_pair(
            jax_incubate.nn.FusedBiasDropoutResidualLayerNorm,
            incubate.nn.FusedBiasDropoutResidualLayerNorm, 64,
            dropout_rate=rate)
        _randomize(jl, tl, 5)
        if not training:
            jl.eval()
            tl.eval()
        want = np.asarray(jl(paddle.to_tensor(x),
                             paddle.to_tensor(res))._value)
        got = tl(_t(x), _t(res))
        np.testing.assert_allclose(got.detach().numpy(), want, **OUT_TOL)


def test_bias_dropout_residual_layer_norm_layer_draws_its_mask():
    """At rate 0.3 the layer keeps a share of 0.7 within 4 sigma, and its
    y is the plain function at the mask drawn from its generator."""
    layer = incubate.nn.FusedBiasDropoutResidualLayerNorm(
        256, dropout_rate=0.3, device="cpu",
        generator=torch.Generator().manual_seed(7))
    rng = np.random.RandomState(6)
    x, res = _t(_np(rng, 4, 16, 256)), _t(_np(rng, 4, 16, 256))
    replay = torch.Generator()
    replay.set_state(layer.generator.get_state())
    y = layer(x, res)
    mask = torch.rand((64, 256), generator=replay) < 0.7
    n = mask.numel()
    assert abs(mask.float().mean().item() - 0.7) < 4 * (0.7 * 0.3 / n) ** 0.5
    want, _, _ = fo.bias_dropout_residual_ln_plain(
        x.reshape(64, 256), res.reshape(64, 256), layer.linear_bias,
        layer.ln_scale, layer.ln_bias, mask, 0.3, 1e-5, True)
    torch.testing.assert_close(y.detach(), want.reshape(y.shape), rtol=0,
                               atol=0)
    (y * y).mean().backward()
    assert all(p.grad is not None for p in layer.parameters())


LAYERS = {
    "attention": (lambda nb: (
        jax_incubate.nn.FusedMultiHeadAttention,
        incubate.nn.FusedMultiHeadAttention, (64, 4),
        dict(dropout_rate=0.0, attn_dropout_rate=0.0, normalize_before=nb))),
    "feedforward": (lambda nb: (
        jax_incubate.nn.FusedFeedForward, incubate.nn.FusedFeedForward,
        (64, 128), dict(dropout_rate=0.0, activation="gelu",
                        normalize_before=nb))),
    "encoder_layer": (lambda nb: (
        jax_incubate.nn.FusedTransformerEncoderLayer,
        incubate.nn.FusedTransformerEncoderLayer, (64, 4, 128),
        dict(dropout_rate=0.0, activation="gelu", normalize_before=nb))),
    "multi_transformer": (lambda nb: (
        jax_incubate.nn.FusedMultiTransformer,
        incubate.nn.FusedMultiTransformer, (64, 4, 128),
        dict(num_layers=2, normalize_before=nb))),
}


def _layer_case(name, normalize_before, mask=None):
    jax_cls, port_cls, args, kw = LAYERS[name](normalize_before)
    jl, tl = _jax_layer_pair(jax_cls, port_cls, *args, **kw)
    _randomize(jl, tl, 8)
    rng = np.random.RandomState(9)
    x, g = _np(rng, 2, 128, 64), _np(rng, 2, 128, 64)
    extra_j, extra_t = {}, {}
    if mask is not None:
        extra_j["src_mask"] = paddle.to_tensor(mask)
        extra_t["src_mask"] = _t(mask)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jl(jx, **extra_j)
    (jout * paddle.to_tensor(g)).sum().backward()
    tx = _t(x, True)
    out = tl(tx, **extra_t)
    (out * _t(g)).sum().backward()
    want = np.asarray(jout._value)
    np.testing.assert_allclose(out.detach().numpy(), want, **OUT_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad._value),
                               **GRAD_TOL)
    jgrads = {k: p.grad for k, p in jl.named_parameters()}
    for k, p in tl.named_parameters():
        if jgrads[k] is None:  # pre_ln in post-LN mode: read by neither
            assert p.grad is None, k
            continue
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgrads[k]._value), **GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("name", list(LAYERS))
def test_fused_layer_matches_jax(name, normalize_before):
    """Output and every gradient at width 64, 4 heads of 16, S = 128: the
    flash route on both sides."""
    _layer_case(name, normalize_before)


def test_encoder_layer_with_additive_mask_matches_jax():
    """An additive (B, 1, 1, S) mask sends both sides' attention to the
    composition route."""
    mask = np.zeros((2, 1, 1, 128), np.float32)
    mask[0, ..., 100:] = -1e9
    mask[1, ..., 7:] = -1e9
    _layer_case("encoder_layer", False, mask=mask)


def test_functional_surface():
    from paddle_tpu.incubate.nn import functional as jf
    from paddle_tpu_torch.incubate.nn import functional as tf

    rng = np.random.RandomState(10)
    x, w1, w2 = _np(rng, 2, 5, 16), _np(rng, 16, 32), _np(rng, 32, 16)
    b, res = _np(rng, 32), _np(rng, 2, 5, 16)
    jx = paddle.to_tensor(x)
    np.testing.assert_allclose(
        tf.fused_linear(_t(x), _t(w1), _t(b)).numpy(),
        np.asarray(jf.fused_linear(jx, paddle.to_tensor(w1),
                                   paddle.to_tensor(b))._value), **OUT_TOL)
    np.testing.assert_allclose(
        tf.fused_linear(_t(x), _t(w1.T.copy()), transpose_weight=True).numpy(),
        np.asarray(jf.fused_linear(jx, paddle.to_tensor(w1.T.copy()),
                                   transpose_weight=True)._value), **OUT_TOL)
    np.testing.assert_allclose(
        tf.fused_feedforward(_t(x), _t(w1), _t(w2)).numpy(),
        np.asarray(jf.fused_feedforward(jx, paddle.to_tensor(w1),
                                        paddle.to_tensor(w2))._value),
        **OUT_TOL)
    ln_w, ln_b = 1 + _np(rng, 16), _np(rng, 16)
    np.testing.assert_allclose(
        tf.fused_layer_norm(_t(x), _t(ln_w), _t(ln_b),
                            begin_norm_axis=2).numpy(),
        np.asarray(jf.fused_layer_norm(jx, paddle.to_tensor(ln_w),
                                       paddle.to_tensor(ln_b),
                                       begin_norm_axis=2)._value), **OUT_TOL)
    np.testing.assert_allclose(
        tf.fused_bias_dropout_residual_layer_norm(
            _t(x), _t(res), training=False).numpy(),
        np.asarray(jf.fused_bias_dropout_residual_layer_norm(
            jx, paddle.to_tensor(res), training=False)._value), **OUT_TOL)
    # the other dropout mode composes dropout and layer_norm
    np.testing.assert_allclose(
        tf.fused_bias_dropout_residual_layer_norm(
            _t(x), _t(res), training=False,
            mode="downscale_in_infer").numpy(),
        np.asarray(jf.fused_bias_dropout_residual_layer_norm(
            jx, paddle.to_tensor(res), training=False,
            mode="downscale_in_infer")._value), **OUT_TOL)


@pytest.mark.parametrize("kind", ["bool_causal", "additive"])
def test_sdpa_mask_route_matches_jax(kind):
    """A dense mask takes the composition route on both sides; GQA, a
    boolean mask beside is_causal, and an additive mask."""
    from paddle_tpu.ops import nn_kernels as jax_nn
    from paddle_tpu_torch.ops import nn_kernels

    rng = np.random.RandomState(11)
    q, k, v = _np(rng, 2, 16, 4, 8), _np(rng, 2, 16, 2, 8), _np(rng, 2, 16,
                                                                2, 8)
    if kind == "additive":
        mask, causal = -1e9 * (rng.rand(2, 1, 1, 16) < 0.3), False
        mask = mask.astype(np.float32)
    else:
        mask, causal = rng.rand(2, 4, 16, 16) < 0.8, True
        mask[..., 0] = True  # every row keeps a key below the diagonal
    want = jax_nn.scaled_dot_product_attention(
        *(jnp.asarray(a) for a in (q, k, v)), attn_mask=jnp.asarray(mask),
        is_causal=causal)
    got = nn_kernels.scaled_dot_product_attention(
        _t(q), _t(k), _t(v), attn_mask=_t(mask), is_causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_dropout_draws_from_its_generator():
    """Keep share within 4 sigma of 1 - p, kept values scaled by 1/(1-p)
    (or not, in the other mode), a mask over ``axis`` broadcast over the
    rest, and the same generator state giving the same mask; the
    attention dropout route takes the generator too."""
    from paddle_tpu_torch.ops import nn_kernels

    x = torch.ones(64, 256)
    g = torch.Generator().manual_seed(3)
    state = g.get_state()
    y = nn_kernels.dropout(x, p=0.25, generator=g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 4 * (0.1875 / y.numel()) ** 0.5
    assert torch.all(y[kept] == 1 / 0.75)
    g.set_state(state)
    assert torch.equal(nn_kernels.dropout(x, p=0.25, generator=g), y)
    z = nn_kernels.dropout(x, p=0.5, axis=0, mode="downscale_in_infer",
                           generator=g)
    assert torch.all((z == 0).all(1) | (z == 1).all(1))
    assert torch.equal(nn_kernels.dropout(x, p=0.5, training=False), x)
    q = _t(_np(np.random.RandomState(12), 1, 8, 2, 4))
    state = g.get_state()
    a = nn_kernels.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                                generator=g)
    g.set_state(state)
    b = nn_kernels.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                                generator=g)
    assert torch.equal(a, b)
    eval_out = nn_kernels.scaled_dot_product_attention(
        q, q, q, dropout_p=0.5, training=False)
    torch.testing.assert_close(eval_out,
                               nn_kernels.scaled_dot_product_attention(q, q, q),
                               rtol=1e-5, atol=1e-6)
