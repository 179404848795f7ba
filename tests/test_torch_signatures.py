"""The port's public ops take the JAX package's signatures: the same calls,
positional and keyword, give the same results.

``rms_norm(x, weight=None, bias=None, epsilon=1e-06)`` (JAX
``ops/nn_kernels.py:162``), the biased RMSNorm forward and its dx, dw and
db (JAX ``ops/pallas/rms_norm.py`` with ``has_bias=True``, interpret
mode), the public ``flash_attention(q, k, v, is_causal=False,
seq_lens=None, segment_ids=None)`` returning ``out`` (JAX
``ops/pallas/flash_attention.py:431``), ``scaled_dot_product_attention``
in JAX's argument order (:732) and ``rotary_position_embedding`` with
``use_neox_rotary_style`` (:804), and ``seq_lens`` / ``segment_ids`` on
the flash and composition routes. ``softmax_with_cross_entropy(logits,
label, soft_label=False, ignore_index=-100, axis=-1)`` (:859), and the
kernel modules' public names against ``ops/pallas/``:
``ops/cuda/rms_norm.rms_norm(x, weight, bias, epsilon, has_bias)``
(:159) and ``ops/cuda/fused_ops.fused_rope(q, k, cos, sin)`` (:99), with
the port's own row and position entries (``rms_norm_rows``,
``fused_rope_at``) against their plain versions.

Inputs come from numpy with a seed, in f32 on the CPU, where each port
kernel runs its plain version. Tolerances: 1e-6 where both sides compute
the same f32 composition; 1e-5 against a Pallas kernel, whose sums
(online softmax, blocked reductions) run in another order.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_kernels as jax_nn
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu.ops.pallas import fused_ops as jax_fo
from paddle_tpu.ops.pallas import rms_norm as jax_rn
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.ops import nn_kernels
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


SAME = dict(atol=1e-6, rtol=1e-6)
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


def _j(a):
    return jnp.asarray(a)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


RMS_CALLS = {  # name -> (args, kwargs), built from x, w, b
    "positional": lambda x, w, b: ((x, w, b), {}),
    "positional_epsilon": lambda x, w, b: ((x, w, b, 1e-5), {}),
    "keyword": lambda x, w, b: ((x,), dict(weight=w, bias=b, epsilon=1e-5)),
    "weight_none": lambda x, w, b: ((x,), dict(bias=b)),
    "bias_none": lambda x, w, b: ((x, w), {}),
    "both_none": lambda x, w, b: ((x,), {}),
}


@pytest.mark.parametrize("call", sorted(RMS_CALLS))
def test_rms_norm_signature_matches_jax(call):
    """(4, 128) rows: JAX takes its jnp composition (no Pallas row block),
    the port its plain version; the same f32 math."""
    rng = np.random.RandomState(0)
    x, w, b = _np(rng, 4, 128), 1.0 + 0.1 * _np(rng, 128), _np(rng, 128)
    args, kwargs = RMS_CALLS[call](x, w, b)
    want = jax_nn.rms_norm(*(_j(a) if isinstance(a, np.ndarray) else a
                             for a in args),
                           **{k: _j(v) if isinstance(v, np.ndarray) else v
                              for k, v in kwargs.items()})
    got = nn_kernels.rms_norm(*(_t(a) if isinstance(a, np.ndarray) else a
                                for a in args),
                              **{k: _t(v) if isinstance(v, np.ndarray) else v
                                 for k, v in kwargs.items()})
    assert torch.isfinite(got).all()
    _close(got, want, SAME)


@pytest.mark.parametrize("via", ["function", "layer"])
def test_rms_norm_bias_matches_pallas(via):
    """The biased forward and its dx, dw and db against the Pallas kernels
    (``has_bias=True``, interpret mode) through ``jax.vjp``; on the port's
    side through ``nn_kernels.rms_norm`` or ``RMSNorm(bias_attr=None)``,
    whose bias receives db in ``.grad``."""
    rng = np.random.RandomState(1)
    x, g = _np(rng, 2, 16, 256), _np(rng, 2, 16, 256)
    w, b = 1.0 + 0.1 * _np(rng, 256), 0.1 * _np(rng, 256)
    want, vjp = jax.vjp(lambda x_, w_, b_: jax_rn.rms_norm(x_, w_, b_, 1e-6,
                                                           True),
                        _j(x), _j(w), _j(b))
    want_dx, want_dw, want_db = vjp(_j(g))
    xt = _t(x, True)
    if via == "layer":
        layer = RMSNorm(256, 1e-6, bias_attr=None, device="cpu",
                        dtype=torch.float32)
        assert torch.all(layer.bias == 0)
        with torch.no_grad():
            layer.weight.copy_(_t(w))
            layer.bias.copy_(_t(b))
        wt, bt = layer.weight, layer.bias
        y = layer(xt)
    else:
        wt, bt = _t(w, True), _t(b, True)
        y = nn_kernels.rms_norm(xt, wt, bt, 1e-6)
    y.backward(_t(g))
    _close(y, want, KERNEL)
    _close(xt.grad, want_dx, KERNEL)
    _close(wt.grad, want_dw, KERNEL)
    _close(bt.grad, want_db, KERNEL)


FLASH_CALLS = {  # name -> (port call, JAX call) on (q, k, v)
    "bare": (lambda q, k, v: fa.flash_attention(q, k, v),
             lambda q, k, v: jax_fa.flash_attention(q, k, v)),
    "positional_causal": (lambda q, k, v: fa.flash_attention(q, k, v, True),
                          lambda q, k, v: jax_fa.flash_attention(q, k, v,
                                                                 True)),
    "keyword_causal": (
        lambda q, k, v: fa.flash_attention(q, k, v, is_causal=True),
        lambda q, k, v: jax_fa.flash_attention(q, k, v, is_causal=True)),
}


@pytest.mark.parametrize("call", sorted(FLASH_CALLS))
def test_flash_attention_matches_jax(call):
    """The public flash attention returns ``out`` alone, non-causal by
    default; under autograd its dq, dk and dv are JAX's (``jax.vjp``
    through the Pallas kernels). GQA, (1, 128, 2 on 1, 64)."""
    rng = np.random.RandomState(2)
    q, g = _np(rng, 1, 128, 2, 64), _np(rng, 1, 128, 2, 64)
    k, v = _np(rng, 1, 128, 1, 64), _np(rng, 1, 128, 1, 64)
    port, ref = FLASH_CALLS[call]
    want, vjp = jax.vjp(ref, _j(q), _j(k), _j(v))
    ts = [_t(a, True) for a in (q, k, v)]
    got = port(*ts)
    assert isinstance(got, torch.Tensor) and got.shape == q.shape
    _close(got, want, KERNEL)
    got.backward(_t(g))
    for t, w in zip(ts, vjp(_j(g))):
        _close(t.grad, w, KERNEL)


def _sdpa_inputs():
    rng = np.random.RandomState(3)
    q = _np(rng, 2, 128, 4, 32)
    k, v = _np(rng, 2, 128, 2, 32), _np(rng, 2, 128, 2, 32)
    mask = rng.rand(2, 4, 128, 128) < 0.8
    mask[..., 0] = True  # every row keeps a key
    return q, k, v, mask


SDPA_CALLS = {  # name -> (args after q, k, v), from the mask
    "positional_bool_mask": lambda m: (m,),
    "positional_additive_mask": lambda m: (
        np.where(m, 0.0, -1e9).astype(np.float32),),
    "positional_causal": lambda m: (None, 0.0, True),
    "positional_mask_and_causal": lambda m: (m, 0.0, True, False),
}


@pytest.mark.parametrize("call", sorted(SDPA_CALLS))
def test_sdpa_argument_order_matches_jax(call):
    """``(q, k, v, attn_mask, dropout_p, is_causal, training)`` by
    position: a mask takes the composition on both sides, a bare causal
    call the flash route (JAX's Pallas kernel, interpret mode; the port's
    plain flash version)."""
    q, k, v, mask = _sdpa_inputs()
    rest = SDPA_CALLS[call](mask)
    want = jax_nn.scaled_dot_product_attention(
        _j(q), _j(k), _j(v),
        *(_j(a) if isinstance(a, np.ndarray) else a for a in rest))
    got = nn_kernels.scaled_dot_product_attention(
        _t(q), _t(k), _t(v),
        *(_t(a) if isinstance(a, np.ndarray) else a for a in rest))
    _close(got, want, KERNEL)


ROPE_CALLS = {  # name -> (args after q, k, cos, sin), kwargs
    "default": ((), {}),
    "neox_keyword": ((), dict(use_neox_rotary_style=True)),
    "neox_positional": ((None, True), {}),
}


@pytest.mark.parametrize("call", sorted(ROPE_CALLS) + ["interleaved"])
def test_rope_signature_matches_jax(call):
    """``use_neox_rotary_style=True`` (the default) is the port's rotation;
    ``False`` rotates the interleaved pairs as JAX's jnp formula does:
    without position ids, with (B, S) and (S,) ones, and with k=None."""
    rng = np.random.RandomState(4)
    q, k = _np(rng, 2, 24, 4, 32), _np(rng, 2, 24, 2, 32)
    cos, sin = _rope_tables(32, 64, 10000.0, "cpu")
    if call == "interleaved":
        jcos, jsin = _j(cos.numpy()), _j(sin.numpy())
        pos2 = rng.randint(0, 64, (2, 24)).astype(np.int32)
        pos1 = rng.randint(0, 64, (24,)).astype(np.int32)
        jax_rope = jax.jit(functools.partial(jax_nn.rotary_position_embedding,
                                             use_neox_rotary_style=False))
        for pos, kk in ((None, k), (pos2, k), (pos1, k), (pos2, None)):
            wq, wk = jax_rope(_j(q), None if kk is None else _j(kk), jcos,
                              jsin, None if pos is None else _j(pos))
            gq, gk = nn_kernels.rotary_position_embedding(
                _t(q), None if kk is None else _t(kk), cos, sin,
                None if pos is None else _t(pos),
                use_neox_rotary_style=False)
            _close(gq, wq, KERNEL)
            if kk is None:
                assert gk is None and wk is None
            else:
                _close(gk, wk, KERNEL)
        return
    args, kwargs = ROPE_CALLS[call]
    wq, wk = jax_nn.rotary_position_embedding(
        _j(q), _j(k), _j(cos.numpy()), _j(sin.numpy()), *args, **kwargs)
    gq, gk = nn_kernels.rotary_position_embedding(_t(q), _t(k), cos, sin,
                                                  *args, **kwargs)
    _close(gq, wq, KERNEL)
    _close(gk, wk, KERNEL)


SEGMENT_CALLS = {  # name -> (port call, JAX call) on (q, mask, lens, ids)
    "flash_seq_lens": (
        lambda q, m, n, i: fa.flash_attention(q, q, q, seq_lens=n),
        lambda q, m, n, i: jax_fa.flash_attention(q, q, q, seq_lens=n)),
    "flash_segment_ids": (
        lambda q, m, n, i: fa.flash_attention(q, q, q, True, None, i),
        lambda q, m, n, i: jax_fa.flash_attention(q, q, q, True, None, i)),
    "sdpa_seq_lens": (
        lambda q, m, n, i: nn_kernels.scaled_dot_product_attention(
            q, q, q, is_causal=True, seq_lens=n),
        lambda q, m, n, i: jax_nn.scaled_dot_product_attention(
            q, q, q, is_causal=True, seq_lens=n)),
    "sdpa_segment_ids": (
        lambda q, m, n, i: nn_kernels.scaled_dot_product_attention(
            q, q, q, segment_ids=i),
        lambda q, m, n, i: jax_nn.scaled_dot_product_attention(
            q, q, q, segment_ids=i)),
    "sdpa_mask_and_seq_lens": (
        lambda q, m, n, i: nn_kernels.scaled_dot_product_attention(
            q, q, q, m, seq_lens=n),
        lambda q, m, n, i: jax_nn.scaled_dot_product_attention(
            q, q, q, m, seq_lens=n)),
}


@pytest.mark.parametrize("call", sorted(SEGMENT_CALLS))
def test_segment_masking_raises(call):
    """``seq_lens`` and ``segment_ids`` take the JAX signatures on every
    route and give JAX's result: the flash routes against JAX's masked
    Pallas kernels (interpret mode), the composition (with a mask)
    against JAX's -1e30 fill. (1, 128, 2, 64), one row of 37 valid
    tokens, packed ids; every row sees a key. Nothing raises any more;
    the test keeps its name."""
    rng = np.random.RandomState(5)
    q = _np(rng, 1, 128, 2, 64)
    mask = rng.rand(1, 2, 128, 128) < 0.8
    mask[..., 0] = True
    lens = np.array([37], np.int32)
    ids = np.repeat(np.arange(4, dtype=np.int32), [20, 50, 30, 28])[None]
    port, ref = SEGMENT_CALLS[call]
    want = ref(_j(q), _j(mask), _j(lens), _j(ids))
    got = port(_t(q), _t(mask), _t(lens), _t(ids))
    _close(got, want, KERNEL)


def test_flash_attention_fwd_keeps_out_and_lse():
    """``flash_attention_fwd`` is the (out, lse) entry, JAX's ``_fwd``."""
    rng = np.random.RandomState(6)
    q, k, v = (_np(rng, 1, 128, 2, 32) for _ in range(3))
    want_o, want_lse = jax_fa._fwd(
        *(jnp.swapaxes(_j(a), 1, 2) for a in (q, k, v)), True,
        1.0 / math.sqrt(32))
    out, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
    _close(out, np.swapaxes(np.asarray(want_o), 1, 2), KERNEL)
    _close(lse, np.asarray(want_lse)[..., 0], KERNEL)


CE_CALLS = {  # name -> (args after logits, kwargs) from (hard, soft) labels
    "hard_positional_false": lambda h, s: ((h, False), {}),
    "hard_bare": lambda h, s: ((h,), {}),
    "hard_trailing_axis": lambda h, s: ((h[..., None],), {}),
    "hard_keyword_ignore_index": lambda h, s: ((h,), dict(ignore_index=3)),
    "hard_positional_ignore_index": lambda h, s: ((h, False, 0), {}),
    "hard_axis_keyword": lambda h, s: ((h,), dict(axis=1)),
    "soft_positional_true": lambda h, s: ((s, True), {}),
    "soft_keyword": lambda h, s: ((s,), dict(soft_label=True)),
    "soft_axis_1": lambda h, s: ((np.moveaxis(s, 2, 1),),
                                 dict(soft_label=True, axis=1)),
}


@pytest.mark.parametrize("call", sorted(CE_CALLS))
def test_softmax_with_cross_entropy_matches_jax(call):
    """JAX's signature and semantics in positional and keyword forms: a
    positional False is ``soft_label``, not ``ignore_index``; hard labels
    (the ignored value and 0 among them) with a trailing singleton axis
    squeezed and ``ignore_index`` entries 0; soft labels ``-sum(label *
    logp)``; the reduction along ``axis`` (``soft_axis_1``: the (4, 6, 8)
    logits and labels with their class axis moved to axis 1, reduced
    there). Both sides the same f32 math."""
    rng = np.random.RandomState(7)
    logits = _np(rng, 4, 6, 8)
    hard = rng.randint(0, 8, (4, 6))
    hard[0, :2] = [-100, 0]
    ignore = {"hard_keyword_ignore_index": 3,
              "hard_positional_ignore_index": 0}.get(call)
    if ignore is not None:  # the ignored value in place of -100
        hard[hard == -100] = ignore
    hard2 = hard[:, 0] if call == "hard_axis_keyword" else hard
    soft = rng.rand(4, 6, 8).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    x = logits[:, 0] if call == "hard_axis_keyword" else logits
    if call == "soft_axis_1":
        x = np.moveaxis(logits, 2, 1)
    args, kwargs = CE_CALLS[call](hard2, soft)
    want = jax_nn.softmax_with_cross_entropy(
        _j(x), *(_j(a) if isinstance(a, np.ndarray) else a for a in args),
        **kwargs)
    got = nn_kernels.softmax_with_cross_entropy(
        _t(x), *(_t(a) if isinstance(a, np.ndarray) else a for a in args),
        **kwargs)
    assert got.shape == want.shape
    _close(got, want, SAME)


@pytest.mark.parametrize("has_bias", [False, True])
def test_kernel_module_rms_norm_matches_pallas(has_bias):
    """``ops/cuda/rms_norm.rms_norm(x, w, b, 1e-6[, has_bias])`` on a
    rank-3 x returns JAX's ``ops/pallas/rms_norm.rms_norm`` output alone
    (interpret mode), the bias added only with ``has_bias``, and under
    autograd JAX's dx, dw (and db)."""
    rng = np.random.RandomState(8)
    x, g = _np(rng, 2, 8, 256), _np(rng, 2, 8, 256)
    w, b = 1.0 + 0.1 * _np(rng, 256), _np(rng, 256)
    want, vjp = jax.vjp(
        lambda x_, w_, b_: jax_rn.rms_norm(x_, w_, b_, 1e-6, has_bias),
        _j(x), _j(w), _j(b))
    want_grads = vjp(_j(g))
    with torch.no_grad():
        got = (rn.rms_norm(_t(x), _t(w), _t(b), 1e-6, has_bias=True)
               if has_bias else rn.rms_norm(_t(x), _t(w), _t(b), 1e-6))
    assert isinstance(got, torch.Tensor) and got.shape == x.shape
    _close(got, want, KERNEL)
    ts = [_t(a, True) for a in (x, w, b)]
    rn.rms_norm(*ts, 1e-6, has_bias).backward(_t(g))
    for t, wg in zip(ts[:2], want_grads[:2]):
        _close(t.grad, wg, KERNEL)
    if has_bias:
        _close(ts[2].grad, want_grads[2], KERNEL)
    else:
        assert ts[2].grad is None


def test_kernel_module_fused_rope_matches_pallas():
    """``ops/cuda/fused_ops.fused_rope(q, k, cos, sin)`` with (64, 32)
    tables for S = 24 (cropped to S, as JAX's) and GQA k: JAX's rotation
    (interpret mode) and, under autograd, its adjoint; k of None rotates q
    alone."""
    rng = np.random.RandomState(9)
    q, k = _np(rng, 2, 24, 4, 32), _np(rng, 2, 24, 2, 32)
    gq, gk = _np(rng, 2, 24, 4, 32), _np(rng, 2, 24, 2, 32)
    cos, sin = _rope_tables(32, 64, 10000.0, "cpu")
    jc, js = _j(cos.numpy()), _j(sin.numpy())
    (wq, wk), vjp = jax.vjp(lambda q_, k_: jax_fo.fused_rope(q_, k_, jc, js),
                            _j(q), _j(k))
    want_dq, want_dk = vjp((_j(gq), _j(gk)))
    qt, kt = _t(q, True), _t(k, True)
    got_q, got_k = fo.fused_rope(qt, kt, cos, sin)
    _close(got_q, wq, KERNEL)
    _close(got_k, wk, KERNEL)
    torch.autograd.backward((got_q, got_k), (_t(gq), _t(gk)))
    _close(qt.grad, want_dq, KERNEL)
    _close(kt.grad, want_dk, KERNEL)
    alone, none = fo.fused_rope(_t(q), None, cos, sin)
    assert none is None
    _close(alone, wq, KERNEL)


def test_row_and_position_entries_match_plain():
    """The port's own entries keep their behaviour under their new names:
    ``rms_norm_rows`` returns ``(y, r)`` with the bias added whenever one
    is given, and equals ``rms_norm(..., has_bias=True)`` row by row;
    ``fused_rope_at`` rotates at any (B, S) positions, either way, and at
    0 .. S - 1 equals ``fused_rope``. All against the plain versions."""
    rng = np.random.RandomState(10)
    x, w, b = _t(_np(rng, 16, 64)), _t(_np(rng, 64)), _t(_np(rng, 64))
    y, r = rn.rms_norm_rows(x, w, b, 1e-6)
    py, pr = rn.rms_norm_plain(x, w, b, 1e-6)
    _close(y, py.numpy(), SAME)
    _close(r, pr.numpy(), SAME)
    _close(rn.rms_norm(x.view(2, 8, 64), w, b, 1e-6, has_bias=True),
           py.view(2, 8, 64).numpy(), SAME)
    q, k = _t(_np(rng, 2, 12, 4, 32)), _t(_np(rng, 2, 12, 2, 32))
    cos, sin = _rope_tables(32, 40, 10000.0, "cpu")
    pos = torch.from_numpy(rng.randint(0, 40, (2, 12)).astype(np.int32))
    for inverse in (False, True):
        for got, want in zip(fo.fused_rope_at(q, k, cos, sin, pos, inverse),
                             fo.fused_rope_plain(q, k, cos, sin, pos,
                                                 inverse)):
            _close(got, want.numpy(), SAME)
    arange = torch.arange(12, dtype=torch.int32).expand(2, 12)
    for got, want in zip(fo.fused_rope(q, k, cos, sin),
                         fo.fused_rope_at(q, k, cos, sin, arange)):
        _close(got, want.numpy(), SAME)


# ---- the training surface: the LLaMA forwards' attn_mask, LlamaConfig, the
# optimizers, the schedulers and the clips (names, order and defaults)

def _params(fn):
    """(name, kind, default) of each parameter, ``self`` dropped."""
    import inspect

    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()
            if p.name != "self"]


def _surface():
    """(name, JAX callable, port callable) of every signature that the
    training surface shares with JAX."""
    import paddle_tpu as paddle
    from paddle_tpu.models import llama as jl
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models import llama as tl
    from paddle_tpu_torch.optimizer import lr as tlr

    out = [(f"{c}.forward", getattr(jl, c).forward, getattr(tl, c).forward)
           for c in ("LlamaAttention", "LlamaDecoderLayer", "LlamaModel",
                     "LlamaForCausalLM")]
    out += [(c, getattr(paddle.optimizer, c).__init__,
             getattr(topt, c).__init__)
            for c in ("Optimizer", "Adam", "AdamW")]
    out += [(c, getattr(paddle.optimizer.lr, c).__init__,
             getattr(tlr, c).__init__) for c in paddle.optimizer.lr.__all__]
    out += [(c, getattr(paddle.nn.clip, c).__init__, getattr(tnn.clip, c)
             .__init__) for c in ("ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm")]
    out += [("clip_grad_norm_", paddle.nn.clip.clip_grad_norm_,
             tnn.clip_grad_norm_),
            ("ReduceOnPlateau.step", paddle.optimizer.lr.ReduceOnPlateau.step,
             tlr.ReduceOnPlateau.step),
            ("Optimizer.clear_grad", paddle.optimizer.Optimizer.clear_grad,
             topt.Optimizer.clear_grad)]
    return out


SURFACE = [name for name, _, _ in _surface()]


@pytest.mark.parametrize("name", SURFACE)
def test_training_surface_signatures_match_jax(name):
    """Each shared callable takes JAX's parameters, in JAX's order, with
    JAX's defaults."""
    _, jax_fn, port_fn = next(s for s in _surface() if s[0] == name)
    assert _params(port_fn) == _params(jax_fn)


def test_llama_config_fields_match_jax():
    """``LlamaConfig`` takes JAX's keywords in JAX's order with JAX's
    defaults, ``use_recompute`` and the three fields read by nothing
    included."""
    import dataclasses

    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu_torch.models import LlamaConfig

    want = [(n, d) for n, _, d in _params(JaxConfig.__init__)]
    got = [(f.name, f.default) for f in dataclasses.fields(LlamaConfig)]
    assert got == want
    cfg = LlamaConfig(hidden_size=64, num_attention_heads=4,
                      use_recompute=True, sequence_parallel=True,
                      use_flash_attention=False, dtype="bfloat16")
    assert (cfg.use_recompute, cfg.sequence_parallel,
            cfg.use_flash_attention, cfg.dtype) == (True, True, False,
                                                    "bfloat16")


@pytest.fixture(scope="module")
def llama_pair():
    """A tiny LLaMA (seq 32, so that JAX's attention takes its XLA
    composition) built by JAX from a seed and carried into the port."""
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JaxConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlama
    from paddle_tpu_torch.models import (
        LlamaConfig,
        LlamaForCausalLM,
        params_from_paddle_tpu,
    )

    cfg = dict(vocab_size=64, hidden_size=64, intermediate_size=128,
               num_hidden_layers=2, num_attention_heads=2,
               max_position_embeddings=64)
    paddle.seed(0)
    jm = JaxLlama(JaxConfig(**cfg))
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    params_from_paddle_tpu({k: np.asarray(v) for k, v in
                            jm.raw_state()[0].items()}, tm)
    ids = np.random.RandomState(3).randint(0, 64, (2, 32)).astype(np.int32)
    return jm, tm, ids


def test_llama_positional_labels_match_jax(llama_pair):
    """``model(ids, None, None, ids)``: JAX's positions (attn_mask, caches,
    labels) give the labels loss on both sides, 1e-5 relative."""
    import paddle_tpu as paddle

    jm, tm, ids = llama_pair
    want = float(jm(paddle.to_tensor(ids), None, None, paddle.to_tensor(ids)))
    got = tm(torch.from_numpy(ids).long(), None, None,
             torch.from_numpy(ids).long())
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-5)


def test_llama_dense_attn_mask_matches_jax(llama_pair):
    """A boolean (B, 1, S, S) mask, causal with the second row's last 9
    keys padded, passed positionally: logits as JAX's (both take the
    composition of ``scaled_dot_product_attention``), 1e-5."""
    import paddle_tpu as paddle

    jm, tm, ids = llama_pair
    s = ids.shape[1]
    mask = np.tril(np.ones((s, s), dtype=bool))[None, None].repeat(2, 0)
    mask[1, :, :, s - 9:] = False
    mask[1, :, s - 9:, s - 9:] = np.eye(9, dtype=bool)  # no empty row
    want = jm(paddle.to_tensor(ids), paddle.to_tensor(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(got, np.asarray(want._value), KERNEL)
