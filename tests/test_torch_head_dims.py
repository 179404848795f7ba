"""Head dims off 64 and 128: the port against the JAX package.

The port's flash kernels are built at head dims 32, 64, 96, 128 and 256
and take any other head dim up to 256 by the padded route (zero-pad to the
next built width, the true scale, slice back); its paged decode kernel
takes any head dim up to 256 at its own width. On the CPU each wrapper
runs its plain version, and the padded route is held here through its own
function (``padded_fwd`` / ``padded_bwd`` over the plain versions), so
the route is tested without the card. The JAX side runs its Pallas
kernels in interpret mode (its ``_flash_bhsd`` wrapped in ``jax.jit`` by
a module fixture, so each shape lowers once), as its own tests do.
Inputs come from numpy with a seed, all f32; tolerance 2e-5 absolute and
relative (f32 sums reassociated; the results agree to ~1e-6).

Also here: RoPE with ``k=None`` and ``scaled_dot_product_attention`` at
head dim 320 (the plain composition on both sides), and a 2-layer LLaMA
with head_dim 96 (hidden 192, 2 heads) carried from ``paddle_tpu`` by
``params_from_paddle_tpu``: logits (1e-5), greedy engine streams
(token-identical, each choice's top-2 logit gap above 1e-4, far over the
~1e-6 f32 noise) and two ``TrainStep`` losses (1e-5 relative).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
from paddle_tpu.models.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.ops import nn_kernels as jax_nn
from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu.ops.pallas import fused_ops as jax_fo
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    ContinuousBatchingEngine,
    LlamaConfig,
    LlamaForCausalLM,
    LlamaPretrainingCriterion,
    params_from_paddle_tpu,
)
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.ops import nn_kernels
from paddle_tpu_torch.ops.cuda import decode_attention as da
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import fused_ops as fo
from paddle_tpu_torch.optimizer import AdamW

TOL = dict(atol=2e-5, rtol=2e-5)
MIN_GAP = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _jax_flash_lowered_once():
    """One ``jax.jit`` around JAX's flash custom_vjp function, so the
    interpret-mode Pallas kernels lower once per shape rather than at
    every eager call. The function computed is the JAX package's own."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fa, "_flash_bhsd",
               jax.jit(jax_fa._flash_bhsd, static_argnums=(5, 6)))
    yield
    mp.undo()


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


# (head dim, kv heads, causal, seq_lens): every width on GQA causal and on
# MHA non-causal; one seq_lens case (the masked kernels)
FLASH_CASES = [(d, kvh, causal, None) for d in (32, 80, 96, 256)
               for kvh, causal in ((1, True), (2, False))]
FLASH_CASES.append((96, 1, True, (100, 57)))


@pytest.mark.parametrize("d,kvh,causal,seq_lens", FLASH_CASES)
def test_flash_attention_matches_pallas(d, kvh, causal, seq_lens):
    """Forward (out, lse) and backward (dq, dk, dv) at S = 128, 2 query
    heads, against JAX's Pallas flash in interpret mode: the port's
    wrappers (the plain versions on the CPU), the padded route's own
    function, and the public ``flash_attention`` under autograd."""
    rng = np.random.RandomState(d + kvh)
    b, s, h = 2, 128, 2
    q, k, v = _np(rng, b, s, h, d), _np(rng, b, s, kvh, d), _np(rng, b, s,
                                                                kvh, d)
    g = _np(rng, b, s, h, d)
    lens = None if seq_lens is None else np.asarray(seq_lens, np.int32)
    q_seg, k_seg = jax_fa.build_segments(b, s, s, lens)
    if seq_lens is not None:  # JAX's kernels take (B, 1, S) ids
        q_seg, k_seg = q_seg[:, None, :], k_seg[:, None, :]
    # the custom_vjp's two rules, each lowered once: out, lse, then the
    # gradients from the forward's residuals ((B, H, S, D) layout)
    bhsd = [jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v, g)]
    scale = 1.0 / math.sqrt(d)
    want_o, res = jax.jit(jax_fa._flash_fwd_rule, static_argnums=(5, 6))(
        *bhsd[:3], q_seg, k_seg, causal, scale)
    want = [np.swapaxes(np.asarray(w), 1, 2) for w in jax.jit(
        jax_fa._bwd, static_argnums=(0, 1))(causal, scale, res,
                                            bhsd[3])[:3]]
    want_o = np.swapaxes(np.asarray(want_o), 1, 2)
    want_lse = np.asarray(res[-1])[..., 0]

    pq_seg, pk_seg = fa.build_segments(b, s, s, lens)
    args = (_t(q), _t(k), _t(v))
    routes = [(fa.flash_attention_fwd, fa.flash_attention_bwd),
              (lambda *a: fa.padded_fwd(fa.flash_attention_fwd_plain, *a),
               lambda *a: fa.padded_bwd(fa.flash_attention_bwd_plain, *a))]
    for fwd, bwd in routes:
        out, lse = fwd(*args, causal, pq_seg, pk_seg)
        _close(out, want_o)
        _close(lse, want_lse)
        for a, w in zip(bwd(*args, out, lse, _t(g), causal, pq_seg,
                            pk_seg), want):
            _close(a, w)
    ts = [_t(a, True) for a in (q, k, v)]
    fa.flash_attention(*ts, is_causal=causal, seq_lens=lens).backward(_t(g))
    for a, w in zip(ts, want):
        _close(a.grad, w)


def test_native_head_dims_and_the_padded_widths():
    assert fa.HEAD_DIMS == (32, 64, 96, 128, 256)
    assert [fa.native_head_dim(d) for d in (1, 32, 33, 80, 100, 160, 192,
                                            256)] == [32, 32, 64, 96, 128,
                                                      256, 256, 256]
    with pytest.raises(ValueError, match="head_dim 320"):
        fa.native_head_dim(320)


def _paged_inputs(rng, lengths, cols, d, page=16, kvh=2, h=4):
    """Pool with scattered tables: each row's pages are a random draw from
    the pool; cells past a row's pages hold the last (dump) page."""
    b = len(lengths)
    n_pages = b * cols + 1
    perm = rng.permutation(n_pages - 1)
    tables = np.full((b, cols), n_pages - 1, np.int32)
    used = 0
    for i, n in enumerate(lengths):
        np_ = min(-(-n // page), cols)
        tables[i, :np_] = perm[used:used + np_]
        used += np_
    return (_np(rng, b, h, d), _np(rng, n_pages, page, kvh, d),
            _np(rng, n_pages, page, kvh, d), tables,
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("d", [80, 96, 256])
def test_paged_attention_matches_pallas(d):
    rng = np.random.RandomState(d)
    arrays = _paged_inputs(rng, [16, 7, 1, 48, 60], cols=4, d=d)
    for pps in (None, 3):
        want = jax_da.paged_attention(*(jnp.asarray(a) for a in arrays),
                                      pages_per_seq=pps)
        got = da.paged_attention(*(_t(a) for a in arrays), pages_per_seq=pps)
        _close(got, want)


def test_rope_with_k_none_matches_jax():
    """``k=None`` rotates q alone and returns None for k, on the Pallas
    route (position_ids None), the gather route (per-row positions) and
    the adjoint; the gradient of q through ``RopeFunction``."""
    rng = np.random.RandomState(1)
    b, s, h, d = 2, 24, 4, 96
    q, g = _np(rng, b, s, h, d), _np(rng, b, s, h, d)
    cos, sin = _rope_tables(d, 64, 10000.0, "cpu")
    jc, js = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())
    want_q, want_k = jax_nn.rotary_position_embedding(jnp.asarray(q), None,
                                                      jc, js)
    assert want_k is None
    pallas_q, none = jax_fo.fused_rope(jnp.asarray(q), None, jc, js)
    assert none is None
    np.testing.assert_allclose(np.asarray(pallas_q), np.asarray(want_q),
                               **TOL)
    qt = _t(q, True)
    got_q, got_k = nn_kernels.rotary_position_embedding(qt, None, cos, sin)
    assert got_k is None
    _close(got_q, want_q)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    got_q, got_k = fo.fused_rope_at(_t(q), None, cos, sin, pos)
    assert got_k is None
    _close(got_q, want_q)
    # the adjoint, and autograd through RopeFunction
    _, vjp = jax.vjp(lambda q_: jax_fo.fused_rope(q_, None, jc, js)[0],
                     jnp.asarray(q))
    (want_dq,) = vjp(jnp.asarray(g))
    dq, none = fo.fused_rope_at(_t(g), None, cos, sin, pos, inverse=True)
    assert none is None
    _close(dq, want_dq)
    nn_kernels.rotary_position_embedding(qt, None, cos, sin)[0].backward(
        _t(g))
    _close(qt.grad, want_dq)
    # per-row positions (the gather route in JAX)
    rows = np.array([[3] * s, list(range(5, 5 + s))], np.int32)
    want_q, want_k = jax_nn.rotary_position_embedding(
        jnp.asarray(q), None, jc, js, position_ids=jnp.asarray(rows))
    got_q, got_k = nn_kernels.rotary_position_embedding(_t(q), None, cos,
                                                        sin, _t(rows))
    assert want_k is None and got_k is None
    _close(got_q, want_q)


def test_sdpa_past_head_dim_256_takes_the_composition():
    """At head dim 320 JAX's router sends the call to its XLA composition;
    the port's takes its plain composition on every device, never the
    flash route (a spy counts its calls)."""
    rng = np.random.RandomState(2)
    b, s, h, kvh, d = 2, 64, 4, 2, 320
    q, k, v = _np(rng, b, s, h, d), _np(rng, b, s, kvh, d), _np(rng, b, s,
                                                                kvh, d)
    g = _np(rng, b, s, h, d)

    def sdpa(q_, k_, v_):
        return jax_nn.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

    def fwd_bwd(q_, k_, v_, g_):
        out, vjp = jax.vjp(sdpa, q_, k_, v_)
        return out, vjp(g_)

    want, want_grads = jax.jit(fwd_bwd)(*(jnp.asarray(a)
                                          for a in (q, k, v, g)))
    calls = []
    mp = pytest.MonkeyPatch()
    mp.setattr(nn_kernels, "flash_attention",
               lambda *a, **kw: calls.append(a) or fa.flash_attention(*a,
                                                                      **kw))
    try:
        ts = [_t(a, True) for a in (q, k, v)]
        got = nn_kernels.scaled_dot_product_attention(*ts, is_causal=True)
        got.backward(_t(g))
        # at 256 the same call takes the flash route
        x = _t(_np(rng, 1, 8, 2, 256))
        nn_kernels.scaled_dot_product_attention(x, x, x, is_causal=True)
    finally:
        mp.undo()
    assert len(calls) == 1 and calls[0][0].shape[-1] == 256
    _close(got, want)
    for a, w in zip(ts, want_grads):
        _close(a.grad, w)


# ------------------------------------------ a LLaMA with head_dim 96

CFG = dict(vocab_size=256, hidden_size=192, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
           max_position_embeddings=256)
ENGINE = dict(max_slots=2, max_len=64, page_size=16, prompt_buckets=(16,))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlamaForCausalLM(JaxLlamaConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                          dtype=torch.float32)
    assert tm.config.head_dim == 96
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}, tm)
    return jm, tm


def _ids(seed, shape=(2, 128)):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], shape).astype(np.int32)


def test_head_dim_96_llama_logits_match_jax(models):
    """S = 128, so JAX takes its Pallas flash kernel at head_dim 96."""
    jm, tm = models
    ids = _ids(0)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = tm(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _min_top2_gap(model, prompt, tokens):
    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits = model(torch.tensor(seq[None]))[0, prompt.size - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def test_head_dim_96_engine_streams_match_jax_engine(models):
    """Greedy streams of 3 requests on 2 slots: the port's unfused engine
    (``decode_megakernel=0``, the card's path at head_dim 96: paged decode
    at its own width) against the JAX engine's unfused decode program
    (``FLAGS_decode_megakernel=0``: its fusion pass fails on the installed
    jax, ROADMAP Queue 3)."""
    jm, tm = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, CFG["vocab_size"], (n,)).astype(np.int32)
               for n in (5, 13, 9)]
    flags = paddle.get_flags(["FLAGS_decode_megakernel"])
    paddle.set_flags({"FLAGS_decode_megakernel": 0})
    try:
        want, _ = JaxEngine(jm, **ENGINE).run(prompts, max_new_tokens=6,
                                              segment=3)
    finally:
        paddle.set_flags(flags)
    got, stats = ContinuousBatchingEngine(tm, decode_megakernel=0,
                                          **ENGINE).run(
        prompts, max_new_tokens=6, segment=3)
    assert stats["megakernel"] is False
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        assert _min_top2_gap(tm, prompts[i], g) > MIN_GAP, f"request {i}"


def test_head_dim_96_train_step_losses_match_jax(models):
    """Two AdamW steps of ``TrainStep`` on fresh copies of the weights,
    against the JAX ``TrainStep`` (compiled) on the same ids."""
    paddle.seed(0)
    jm = JaxLlamaForCausalLM(JaxLlamaConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                          dtype=torch.float32)
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}, tm)
    ids = _ids(2)
    jcrit = JaxCriterion()
    jstep = paddle.jit.TrainStep(
        jm, lambda logits, lab: jcrit(logits, lab),
        paddle.optimizer.AdamW(learning_rate=1e-3,
                               parameters=jm.parameters()))
    want = [float(jstep(paddle.to_tensor(ids), labels=paddle.to_tensor(ids)))
            for _ in range(2)]
    step = TrainStep(tm, LlamaPretrainingCriterion(),
                     AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    got = step.run(torch.tensor(ids), steps=2, labels=torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert want[1] < want[0]
