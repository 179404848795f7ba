"""float32 training through the port's backward kernels: the RMSNorm
backward, flash dK/dV and dQ, and the RoPE adjoint.

The JAX package trains its default (f32) LLaMA with Pallas backward
kernels that are generic in their dtype, so the port's backward kernels
have f32 instantiations on the card and its default model trains there.

On the CPU (where the port runs its kernels' plain versions): one decoder
layer at the 438M model's widths (hidden 1536, 12 heads of 128,
intermediate 4096; a one-layer model with a 256-token vocabulary around
it), batch 2 x seq 128, in f32 against JAX's: the
``LlamaPretrainingCriterion`` loss within 1e-5 relative and every
parameter's gradient within 1e-4 relative + 1e-7 absolute, as
tests/test_torch_train.py holds them (two f32 frameworks summing in other
orders). JAX runs eagerly through its Pallas RMSNorm, RoPE and flash
custom_vjps in interpret mode, each wrapped once in ``jax.jit``; spies
show that JAX's three backward kernels ran.

On the card (the ``cuda`` marker; skipped without one): the f32 RMSNorm
backward and flash dK/dV and dQ against their plain versions at the edge
shapes of tests/test_torch_cuda.py and tests/test_torch_head_dims.py
(head dims 32-256 and 80 padded, GQA, sq < sk and sq > sk causal, sq =
1, seq_lens, packed ids, a segment missing from the keys), within 1e-4 +
1e-4 |want| with TF32 off, each launch counted under ``<kernel>[f32]``;
and a small f32 LLaMA trained 3 steps through ``TrainStep`` on the card,
launching only the seven ``[f32]`` training kernels. These import neither JAX nor
``paddle_tpu``; run them without the repository's conftest where JAX is
missing::

    python -m pytest --noconftest -q -p no:cacheprovider -m cuda tests/test_torch_f32_train.py
"""
from collections import Counter

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaPretrainingCriterion,
)

# one decoder layer at the 438M widths (chip_smoke.py CFG_438M); the vocab
# is cut so that the head stays small
CFG = dict(vocab_size=256, hidden_size=1536, intermediate_size=4096,
           num_hidden_layers=1, num_attention_heads=12,
           max_position_embeddings=512)
BATCH, SEQ = 2, 128
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)
RTOL = ATOL = 1e-4  # the card cases: f32 kernel vs f32 plain version


@pytest.fixture(scope="module")
def jax_step():
    """The JAX model (seed 0), its loss and gradients of one criterion
    step on the batch, and the spies' counts, computed once. JAX's flash
    custom_vjp is rebuilt from its own forward rule and ``_bwd`` with
    counters and wrapped in ``jax.jit`` (its Pallas kernels lower once);
    the RMSNorm and RoPE backward kernels are counted where their
    custom_vjps call them, and their public functions wrapped in
    ``jax.jit`` as well. The functions computed are the JAX package's
    own."""
    import functools

    import jax

    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
    from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
    from paddle_tpu.ops.pallas import flash_attention as jfa
    from paddle_tpu.ops.pallas import fused_ops as jfo
    from paddle_tpu.ops.pallas import rms_norm as jrn

    calls = Counter()

    def counted(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    @functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6))
    def flash(q, k, v, q_seg, k_seg, causal, scale):
        return jfa._flash_fwd_rule(q, k, v, q_seg, k_seg, causal, scale)[0]

    flash.defvjp(counted("flash_fwd", jfa._flash_fwd_rule),
                 counted("flash_bwd", jfa._bwd))
    rope_apply = jfo._rope_apply

    def rope_counted(x, cos, sin, inverse):
        calls["rope_bwd" if inverse else "rope_fwd"] += 1
        return rope_apply(x, cos, sin, inverse)

    mp = pytest.MonkeyPatch()
    mp.setattr(jfa, "_flash_bhsd", jax.jit(flash, static_argnums=(5, 6)))
    mp.setattr(jfo, "_rope_apply", rope_counted)
    mp.setattr(jrn, "_bwd_call", counted("rms_norm_bwd", jrn._bwd_call))
    mp.setattr(jrn, "rms_norm", jax.jit(jrn.rms_norm, static_argnums=(3, 4)))
    mp.setattr(jfo, "_rope_one", jax.jit(jfo._rope_one))
    try:
        paddle.seed(0)
        jm = JaxLlamaForCausalLM(JaxLlamaConfig(**CFG))
        ids = _ids()
        jm.clear_gradients()
        loss = JaxCriterion()(jm(paddle.to_tensor(ids)),
                              paddle.to_tensor(ids))
        loss.backward()
        grads = {k: np.asarray(p.grad._value)
                 for k, p in jm.named_parameters()}
        params = {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}
    finally:
        mp.undo()
    return params, float(loss), grads, dict(calls)


def _ids():
    return np.random.RandomState(4).randint(
        0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def test_layer_at_438m_widths_trains_as_jax_in_f32(jax_step):
    """The f32 loss and every parameter's gradient of one criterion step
    against JAX's, which ran its Pallas RMSNorm, RoPE and flash backward
    kernels (each spy called at least once; JAX's tape may build one
    backward program for several calls of the same shape)."""
    from paddle_tpu_torch.models import params_from_paddle_tpu

    params, want_loss, want_grads, calls = jax_step
    for key in ("flash_fwd", "flash_bwd", "rms_norm_bwd", "rope_fwd",
                "rope_bwd"):
        assert calls.get(key, 0) >= 1, calls
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    params_from_paddle_tpu(params, tm)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    ids = torch.tensor(_ids())
    loss = LlamaPretrainingCriterion()(tm(ids), ids)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    names = dict(tm.named_parameters())
    assert set(names) == set(want_grads)
    for k, p in names.items():
        assert p.grad.dtype == torch.float32
        assert np.abs(want_grads[k]).max() > 0, k
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k], **GRAD_TOL,
                                   err_msg=k)


# ------------------------------------------------------------ on the card

@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


def _close(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,aligned", [(1, 64, True), (8, 1536, True),
                                         (6144, 1536, True),
                                         (37, 1000, False),
                                         (4, 16384, True)])
def test_f32_rms_norm_bwd_kernel(gen, n, d, aligned):
    """dx, dw and db: the vector kernel (D a multiple of 4, aligned; D up
    to 16384) and the one-value kernel (x, g and dx off 16-byte
    alignment)."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    def rows():
        return (_randn(gen, n * d + 1)[1:].view(n, d) if not aligned
                else _randn(gen, n, d))

    x, g = rows(), rows()
    w = 1.0 + 0.1 * _randn(gen, d)
    _, r = rn.rms_norm_plain(x, w, epsilon=1e-6)
    launch_counts.clear()
    got = rn.rms_norm_bwd(x, w, r, g)
    assert dict(launch_counts) == {"rms_norm_bwd[f32]": 1}
    for a, want in zip(got, rn.rms_norm_bwd_plain(x, w, r, g)):
        _close(a, want)


def _segment_ids(kind, b, sq, sk):
    """``seq_lens`` (padding -1), ``packed`` documents of 1-40 tokens
    (shared, sq == sk), or a ``pair`` whose query segment 3 has no key."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    rng = np.random.RandomState(sq + sk)
    if kind == "seq_lens":
        return fa.build_segments(b, sq, sk, rng.randint(1, sk + 1, b),
                                 device="cuda")
    if kind == "packed":
        ids = np.empty((b, sq), np.int32)
        for i in range(b):
            pos, doc = 0, 0
            while pos < sq:
                n = rng.randint(1, 41)
                ids[i, pos:pos + n] = doc
                pos, doc = pos + n, doc + 1
        t = torch.tensor(ids, device="cuda")
        return t, t
    q = np.sort(rng.randint(0, 5, (b, sq)), 1)
    k = np.sort(rng.randint(0, 5, (b, sk)), 1)
    k[k == 3] = 4
    return (torch.tensor(q, dtype=torch.int32, device="cuda"),
            torch.tensor(k, dtype=torch.int32, device="cuda"))


FLASH_BWD_CASES = [  # (b, sq, sk, h, kvh, d, causal, segments)
    (1, 100, 100, 8, 4, 64, True, None),      # GQA group 2, ragged tiles
    (2, 70, 70, 16, 2, 128, True, None),      # group 8
    (2, 5, 70, 16, 2, 128, True, None),       # causal offset sk - sq
    (1, 70, 40, 8, 2, 128, True, None),       # sq > sk: rows see no key
    (1, 33, 17, 4, 4, 64, False, None),       # sq > sk, non-causal
    (1, 150, 150, 12, 12, 128, True, None),   # MHA, three tiles
    (2, 70, 70, 8, 8, 96, True, None),        # Phi-3's head dim
    (1, 100, 100, 4, 2, 256, True, None),     # 32-row tiles
    (2, 5, 70, 8, 2, 256, True, None),
    (1, 33, 17, 4, 4, 32, False, None),
    (1, 50, 50, 8, 2, 80, True, None),        # the padded route (to 96)
    (3, 1, 40, 8, 2, 128, True, None),        # sq = 1, a decode row
    (2, 64, 64, 12, 12, 128, False, None),    # BERT-like, whole tiles
    (1, 100, 100, 8, 4, 64, True, "seq_lens"),
    (1, 150, 150, 12, 12, 128, True, "packed"),
    (2, 96, 160, 8, 2, 128, True, "pair"),    # cross: a segment w/o keys
    (1, 70, 70, 4, 2, 256, True, "packed"),
    (1, 50, 50, 8, 2, 80, True, "seq_lens"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal,segments", FLASH_BWD_CASES)
def test_f32_flash_attention_bwd_kernels(gen, b, sq, sk, h, kvh, d, causal,
                                         segments):
    """dQ, dK and dV from the f32 forward's out and lse against the plain
    version; each kernel launched once under its ``[seg]``/``[pad]``
    ``[f32]`` name."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts

    q_seg, k_seg = ((None, None) if segments is None
                    else _segment_ids(segments, b, sq, sk))
    q, do = _randn(gen, b, sq, h, d), _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, sk, kvh, d), _randn(gen, b, sk, kvh, d)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, q_seg, k_seg)
    launch_counts.clear()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, q_seg, k_seg)
    tag = (("" if segments is None else "[seg]")
           + ("" if d in fa.HEAD_DIMS else "[pad]") + "[f32]")
    assert dict(launch_counts) == {"flash_attention_bwd_dkdv" + tag: 1,
                                   "flash_attention_bwd_dq" + tag: 1}
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, q_seg,
                                        k_seg)
    for a, w in zip(got, want):
        _close(a, w)


F32_TRAIN_KERNELS = ("rms_norm", "rms_norm_bwd", "fused_rope",
                     "fused_rope_bwd", "flash_attention",
                     "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


@pytest.mark.cuda
def test_f32_llama_trains_on_card_through_the_f32_kernels(gen):
    """A small LLaMA in f32 (the default dtype), 3 ``TrainStep`` steps of
    AdamW on the card: finite, falling losses, and every launch one of the
    seven training kernels' ``[f32]`` forms, each at its count a step
    (RMSNorm 2 L + 1 each way, the others L)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      max_position_embeddings=256)
    model = LlamaForCausalLM(cfg, generator=seed(0, "cuda"))
    assert model.dtype == torch.float32
    step = TrainStep(model, LlamaPretrainingCriterion(),
                     AdamW(learning_rate=1e-3, parameters=model.parameters(),
                           multi_precision=True))
    ids = torch.tensor(np.random.RandomState(0).randint(0, 512, (2, 192)),
                       device="cuda")
    launch_counts.clear()
    losses = [float(step(ids, labels=ids))]
    counts = dict(launch_counts)
    losses += [float(x) for x in step.run(ids, steps=2, labels=ids)]
    layers = cfg.num_hidden_layers
    want = {k + "[f32]": layers for k in F32_TRAIN_KERNELS}
    want["rms_norm[f32]"] = want["rms_norm_bwd[f32]"] = 2 * layers + 1
    assert counts == want
    assert all(np.isfinite(losses)) and losses[2] < losses[0], losses
