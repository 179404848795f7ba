"""The port's BERT against the JAX package's.

``bert_tiny_config(max_position_embeddings=128)`` (vocab 256, hidden 64,
2 post-LN layers of 4 heads of 16, intermediate 128, dropout 0) is built
by ``paddle_tpu`` from a seed and carried into the port with
``params_from_paddle_tpu``; batch 2 x seq 128, so that the JAX attention
takes its Pallas flash kernels (in interpret mode) and the port's its
flash kernels' plain versions. Ids and labels come from
``np.random.RandomState``; everything is f32 on the CPU.

Tolerances: logits and losses 1e-4 relative (+1e-5 absolute for logits
near 0); gradients 1e-3 relative + 1e-5 absolute, and parameters after
three AdamW steps 1e-3 absolute (f32 sums in other orders; the parameters
agree to ~1e-6). One slice is held to 6 * lr instead: the key third of
each ``qkv_proj.bias``. Its gradient is zero in exact arithmetic (a bias
on every key adds the same q . b to each of a row's scores, which the
softmax cancels), so both sides see f32 noise there, and Adam, dividing
by the noise's own magnitude, turns it into steps of up to ~lr each of
either sign: at most 2 * 3 * lr apart after three steps.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jax_bert
from paddle_tpu.nn.layer_base import LazyGuard
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    BertForPretraining,
    BertForSequenceClassification,
    BertPretrainingCriterion,
    bert_base_config,
    bert_tiny_config,
    params_from_paddle_tpu,
)
from paddle_tpu_torch.optimizer import AdamW


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


LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
TINY = dict(max_position_embeddings=128)


@pytest.fixture(autouse=True, scope="module")
def _jax_flash_lowered_once():
    """The JAX eager autograd traces the Pallas flash kernels anew at each
    call, and in interpret mode lowers them again (~1 s); one ``jax.jit``
    around the same custom_vjp function lowers them once per shape. The
    function computed is the JAX package's own."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_fa, "_flash_bhsd",
               jax.jit(jax_fa._flash_bhsd, static_argnums=(5, 6)))
    yield
    mp.undo()


def _pair(jax_cls, port_cls, **kw):
    paddle.seed(0)
    jm = jax_cls(jax_bert.bert_tiny_config(**TINY), **kw)
    tm = port_cls(bert_tiny_config(**TINY), **kw, device="cpu")
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}, tm)
    return jm, tm


def _batch(seed):
    """ids and MLM labels (2, 128), a quarter of the labels -100; NSP
    labels (2, 1)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 256, (2, 128))
    mlm = np.where(rng.rand(2, 128) < 0.25, -100, rng.randint(0, 256,
                                                             (2, 128)))
    return ids, mlm, rng.randint(0, 2, (2, 1))


@pytest.fixture(scope="module")
def pretraining():
    """Logits, loss and gradients of one criterion step on both sides;
    the JAX side compiled whole (``to_static``), which gives a parameter
    that the loss never reads a zero gradient."""
    jm, tm = _pair(jax_bert.BertForPretraining, BertForPretraining)
    ids, mlm, nsp = _batch(0)
    jcrit = jax_bert.BertPretrainingCriterion()

    def jax_step(ids, mlm, nsp):
        jmlm, jnsp = jm(ids)
        return jcrit(jmlm, jnsp, mlm, nsp), jmlm, jnsp

    jl, jmlm, jnsp = paddle.jit.to_static(jax_step)(
        *(paddle.to_tensor(a) for a in (ids, mlm, nsp)))
    jl.backward()
    tmlm, tnsp = tm(torch.tensor(ids))
    tl = BertPretrainingCriterion()(tmlm, tnsp, torch.tensor(mlm),
                                    torch.tensor(nsp))
    tl.backward()
    want = dict(mlm=np.asarray(jmlm._value), nsp=np.asarray(jnsp._value),
                loss=float(jl),
                grads={k: np.asarray(p.grad._value)
                       for k, p in jm.named_parameters()})
    got = dict(mlm=tmlm.detach().numpy(), nsp=tnsp.detach().numpy(),
               loss=float(tl.detach()),
               grads={k: p.grad for k, p in tm.named_parameters()})
    return want, got


@pytest.mark.parametrize("head", ["mlm", "nsp"])
def test_pretraining_logits_match_jax(pretraining, head):
    want, got = pretraining
    assert got[head].shape == want[head].shape
    np.testing.assert_allclose(got[head], want[head], **LOGIT_TOL)


def test_pretraining_loss_matches_jax(pretraining):
    want, got = pretraining
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)


def test_pretraining_gradients_match_jax(pretraining):
    """Every parameter's step-1 gradient. The ones whose JAX gradient is
    exactly zero (``pre_ln`` in post-LN mode, the token-type table
    without token-type ids: the loss never reads them) are the ones the
    port's autograd leaves None."""
    want, got = pretraining
    unused = sorted(k for k, g in want["grads"].items() if not g.any())
    assert unused == sorted(k for k, g in got["grads"].items() if g is None)
    assert any("pre_ln" in k for k in unused)
    assert "bert.embeddings.token_type_embeddings.weight" in unused
    for k, g in got["grads"].items():
        if g is not None:
            np.testing.assert_allclose(g.numpy(), want["grads"][k],
                                       **GRAD_TOL, err_msg=k)


def test_adamw_train_step_trajectory_matches_jax_train_step():
    """Three AdamW(multi_precision=True) steps of each side's TrainStep:
    the losses and every parameter after them, including the ones the
    loss never reads, which JAX's value_and_grad gives a zero gradient
    (moments advance, decay applies), held tighter than the rest."""
    jm, tm = _pair(jax_bert.BertForPretraining, BertForPretraining)
    ids, mlm, nsp = _batch(1)
    jcrit = jax_bert.BertPretrainingCriterion()
    jstep = paddle.jit.TrainStep(
        jm, lambda a, b, lab: jcrit(a, b, lab[0], lab[1]),
        paddle.optimizer.AdamW(learning_rate=1e-3, multi_precision=True,
                               parameters=jm.parameters()))
    want = [float(jstep(paddle.to_tensor(ids), labels=(
        paddle.to_tensor(mlm), paddle.to_tensor(nsp)))) for _ in range(3)]
    crit = BertPretrainingCriterion()
    step = TrainStep(tm, lambda a, b, lab: crit(a, b, *lab),
                     AdamW(learning_rate=1e-3, multi_precision=True,
                           parameters=tm.parameters()))
    before = {k: p.detach().numpy().copy() for k, p in tm.named_parameters()}
    got = step.run(torch.tensor(ids), steps=3,
                   labels=(torch.tensor(mlm), torch.tensor(nsp)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    assert want[2] < want[0]
    jp = {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}
    # The parameters the loss never reads move by decay alone: three
    # factors of 1 - lr * 0.01 = 1 - 1e-5, held at 1e-6 relative (a few
    # f32 ulps), thirty times finer than the 3e-5 that a step which skips
    # them would leave.
    unused = [k for k in jp if "pre_ln" in k or "token_type" in k]
    assert len(unused) == 2 * tm.config.num_hidden_layers + 1
    for k in unused:
        decayed = before[k] * (1.0 - 1e-3 * 0.01) ** 3
        np.testing.assert_allclose(jp[k], decayed, rtol=1e-6, atol=0,
                                   err_msg=k)
        np.testing.assert_allclose(dict(tm.named_parameters())[k].detach()
                                   .numpy(), decayed, rtol=1e-6, atol=0,
                                   err_msg=k)
    hidden = tm.config.hidden_size
    for k, p in tm.named_parameters():
        got_k, want_k = p.detach().numpy(), jp[k]
        if k.endswith("qkv_proj.bias"):
            key = slice(hidden, 2 * hidden)
            np.testing.assert_allclose(got_k[key], want_k[key], rtol=0,
                                       atol=6e-3, err_msg=k)
            got_k, want_k = np.delete(got_k, key), np.delete(want_k, key)
        np.testing.assert_allclose(got_k, want_k, rtol=0, atol=1e-3,
                                   err_msg=k)


def test_sequence_classification_with_types_and_mask_matches_jax():
    """S = 16 with token-type ids and a padding mask: the additive-mask
    composition route on both sides."""
    jm, tm = _pair(jax_bert.BertForSequenceClassification,
                   BertForSequenceClassification, num_classes=3)
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 256, (2, 16))
    types = (np.arange(16) >= 9).astype(np.int64)[None].repeat(2, 0)
    mask = np.ones((2, 16), np.int64)
    mask[1, 11:] = 0
    want = paddle.jit.to_static(jm)(
        paddle.to_tensor(ids), token_type_ids=paddle.to_tensor(types),
        attention_mask=paddle.to_tensor(mask))
    got = tm(torch.tensor(ids), token_type_ids=torch.tensor(types),
             attention_mask=torch.tensor(mask))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want._value),
                               **LOGIT_TOL)


def test_base_config_names_and_shapes_match_jax():
    """BERT-base: every name and shape of the JAX model, whose parameters
    stay unmaterialised (LazyGuard), against the port's on the meta
    device."""
    with LazyGuard():
        jm = jax_bert.BertForPretraining(jax_bert.bert_base_config())
    want = {k: tuple(p._lazy_init[1]) for k, p in jm.named_parameters()}
    tm = BertForPretraining(bert_base_config(), device="meta",
                            generator=torch.Generator())
    got = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) > 109e6
