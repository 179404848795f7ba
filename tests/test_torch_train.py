"""The port's training slice against the JAX package's.

A tiny LLaMA that reaches the JAX Pallas kernels (vocab 128, hidden 128,
intermediate 256, 2 layers, 2 heads of head_dim 64 on 1 kv head; batch 2,
seq 128, a multiple of the flash block) is built by ``paddle_tpu`` from a
seed and carried into the port with ``params_from_paddle_tpu``. Both run
in f32 on the CPU: the JAX side eagerly, through its Pallas custom_vjps
in interpret mode (``FLAGS_use_pallas_kernels`` is on by default), or
through its compiled ``jit.TrainStep``; the port through its kernels'
plain versions.

Tolerances: losses 1e-5 relative and gradients 1e-4 relative + 1e-7
absolute (two f32 frameworks summing in different orders; they agree to
~1e-6 relative). After AdamW steps the parameters are held to 1e-4
absolute, a tenth of the learning rate: Adam divides each gradient by its
own running magnitude, so an element whose gradient is near zero can turn
f32 noise into an update of up to lr, while every other element agrees to
~1e-7 (the run here differs by at most ~2e-5).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models import (
    LlamaPretrainingCriterion as JaxCriterion,
)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    LlamaPretrainingCriterion,
    PagedKVCache,
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


CFG = dict(vocab_size=128, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
           max_position_embeddings=128)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)


@pytest.fixture(scope="module", autouse=True)
def _jax_pallas_jitted():
    """JAX's Pallas flash, RMSNorm and RoPE functions each wrapped once in
    ``jax.jit`` for this module's tests: its eager autograd otherwise
    lowers an interpret-mode Pallas call anew at every call. The flash
    custom_vjp is rebuilt from JAX's own forward rule and ``_bwd``, as
    tests/test_torch_f32_train.py does; the functions computed are the JAX
    package's own."""
    import functools

    import jax

    from paddle_tpu.ops.pallas import flash_attention as jfa
    from paddle_tpu.ops.pallas import fused_ops as jfo
    from paddle_tpu.ops.pallas import rms_norm as jrn

    @functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6))
    def flash(q, k, v, q_seg, k_seg, causal, scale):
        return jfa._flash_fwd_rule(q, k, v, q_seg, k_seg, causal, scale)[0]

    flash.defvjp(jfa._flash_fwd_rule, jfa._bwd)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfa, "_flash_bhsd", jax.jit(flash, static_argnums=(5, 6)))
        mp.setattr(jrn, "rms_norm", jax.jit(jrn.rms_norm,
                                            static_argnums=(3, 4)))
        mp.setattr(jfo, "_rope_one", jax.jit(jfo._rope_one))
        yield


def _pair(**over):
    paddle.seed(0)
    jm = JaxLlamaForCausalLM(JaxLlamaConfig(**CFG, **over))
    tm = LlamaForCausalLM(LlamaConfig(**CFG, **over), device="cpu",
                          dtype=torch.float32)
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}, tm)
    return jm, tm


def _ids(seed=0):
    return np.random.RandomState(seed).randint(0, 128, (2, 128)).astype(
        np.int32)


def _jax_grads(jm):
    return {k: np.asarray(p.grad._value) for k, p in jm.named_parameters()}


def _check_grads(tm, want):
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k], **GRAD_TOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def criterion_step(models):
    """Loss and gradients of one criterion step on both sides."""
    jm, tm = models
    ids = _ids()
    jm.clear_gradients()
    jl = JaxCriterion()(jm(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    jl.backward()
    tm.zero_grad()
    tl = LlamaPretrainingCriterion()(tm(torch.tensor(ids)),
                                     torch.tensor(ids))
    tl.backward()
    got = {k: p.grad.clone() for k, p in tm.named_parameters()}
    return float(jl), _jax_grads(jm), tl.detach(), got


def test_criterion_loss_and_gradients_match_jax(models, criterion_step):
    _, tm = models
    jl, jgrads, tl, _ = criterion_step
    np.testing.assert_allclose(float(tl), jl, rtol=1e-5)
    _check_grads(tm, jgrads)
    assert all(np.abs(g).max() > 0 for g in jgrads.values())


def test_labels_loss_and_gradients_match_jax_and_criterion(models,
                                                           criterion_step):
    jm, tm = models
    ids = _ids()
    jm.clear_gradients()
    jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jl.backward()
    tm.zero_grad()
    tl = tm(torch.tensor(ids), labels=torch.tensor(ids))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _check_grads(tm, _jax_grads(jm))
    # and the port's own criterion path over materialised logits
    _, _, crit_loss, crit_grads = criterion_step
    np.testing.assert_allclose(float(tl.detach()), float(crit_loss), rtol=1e-5)
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), crit_grads[k].numpy(),
                                   **GRAD_TOL, err_msg=k)


def test_tied_embeddings_labels_path_matches_jax():
    jm, tm = _pair(tie_word_embeddings=True)
    ids = _ids(1)
    jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jl.backward()
    tl = tm(torch.tensor(ids), labels=torch.tensor(ids))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _check_grads(tm, _jax_grads(jm))


def test_labels_with_caches_raise(models):
    _, tm = models
    caches = [PagedKVCache(1, 16, 1, 64, page_size=16, device="cpu",
                           dtype=torch.float32) for _ in range(2)]
    with pytest.raises(ValueError, match="training-path"):
        tm(torch.zeros((1, 4), dtype=torch.long), caches=caches,
           labels=torch.zeros((1, 4), dtype=torch.long))
    assert caches[0].length == 0


def test_adamw_train_step_trajectory_matches_jax_train_step():
    jm, tm = _pair()
    ids = _ids(2)
    jcrit = JaxCriterion()
    jstep = paddle.jit.TrainStep(
        jm, lambda logits, lab: jcrit(logits, lab),
        paddle.optimizer.AdamW(learning_rate=1e-3,
                               parameters=jm.parameters()))
    want = [float(jstep(paddle.to_tensor(ids), labels=paddle.to_tensor(ids)))
            for _ in range(3)]
    step = TrainStep(tm, LlamaPretrainingCriterion(),
                     AdamW(learning_rate=1e-3, parameters=tm.parameters()))
    got = step.run(torch.tensor(ids), steps=3, labels=torch.tensor(ids))
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert want[2] < want[0]
    jp = {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[k], rtol=0,
                                   atol=1e-4, err_msg=k)
        assert p.grad is None  # the step clears them


def test_adamw_multi_precision_matches_jax():
    """bf16 parameters with f32 masters and moments, two steps (bias
    correction at t = 1 and 2), one parameter exempt from decay: the
    masters (|w| < 4) agree to within a few f32 ulps (1e-6 absolute; the
    two frameworks round the update's terms in different orders) and the
    bf16 parameters, their casts, exactly."""
    from paddle_tpu.core.tensor import Parameter

    rng = np.random.RandomState(3)
    shapes = [(8, 16), (16,), (4, 4)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    jps = [Parameter(paddle.to_tensor(w).astype("bfloat16")._value)
           for w in init]
    names = {jp.name: str(i) for i, jp in enumerate(jps)}
    jopt = paddle.optimizer.AdamW(
        learning_rate=0.05, parameters=jps, multi_precision=True,
        weight_decay=0.1, apply_decay_param_fun=lambda n: names[n] != "1")
    tps = [torch.nn.Parameter(torch.tensor(w).bfloat16()) for w in init]
    topt = AdamW(learning_rate=0.05, multi_precision=True, weight_decay=0.1,
                 parameters=[(f"w{i}", p) for i, p in enumerate(tps)],
                 apply_decay_param_fun=lambda n: n != "w1")
    for gs in grads:
        for jp, tp, g in zip(jps, tps, gs):
            jp.grad = paddle.to_tensor(g).astype("bfloat16")._value
            tp.grad = torch.tensor(g).bfloat16()
        jopt.step()
        topt.step()
    for i, (jp, tp) in enumerate(zip(jps, tps)):
        master = np.asarray(jopt._master_weights[jopt._master_key(jp)])
        assert topt._master_weights[i].dtype == torch.float32
        np.testing.assert_allclose(topt._master_weights[i].numpy(), master,
                                   rtol=0, atol=1e-6)
        assert tp.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp.detach().float().numpy(),
            np.asarray(jp._value.astype(np.float32)))


def test_recompute_is_bit_for_bit_and_matches_jax_recompute():
    """``use_recompute=True`` checkpoints each decoder layer: the port's
    labels loss and every gradient equal its own run without recompute bit
    for bit (the backward reruns the same forward), and JAX's recompute
    model's within GRAD_TOL; under ``no_grad`` the layers just run."""
    jm, tm = _pair(use_recompute=True)
    plain = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                             dtype=torch.float32)
    plain.load_state_dict(tm.state_dict())
    ids = _ids(4)
    jl = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jl.backward()
    losses = []
    for model in (tm, plain):
        loss = model(torch.tensor(ids), labels=torch.tensor(ids))
        loss.backward()
        losses.append(loss.detach())
    assert tm.config.use_recompute and not plain.config.use_recompute
    assert torch.equal(losses[0], losses[1])
    again = dict(plain.named_parameters())
    for k, p in tm.named_parameters():
        assert torch.equal(p.grad, again[k].grad), k
    np.testing.assert_allclose(float(losses[0]), float(jl), rtol=1e-5)
    _check_grads(tm, _jax_grads(jm))
    with torch.no_grad():
        assert torch.equal(tm(torch.tensor(ids)), plain(torch.tensor(ids)))
