"""The port's optimizer surface against the JAX package's.

``optimizer.AdamW`` and ``Adam`` with JAX's whole surface (schedules,
clips, parameter groups, coupled and decoupled decay, ``acc_dtype``, the
state dict) over the tiny LLaMA of tests/test_torch_train.py (vocab 128,
hidden 128, 2 layers, 2 heads of 64 on 1 kv head; batch 2, seq 128), built
by ``paddle_tpu`` from a seed and carried into the port. Both run in f32 on
the CPU: JAX through its compiled ``jit.TrainStep`` (two compiles in this
file) with its Pallas functions jitted once for the module, the port through
its ``TrainStep`` and the update's plain version
(``ops/cuda/multi_tensor_adam.py``), which every CPU tensor takes.

Tolerances: losses 1e-5 relative; parameters 1e-4 absolute, a tenth of
the learning rate (tests/test_torch_train.py says why: an element whose
gradient is f32 noise can move by up to lr); the moments, sums of the
gradients (which agree to 1e-4 relative + 1e-7) and of their squares,
1e-3 relative + 1e-7 (moment1) and 1e-9 (moment2) absolute. Where both
sides take the same numpy gradients (the ``acc_dtype`` case) the update
is held to 1e-6 relative and the stored bf16 moment1 bit for bit. The
schedulers, pure Python on both sides, agree exactly; the clips on numpy
gradients to 1e-6 relative (f32 norms summed in other orders).
"""
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (
    LlamaConfig,
    LlamaForCausalLM,
    params_from_paddle_tpu,
)
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.optimizer import lr as tlr


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
LOSS = dict(rtol=1e-5)
PARAM = dict(rtol=0, atol=1e-4)
MOMENT = {"moment1": dict(rtol=1e-3, atol=1e-7),
          "moment2": dict(rtol=1e-3, atol=1e-9)}
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def _jax_pallas_jitted():
    """JAX's Pallas flash, RMSNorm and RoPE functions each wrapped once in
    ``jax.jit`` for this module, as tests/test_torch_train.py does; the
    functions computed are the JAX package's own."""
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


def _jax_model():
    paddle.seed(0)
    return JaxLlamaForCausalLM(JaxLlamaConfig(**CFG))


def _port_model(np_params):
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                          dtype=torch.float32)
    return params_from_paddle_tpu(np_params, tm)


def _np_params(jm):
    return {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}


def _ids():
    return np.random.RandomState(2).randint(0, 128, (2, 128)).astype(
        np.int32)


def _decays(name):
    """apply_decay_param_fun of case (a): no decay on the q projections."""
    return "q_proj" not in name


def _groups(named, lr_mult_key="norm"):
    """Two parameter groups: the norms (at half the learning rate, no decay
    and a clip of their own) and the rest."""
    rest = [(k, p) for k, p in named if lr_mult_key not in k]
    norms = [(k, p) for k, p in named if lr_mult_key in k]
    return rest, norms


def _schedule(lr_mod):
    return lr_mod.LinearWarmup(
        lr_mod.CosineAnnealingDecay(2e-3, T_max=6), warmup_steps=2,
        start_lr=5e-4, end_lr=2e-3)


def _jax_state(step):
    return {k: (v if isinstance(v, int) else np.asarray(v))
            for k, v in step.state_dict().items()}


@pytest.fixture(scope="module")
def jax_adamw_run():
    """JAX's TrainStep, case (a): AdamW over two groups with a warm-up into
    a cosine schedule stepped each step, a global-norm clip that bites in
    each group (the optimizer's, and the norms' group's own) and an
    exemption by name, labels passed positionally (bench.py's call).
    Returns the initial parameters, the losses, the parameters and state
    dict after 2 and after 4 steps, and the schedule's state after 2."""
    jm = _jax_model()
    init = _np_params(jm)
    by_name = {p.name: k for k, p in jm.named_parameters()}
    rest, norms = _groups(list(jm.named_parameters()))
    sched = _schedule(paddle.optimizer.lr)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched,
        parameters=[{"params": [p for _, p in rest]},
                    {"params": [p for _, p in norms], "learning_rate": 0.5,
                     "weight_decay": 0.0,
                     "grad_clip": paddle.nn.ClipGradByGlobalNorm(1e-3)}],
        grad_clip=paddle.nn.ClipGradByGlobalNorm(0.05),
        apply_decay_param_fun=lambda n: _decays(by_name[n]))
    step = paddle.jit.TrainStep(jm, lambda loss: loss, opt)
    ids = paddle.to_tensor(_ids())
    losses, at2 = [], None
    for k in range(STEPS):
        losses.append(float(step(ids, None, None, ids)))
        sched.step()
        if k == 1:
            at2 = (_np_params(jm), _jax_state(step), sched.state_dict())
    return init, losses, at2, (_np_params(jm), _jax_state(step))


def _port_adamw(tm):
    named = list(tm.named_parameters())
    rest, norms = _groups(named)
    sched = _schedule(tlr)
    opt = AdamW(learning_rate=sched,
                parameters=[{"params": rest},
                            {"params": norms, "learning_rate": 0.5,
                             "weight_decay": 0.0,
                             "grad_clip": tnn.ClipGradByGlobalNorm(1e-3)}],
                grad_clip=tnn.ClipGradByGlobalNorm(0.05),
                apply_decay_param_fun=_decays)
    return opt, sched, TrainStep(tm, lambda loss: loss, opt)


def _check(tm, step, want_params, want_state):
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[k],
                                   **PARAM, err_msg=k)
    got = step.state_dict()
    assert sorted(got) == sorted(want_state)
    assert got["@step_count"] == want_state["@step_count"]
    for key, v in got.items():
        if key != "@step_count":
            np.testing.assert_allclose(v.numpy(), want_state[key],
                                       **MOMENT[key.split("@")[0]],
                                       err_msg=key)


def test_adamw_schedule_clip_groups_match_jax_train_step(jax_adamw_run):
    """(a) Four steps: losses, parameters and both moments of every
    parameter against JAX's TrainStep."""
    init, want_losses, _, (want_params, want_state) = jax_adamw_run
    tm = _port_model(init)
    opt, sched, step = _port_adamw(tm)
    ids = torch.tensor(_ids())
    losses = []
    for _ in range(STEPS):
        losses.append(float(step(ids, None, None, ids)))
        sched.step()
        # the clip bit: each group's scale in the update's state is < 1
        scales = opt._state_bufs[torch.device("cpu")][2:4]
        assert (scales < 1).all(), scales
    np.testing.assert_allclose(losses, want_losses, **LOSS)
    assert losses[-1] < losses[0]
    _check(tm, step, want_params, want_state)


def test_jax_state_dict_resumes_the_same_trajectory(jax_adamw_run):
    """(d) JAX's TrainStep state dict after 2 steps (numpy arrays) and its
    schedule's state, loaded into a fresh port model, optimizer and
    schedule with JAX's parameters at step 2; 2 more steps give JAX's
    4-step run."""
    _, want_losses, (params2, state2, sched2), final = jax_adamw_run
    tm = _port_model(params2)
    _, sched, step = _port_adamw(tm)
    sched.set_state_dict(dict(sched2))
    step.set_state_dict(state2)
    ids = torch.tensor(_ids())
    losses = []
    for _ in range(2):
        losses.append(float(step(ids, None, None, ids)))
        sched.step()
    np.testing.assert_allclose(losses, want_losses[2:], **LOSS)
    _check(tm, step, *final)


def test_adam_coupled_decay_and_norm_clip_match_jax_train_step():
    """(b) Adam with coupled L2 weight_decay and a per-tensor norm clip, 3
    steps, the criterion over logits: losses, parameters, moments."""
    from paddle_tpu.models import LlamaPretrainingCriterion as JaxCriterion
    from paddle_tpu_torch.models import LlamaPretrainingCriterion

    jm = _jax_model()
    tm = _port_model(_np_params(jm))
    jcrit = JaxCriterion()
    jstep = paddle.jit.TrainStep(
        jm, lambda logits, lab: jcrit(logits, lab),
        paddle.optimizer.Adam(learning_rate=1e-3, parameters=jm.parameters(),
                              weight_decay=0.05,
                              grad_clip=paddle.nn.ClipGradByNorm(0.02)))
    ids = _ids()
    want = [float(jstep(paddle.to_tensor(ids), labels=paddle.to_tensor(ids)))
            for _ in range(3)]
    opt = Adam(learning_rate=1e-3, parameters=tm.parameters(),
               weight_decay=0.05, grad_clip=tnn.ClipGradByNorm(0.02))
    step = TrainStep(tm, LlamaPretrainingCriterion(), opt)
    got = step.run(torch.tensor(ids), steps=3, labels=torch.tensor(ids))
    np.testing.assert_allclose(got.numpy(), want, **LOSS)
    n = len(list(tm.parameters()))  # one scale a tensor
    assert (opt._state_bufs[torch.device("cpu")][2:2 + n] < 1).any()
    _check(tm, step, _np_params(jm), _jax_state(jstep))


def _f64_adamw(w, g, m, v, t, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    """One AdamW step in f64 numpy from (w, m, v), its constants rounded to
    f32 as JAX casts them into the work dtype; moment1's store rounded to
    bf16."""
    lr, wd, b1, b2, eps = (float(np.float32(x)) for x in (lr, wd, b1, b2,
                                                          eps))
    w = w * (1 - lr * wd)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    w = w - lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t)) + eps)
    return w, torch.tensor(m).bfloat16().double().numpy(), v


def test_acc_dtype_narrows_moment1_only():
    """(c) ``acc_dtype="bfloat16"`` on f32 parameters, three AdamW steps on
    the same numpy gradients as JAX's eager optimizer: step 1's parameters
    equal JAX's run without ``acc_dtype`` (the update computes before any
    store) within 1e-6 relative (XLA orders the f32 update's operations
    its own way: ~18% of the elements a ulp apart) and its bf16 moment1 has
    the bits of JAX's ``acc_dtype`` moment1; moment2 stays f32. Each step is held to the f64 rule applied
    to the port's own state before it (moment1 as stored): parameters and
    moment2 to 1e-6 relative (f32 against f64), moment1 within one bf16
    ulp (the f32 and f64 sums may round to neighbouring bf16 values).
    JAX narrows moment2 too, a defect of the reference."""
    from paddle_tpu.core.tensor import Parameter

    rng = np.random.RandomState(5)
    shapes = [(64, 48), (48,), (7, 5)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    lr, wd = 0.01, 0.1

    def jax_step(acc):
        ps = [Parameter(paddle.to_tensor(w)._value) for w in init]
        opt = paddle.optimizer.AdamW(learning_rate=lr, parameters=ps,
                                     weight_decay=wd, acc_dtype=acc)
        for p, g in zip(ps, grads[0]):
            p.grad = paddle.to_tensor(g)._value
        opt.step()
        return ps, opt

    plain_ps, _ = jax_step(None)
    acc_ps, acc_opt = jax_step("bfloat16")
    tps = [torch.nn.Parameter(torch.tensor(w)) for w in init]
    opt = AdamW(learning_rate=lr, parameters=tps, weight_decay=wd,
                acc_dtype="bfloat16")

    def state(i):
        return [t.detach().double().numpy().copy() for t in (
            tps[i], opt._accumulators[f"moment1@{i}"],
            opt._accumulators[f"moment2@{i}"])]

    for t, gs in enumerate(grads, start=1):
        before = ([(w.astype(np.float64), 0.0, 0.0) for w in init] if t == 1
                  else [state(i) for i in range(len(tps))])
        for p, g in zip(tps, gs):
            p.grad = torch.tensor(g)
        opt.step()
        for i, ((w0, m0, v0), g) in enumerate(zip(before, gs)):
            w, m, v = _f64_adamw(w0, g.astype(np.float64), m0, v0, t, lr, wd)
            m1, m2 = (opt._accumulators[f"moment{j}@{i}"] for j in (1, 2))
            assert m1.dtype == torch.bfloat16 and m2.dtype == torch.float32
            np.testing.assert_allclose(tps[i].detach().numpy(), w,
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(m1.double().numpy(), m,
                                       rtol=2.0 ** -8, atol=0)
            np.testing.assert_allclose(m2.numpy(), v, rtol=1e-6, atol=0)
            if t == 1:
                np.testing.assert_allclose(
                    tps[i].detach().numpy(), np.asarray(plain_ps[i]._value),
                    rtol=1e-6, atol=0)
                want_m1 = np.asarray(acc_opt._accumulators[
                    acc_opt._acc_key("moment1", acc_ps[i])].astype(
                        np.float32))
                np.testing.assert_array_equal(m1.float().numpy(), want_m1)


SCHEDULERS = {  # name -> kwargs; the same for both packages
    "NoamDecay": dict(d_model=64, warmup_steps=5, learning_rate=0.5),
    "PiecewiseDecay": dict(boundaries=[3, 9], values=[0.1, 0.05, 0.01]),
    "NaturalExpDecay": dict(learning_rate=0.1, gamma=0.2),
    "InverseTimeDecay": dict(learning_rate=0.1, gamma=0.3),
    "PolynomialDecay": dict(learning_rate=0.1, decay_steps=7, cycle=True),
    "LinearWarmup": dict(learning_rate=0.1, warmup_steps=5, start_lr=0.0,
                         end_lr=0.1),
    "ExponentialDecay": dict(learning_rate=0.1, gamma=0.9),
    "MultiStepDecay": dict(learning_rate=0.1, milestones=[4, 11, 30]),
    "StepDecay": dict(learning_rate=0.1, step_size=6, gamma=0.5),
    "LambdaDecay": dict(learning_rate=0.1, lr_lambda=lambda e: 0.95 ** e),
    "ReduceOnPlateau": dict(learning_rate=0.1, patience=2, cooldown=1,
                            factor=0.5),
    "CosineAnnealingDecay": dict(learning_rate=0.1, T_max=13,
                                 eta_min=0.001),
    "MultiplicativeDecay": dict(learning_rate=0.1, lr_lambda=lambda e: 0.97),
    "OneCycleLR": dict(max_learning_rate=0.1, total_steps=30),
    "CyclicLR": dict(base_learning_rate=0.01, max_learning_rate=0.1,
                     step_size_up=4, mode="triangular2"),
    "LinearLR": dict(learning_rate=0.1, total_steps=17),
    "CosineAnnealingWarmRestarts": dict(learning_rate=0.1, T_0=5, T_mult=2),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_values_and_state_dicts_match_jax(name):
    """(f) Each scheduler's value over 40 steps (ReduceOnPlateau stepped on
    a metric that stalls) and its state dict, exactly; a state dict taken
    at step 20 resumes the port's copy on the same values."""
    assert set(tlr.__all__) == set(paddle.optimizer.lr.__all__)
    assert len(SCHEDULERS) == len(tlr.__all__) - 1
    j = getattr(paddle.optimizer.lr, name)(**SCHEDULERS[name])
    t = getattr(tlr, name)(**SCHEDULERS[name])
    metrics = [1.0 / (1 + min(k, 12)) for k in range(40)]
    resumed = None
    for k in range(40):
        assert t() == j(), (name, k)
        assert t.state_dict() == j.state_dict(), (name, k)
        if k == 20:
            resumed = getattr(tlr, name)(**SCHEDULERS[name])
            resumed.set_state_dict(t.state_dict())
        if resumed is not None:
            assert resumed() == t()
        for s in (j, t) + ((resumed,) if resumed is not None else ()):
            if name == "ReduceOnPlateau":
                s.step(torch.tensor(metrics[k], dtype=torch.float64)
                       if s is t else metrics[k])
            else:
                s.step()


CLIPS = {
    "value": lambda m: m.ClipGradByValue(0.3),
    "value_min": lambda m: m.ClipGradByValue(0.3, min=-0.1),
    "norm": lambda m: m.ClipGradByNorm(1.5),
    "global_norm": lambda m: m.ClipGradByGlobalNorm(2.0),
}


@pytest.mark.parametrize("need_clip", [True, False])
@pytest.mark.parametrize("name", sorted(CLIPS))
def test_clips_match_jax(name, need_clip):
    """(g) Each clip on the same numpy gradients (f32 and bf16; norms that
    bite and one that does not), with the middle parameter exempt
    (``need_clip=False``) in the second case: JAX's ``_clip_arrays`` and
    the ``(param, grad)`` interface."""
    rng = np.random.RandomState(7)
    gs = [rng.randn(*s).astype(np.float32) * c
          for s, c in (((10, 6), 1.0), ((17,), 0.01), ((4, 4), 3.0))]

    class P:
        def __init__(self, m):
            self.need_clip = m

    params = [P(True), P(need_clip), P(True)]
    for dtype, jdt in ((torch.float32, "float32"),
                       (torch.bfloat16, "bfloat16")):
        tg = [torch.tensor(g).to(dtype) for g in gs]
        jg = [paddle.to_tensor(g).astype(jdt)._value for g in gs]
        got = CLIPS[name](tnn)._clip_arrays(tg, params)
        want = CLIPS[name](paddle.nn)._clip_arrays(jg, params)
        pairs = CLIPS[name](tnn)(list(zip(params, tg)))
        for a, (_, b), w in zip(got, pairs, want):
            w = np.asarray(w.astype(np.float32))
            assert a.dtype == dtype
            np.testing.assert_allclose(a.float().numpy(), w, rtol=1e-6,
                                       atol=1e-7 if dtype == torch.float32
                                       else 0)
            np.testing.assert_array_equal(b.float().numpy(),
                                          a.float().numpy())
        if not need_clip:
            np.testing.assert_array_equal(got[1].float().numpy(),
                                          tg[1].float().numpy())


@pytest.mark.parametrize("norm_type", [2.0, 1.0, math.inf])
def test_clip_grad_norm_matches_jax(norm_type):
    """(g) ``clip_grad_norm_`` over live gradients: the total norm and the
    clipped gradients."""
    from paddle_tpu.core.tensor import Parameter

    rng = np.random.RandomState(8)
    gs = [rng.randn(*s).astype(np.float32) for s in ((9, 3), (5,))]
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    jps = [Parameter(paddle.zeros(list(g.shape))._value) for g in gs]
    for tp, jp, g in zip(tps, jps, gs):
        tp.grad = torch.tensor(g)
        jp._grad = paddle.to_tensor(g)
    total = tnn.clip_grad_norm_(tps, 1.0, norm_type)
    want = paddle.nn.clip.clip_grad_norm_(jps, 1.0, norm_type)
    np.testing.assert_allclose(float(total), float(want), rtol=1e-6)
    for tp, jp in zip(tps, jps):
        np.testing.assert_allclose(tp.grad.numpy(),
                                   np.asarray(jp._grad._value), rtol=1e-6,
                                   atol=1e-7)


def test_optimizer_surface_raises_and_groups_check_like_jax():
    """lr_ratio (read nowhere in JAX) and lazy_mode (sparse gradients)
    raise; a group with an unknown key or a parameter in two groups
    raises as in JAX; set_lr under a scheduler raises; get_lr follows the
    scheduler; the optimizer's state dict has JAX's keys."""
    p, q = (torch.nn.Parameter(torch.ones(3)) for _ in range(2))
    with pytest.raises(NotImplementedError):
        AdamW(parameters=[p], lr_ratio=lambda _: 1.0)
    with pytest.raises(NotImplementedError):
        Adam(parameters=[p], lazy_mode=True)
    with pytest.raises(ValueError, match="unsupported parameter-group"):
        AdamW(parameters=[{"params": [p], "momentum": 0.9}])
    with pytest.raises(ValueError, match="more than one"):
        AdamW(parameters=[{"params": [p]}, {"params": [p, q]}])
    sched = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    opt = AdamW(learning_rate=sched, parameters=[p, q],
                multi_precision=True)
    with pytest.raises(RuntimeError):
        opt.set_lr(0.2)
    sched.step()
    assert opt.get_lr() == 0.05
    p.grad = torch.ones(3)
    opt.step()
    assert sorted(opt.state_dict()) == [
        "@step_count", "LR_Scheduler", "moment1@0", "moment2@0"]


@pytest.mark.parametrize("coupled", [False, True])
def test_bf16_parameters_without_masters_update_in_f32(coupled):
    """bf16 parameters without ``multi_precision`` keep the parameter and
    both moments in bf16, and the port's update computes in f32. (JAX runs
    its rule in bf16 there, ``dt = p.dtype`` :684: beta2 = 0.999 rounds to
    1 and its first step makes every parameter NaN, a defect of the
    reference that this test does not hold the port to.) Two steps of
    AdamW, and of Adam with coupled decay, on numpy gradients: each step
    from the port's own stored state against the f64 rule with JAX's f32
    constants, every store within one bf16 ulp, all finite."""
    rng = np.random.RandomState(9)
    shapes = [(24, 16), (16,)]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(2)]
    tps = [torch.nn.Parameter(torch.tensor(rng.randn(*s)).bfloat16())
           for s in shapes]
    lr, wd = 0.01, 0.1
    opt = (Adam if coupled else AdamW)(learning_rate=lr, parameters=tps,
                                       weight_decay=wd)
    f32 = [float(np.float32(x)) for x in (lr, wd, 0.9, 0.999, 1e-8)]
    lr, wd, b1, b2, eps = f32
    for t, gs in enumerate(grads, start=1):
        before = [[x.detach().double().numpy().copy() for x in (
            p, opt._accumulators.get(f"moment1@{i}", torch.zeros(p.shape)),
            opt._accumulators.get(f"moment2@{i}", torch.zeros(p.shape)))]
            for i, p in enumerate(tps)]
        for p, g in zip(tps, gs):
            p.grad = torch.tensor(g).bfloat16()
        opt.step()
        for i, ((w, m, v), g) in enumerate(zip(before, gs)):
            g = torch.tensor(g).bfloat16().double().numpy()
            if coupled:
                g = g + wd * w
            else:
                w = w * (1 - lr * wd)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            w = w - lr * (m / (1 - b1 ** t)) / (np.sqrt(v / (1 - b2 ** t))
                                                 + eps)
            for got, want in ((tps[i], w), (opt._accumulators[
                    f"moment1@{i}"], m), (opt._accumulators[
                        f"moment2@{i}"], v)):
                assert got.dtype == torch.bfloat16
                got = got.detach().double().numpy()
                assert np.isfinite(got).all()
                np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                           atol=0)
