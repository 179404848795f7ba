"""The port's LLaMA, generation and serving engine against the JAX package.

A tiny GQA LLaMA (hidden 64, 4 heads, 2 kv heads, 2 layers) is built by
``paddle_tpu`` from a seed; ``paddle_tpu_torch.models.convert`` carries its
``raw_state()`` weights into the port's model on the CPU (where the port
runs its kernels' plain versions), and both run in f32.

Logits are held to 1e-5 (they agree to ~2e-7). Greedy streams are held
token-identical: two f32 frameworks differ by ~1e-6 in the logits, so the
tests also assert that every greedy choice they compare had a top-2 logit
gap of at least ``MIN_GAP``, far above that noise; the seeds were picked
so that it holds.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu.models.serving import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu_torch.models import (
    ContinuousBatchingEngine,
    LlamaConfig,
    LlamaForCausalLM,
    PagedKVCache,
    generate,
    params_from_paddle_tpu,
)


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


CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)
MIN_GAP = 1e-4
ENGINE = dict(max_slots=3, max_len=64, page_size=16, prompt_buckets=(8, 16))


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlamaForCausalLM(JaxLlamaConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                          dtype=torch.float32)
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}, tm)
    return jm, tm


def _min_top2_gap(model, prompt, tokens):
    """Smallest top-2 logit gap over the greedy choices that produced
    ``tokens`` after ``prompt`` (teacher-forced forward)."""
    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits = model(torch.tensor(seq[None]))[0, prompt.size - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def test_logits_match_jax(models):
    jm, tm = models
    ids = np.random.RandomState(0).randint(0, 128, (2, 20)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = tm(torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_prefill_and_paged_decode_match_jax_full_forward(models):
    """Prefill 12 tokens into the port's PagedKVCache (16-token pages, so
    decode crosses a page boundary), then decode 8 tokens one at a time;
    each step's logits equal the JAX model's at that position."""
    jm, tm = models
    ids = np.random.RandomState(1).randint(0, 128, (2, 20)).astype(np.int32)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    caches = [PagedKVCache(2, 32, 2, 16, page_size=16, device="cpu",
                           dtype=torch.float32) for _ in range(2)]
    with torch.no_grad():
        got = [tm(torch.tensor(ids[:, :12]), caches=caches)]
        for t in range(12, 20):
            got.append(tm(torch.tensor(ids[:, t:t + 1]), caches=caches))
    np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want,
                               atol=1e-5, rtol=0)
    assert caches[0].length == 20


def test_group12_llama_prefill_and_decode_match_jax():
    """A GQA group of 12 (hidden 96, 12 heads of 8 on one kv head, 2
    layers, f32), past the 8 query heads a block of the card's paged
    decode kernel holds: the port's prefill into the paged cache and 4
    decode steps, unfused and then fused (per-slot depths inside
    ``megakernel_scope(True)``), each step's logits equal to the JAX
    model's at that position."""
    from paddle_tpu_torch.ops.cuda.decode_megakernel import megakernel_scope

    cfg = dict(CFG, hidden_size=96, num_attention_heads=12,
               num_key_value_heads=1)
    paddle.seed(3)
    jm = JaxLlamaForCausalLM(JaxLlamaConfig(**cfg))
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu",
                          dtype=torch.float32)
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}, tm)
    ids = np.random.RandomState(2).randint(0, 128, (2, 16)).astype(np.int32)
    want = np.asarray(paddle.jit.to_static(jm)(paddle.to_tensor(ids))._value)
    for fused in (False, True):
        caches = [PagedKVCache(2, 32, 1, 8, page_size=16, device="cpu",
                               dtype=torch.float32) for _ in range(2)]
        with torch.no_grad():
            got = [tm(torch.tensor(ids[:, :12]), caches=caches)]
            if fused:
                for c in caches:
                    c.length = torch.full((2,), 12, dtype=torch.int32)
            with megakernel_scope(fused):
                for t in range(12, 16):
                    got.append(tm(torch.tensor(ids[:, t:t + 1]),
                                  caches=caches))
        np.testing.assert_allclose(torch.cat(got, dim=1).numpy(), want,
                                   atol=1e-5, rtol=0, err_msg=f"{fused=}")


def test_generate_matches_jax_generate(models):
    jm, tm = models
    prompt = np.random.RandomState(2).randint(0, 128, (1, 9)).astype(np.int32)
    want = np.asarray(jax_generate(jm, paddle.to_tensor(prompt),
                                   max_new_tokens=12,
                                   cache="paged")._value)
    got = generate(tm, torch.tensor(prompt), max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, want)
    assert _min_top2_gap(tm, prompt[0], got[0, 9:]) > MIN_GAP


@pytest.fixture(scope="module")
def engine_streams(models):
    """Greedy streams of both engines: 7 requests on 3 slots, prompts in
    both buckets, an EOS that retires a request early and readmits."""
    jm, tm = models
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
               for n in (5, 11, 3, 16, 9, 14, 7)]
    probe = generate(tm, torch.tensor(prompts[0][None]),
                     max_new_tokens=6).numpy()[0, 5:]
    eos = int(probe[2])  # stops request 0 after three tokens
    # the JAX engine's reference is its unfused decode program (the 438M
    # path's: its megakernel declines that width)
    flags = paddle.get_flags(["FLAGS_decode_megakernel"])
    paddle.set_flags({"FLAGS_decode_megakernel": 0})
    try:
        want, _ = JaxEngine(jm, eos_token_id=eos, **ENGINE).run(
            prompts, max_new_tokens=10, segment=4)
    finally:
        paddle.set_flags(flags)
    got, stats = ContinuousBatchingEngine(tm, eos_token_id=eos,
                                          **ENGINE).run(
        prompts, max_new_tokens=10, segment=4)
    return prompts, eos, want, got, stats


def test_engine_greedy_streams_match_jax_engine(models, engine_streams):
    _, tm = models
    prompts, eos, want, got, stats = engine_streams
    assert stats["statuses"] == ["ok"] * len(prompts)
    assert got[0].tolist()[-1] == eos and len(got[0]) == 3
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
        assert _min_top2_gap(tm, prompts[i], g) > MIN_GAP, f"request {i}"


def test_engine_streams_match_port_generate(models, engine_streams):
    _, tm = models
    prompts, eos, _, got, _ = engine_streams
    for i, p in enumerate(prompts):
        want = generate(tm, torch.tensor(p[None]), max_new_tokens=10,
                        eos_token_id=eos).numpy()[0, p.size:]
        np.testing.assert_array_equal(got[i], want[:len(got[i])],
                                      err_msg=f"request {i}")


def test_convert_rejects_mismatched_weights(models):
    jm, tm = models
    params = {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}
    with pytest.raises(KeyError, match="missing"):
        params_from_paddle_tpu(
            {k: v for k, v in params.items() if k != "lm_head.weight"}, tm)
    bad = dict(params)
    bad["model.norm.weight"] = np.ones((65,), np.float32)
    with pytest.raises(ValueError, match="model.norm.weight"):
        params_from_paddle_tpu(bad, tm)
