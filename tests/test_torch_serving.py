"""The port's serving engine and page pool on their own (the JAX engine
comparison is in test_torch_llama.py), and the port's device rule."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.models import (
    ContinuousBatchingEngine,
    LlamaConfig,
    LlamaForCausalLM,
    PagePool,
    generate,
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


CFG = LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128)


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(CFG, device="cpu", dtype=torch.float32,
                            generator=paddle_tpu_torch.seed(3, "cpu"))


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, CFG.vocab_size, (n,)).astype(np.int32)
            for n in lengths]


def test_page_pool_alloc_decref_recycle():
    pool = PagePool(4)
    a = pool.alloc(3)
    assert a == [0, 1, 2] and pool.available() == 1
    assert pool.alloc(2) is None  # short: the caller decides
    pool.incref(a[0])
    assert pool.decref(a) == [1, 2]  # a[0] keeps one reference
    assert pool.refcount(a[0]) == 1 and pool.available() == 1
    pool.recycle([1, 2])
    assert pool.available() == 3 and pool.allocated() == 1


def test_engine_pool_layout_and_pages_return(model):
    eng = ContinuousBatchingEngine(model, max_slots=3, max_len=64,
                                   page_size=16, prompt_buckets=(8, 32))
    # 3 slots x 4 pages, then 32/16 = 2 scratch pages, the last the dump
    assert eng._ks[0].shape == (14, 16, 2, 8)
    assert eng._dump_page == 13
    # 4 attention-visible columns + 2 scratch columns; the scratch row
    # (index max_slots) maps onto the scratch pages
    assert eng._tables_np.shape == (4, 6)
    assert eng._tables_np[3].tolist() == [12, 13, 13, 13, 13, 13]
    outs, stats = eng.run(_prompts(0, (3, 20, 7, 12, 30)), max_new_tokens=9,
                          segment=4)
    assert [len(o) for o in outs] == [9] * 5
    assert stats["useful_tokens"] == 45 and stats["segments"] > 0
    assert 0.0 < stats["mean_occupancy"] <= 1.0
    assert set(stats) >= {"tokens_per_sec", "useful_tokens",
                          "mean_occupancy", "segments", "wall_s"}
    # every grant went back but the full prompt pages the prefix cache
    # holds (one each of the 20- and 30-token prompts); evicting them
    # returns the whole pool; idle rows alias the dump page
    assert eng._pool.available() + len(eng._prefix) == 12
    assert len(eng._prefix) == 2
    assert eng._prefix.evict(12) == 2 and eng._pool.available() == 12
    assert (eng._tables_np[:3] == 13).all()


def test_admission_defers_the_queue_head_when_the_pool_is_short(model):
    """With a pool of 2 pages, a second 20-token request (2 pages to its
    first segment) waits for the first to retire, though a slot is free;
    the streams are those of an unconstrained engine."""
    prompts = _prompts(4, (20, 18, 5))
    kw = dict(max_slots=2, max_len=64, page_size=16, prompt_buckets=(32,))
    want, _ = ContinuousBatchingEngine(model, **kw).run(
        prompts, max_new_tokens=8, segment=4)
    eng = ContinuousBatchingEngine(model, **kw)
    eng._pool_pages = 2
    eng.start(segment=4)
    reqs = [eng.submit(p, 8) for p in prompts]
    eng.step()
    assert eng._slot_req.count(None) == 1 and len(eng._queue) == 2
    while eng.has_work():
        eng.step()
    for r, w in zip(reqs, want):
        np.testing.assert_array_equal(r.output(), w)


def test_slot_never_advances_past_capacity(model):
    """prompt + max_new == max_len: the slot freezes at its budget
    mid-segment and still emits the whole stream."""
    p = _prompts(1, (54,))[0]
    eng = ContinuousBatchingEngine(model, max_slots=2, max_len=64,
                                   page_size=16, prompt_buckets=(64,))
    outs, _ = eng.run([p], max_new_tokens=10, segment=4)
    want = generate(model, torch.tensor(p[None]),
                    max_new_tokens=10).numpy()[0, 54:]
    np.testing.assert_array_equal(outs[0], want)


def test_engine_validates_requests(model):
    eng = ContinuousBatchingEngine(model, max_slots=2, max_len=64,
                                   page_size=16, prompt_buckets=(32,))
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        eng.run([np.arange(60, dtype=np.int32)], max_new_tokens=10)
    # a prompt past the largest bucket takes chunked prefill (JAX's
    # behaviour), and needs max_len to be a multiple of the largest bucket
    outs, stats = eng.run([np.arange(40, dtype=np.int32)], max_new_tokens=4)
    assert stats["statuses"] == ["ok"] and len(outs[0]) == 4
    assert stats["dispatches"]["chunk"] == 1
    assert stats["dispatches"]["final_chunk"] == 1
    odd = ContinuousBatchingEngine(model, max_slots=2, max_len=48,
                                   page_size=16, prompt_buckets=(32,))
    with pytest.raises(ValueError, match="multiple of the largest bucket"):
        odd.run([np.arange(40, dtype=np.int32)], max_new_tokens=4)
    odd.run([np.arange(30, dtype=np.int32)], max_new_tokens=4)
    small = ContinuousBatchingEngine(model, max_slots=2, max_len=32,
                                     page_size=16, prompt_buckets=(64,))
    with pytest.raises(ValueError, match="bucket 64"):
        small.run([np.arange(10, dtype=np.int32)], max_new_tokens=4)


def test_sampled_top_k_1_equals_greedy(model):
    prompts = _prompts(2, (6, 13, 4, 9))
    kw = dict(max_slots=2, max_len=64, page_size=16, prompt_buckets=(16,))
    greedy, _ = ContinuousBatchingEngine(model, **kw).run(
        prompts, max_new_tokens=8, segment=4)
    top1, _ = ContinuousBatchingEngine(model, do_sample=True, top_k=1,
                                       seed=5, **kw).run(
        prompts, max_new_tokens=8, segment=4)
    for g, t in zip(greedy, top1):
        np.testing.assert_array_equal(t, g)


@pytest.mark.parametrize("filters", [dict(), dict(top_k=20, top_p=0.9,
                                                  temperature=0.7)])
def test_sampled_streams_do_not_depend_on_batching(model, filters):
    """Per-request streams: the same seed gives the same tokens whether a
    request shares a 3-slot batch or runs alone on 1 slot."""
    prompts = _prompts(3, (6, 13, 4, 9, 11))
    kw = dict(max_len=64, page_size=16, prompt_buckets=(8, 16),
              do_sample=True, seed=11, **filters)
    wide, _ = ContinuousBatchingEngine(model, max_slots=3, **kw).run(
        prompts, max_new_tokens=8, segment=3)
    narrow, _ = ContinuousBatchingEngine(model, max_slots=1, **kw).run(
        prompts, max_new_tokens=8, segment=5)
    for w, n in zip(wide, narrow):
        np.testing.assert_array_equal(w, n)
    other, _ = ContinuousBatchingEngine(
        model, max_slots=3, **{**kw, "seed": 12}).run(
        prompts, max_new_tokens=8, segment=3)
    assert any((w != o).any() for w, o in zip(wide, other))


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        paddle_tpu_torch.seed(0)
    m = LlamaForCausalLM(CFG, device="cpu", dtype=torch.float32)
    assert m.device == torch.device("cpu")
    assert ContinuousBatchingEngine(m, max_slots=1, max_len=32,
                                    page_size=16).device.type == "cpu"
