"""The port's dynamic page pool, prefix cache, preemption, deadlines and
abort, drilled on its own serial engine (``pipeline=False``; the JAX
engine comparison is in test_torch_admission.py, the pipelined engine's
drills in test_torch_pipeline.py).

The drills mirror ``tests/test_kv_pool.py`` on the same tiny LLaMA
shape, built by the port from a seed on the CPU: each stream is held to
the same engine without the prefix cache, or with a roomy pool.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch.core import Deadline, counters, reset_counters
from paddle_tpu_torch.models import (
    ContinuousBatchingEngine,
    LlamaConfig,
    LlamaForCausalLM,
)

_CFG = LlamaConfig(vocab_size=151, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=512, tie_word_embeddings=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's torch work on one intra-op thread: the engine's eager
    steps are loops of small ops, and where pytest-xdist's workers share
    the cores each worker's thread pool otherwise spin-waits against the
    others' (the drills ran ~20x slower under 6 workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    yield
    reset_counters()


@pytest.fixture(scope="module")
def model():
    return LlamaForCausalLM(_CFG, device="cpu",
                            generator=paddle_tpu_torch.seed(0, "cpu"))


def _engine(model, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 128)
    kw.setdefault("page_size", 32)
    kw.setdefault("prompt_buckets", (16, 32, 64))
    kw.setdefault("seed", 7)
    kw.setdefault("pipeline", False)
    return ContinuousBatchingEngine(model, **kw)


def _rng(seed=1):
    return np.random.RandomState(seed)


def _toks(rng, n):
    return rng.randint(0, 151, (n,)).astype(np.int32)


def _serve(eng, subs, segment=4, serialize_first=True):
    """Submit ``subs`` = [(rid, prompt, max_new)] and run to completion.
    ``serialize_first`` drains the first request before submitting the
    rest, so its prompt pages are cached when the others admit."""
    eng.start(segment=segment)
    reqs = []
    for i, (rid, p, new) in enumerate(subs):
        reqs.append(eng.submit(p, new, rid=rid))
        if i == 0 and serialize_first:
            while eng.has_work():
                eng.step()
    while eng.has_work():
        eng.step()
    return [np.asarray(r.tokens, np.int32) for r in reqs], reqs


def _pool_whole(eng):
    kv = eng.kv_stats()
    return kv["pages_free"] + kv["prefix_cached_pages"] == kv["pages_total"]


# -------------------------------------------- bit-exactness invariants


@pytest.mark.parametrize("do_sample", [False, True])
def test_shared_prefix_streams_identical(model, do_sample):
    """Prefix-shared streams equal unshared ones, greedy and sampled from
    per-request streams: a full-page hit, a mid-page copy-on-write
    divergence inside another prompt, and a second full-page hit."""
    rng = _rng(2)
    pre = _toks(rng, 48)                     # 1.5 pages of 32
    subs = [(1, np.concatenate([pre, _toks(rng, 20)]), 10),
            (2, np.concatenate([pre, _toks(rng, 9)]), 10),   # page hit
            (3, pre[:40].copy(), 10),        # inside req 1, ends mid-page
            (4, np.concatenate([pre, _toks(rng, 20)]), 10)]
    kw = dict(do_sample=do_sample, top_k=8)
    eng = _engine(model, prefix_cache=True, **kw)
    got, _ = _serve(eng, subs)
    want, _ = _serve(_engine(model, prefix_cache=False, **kw), subs)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    # requests 2-4 each diverge inside a cached page: three copies
    d = eng.stats()["dispatches"]
    assert d["resume"] and d["cow_pages"] == 3
    assert counters()["serving.kv_cow_copies"] == 3


def test_cow_divergence_leaves_the_owner_intact(model):
    """A mid-page copy-on-write admission while the prefix's owner is
    still decoding: both streams equal their unshared references (the
    writer never touches the shared page)."""
    rng = _rng(3)
    pre = _toks(rng, 64)                     # 2 pages
    p_owner = np.concatenate([pre, _toks(rng, 8)])
    p_cow = pre[:50].copy()                  # diverges mid page 1
    for pc in (True, False):
        eng = _engine(model, prefix_cache=pc)
        eng.start(segment=2)
        owner = eng.submit(p_owner, 24, rid=1)
        eng.step()                           # owner admitted + decoding
        cow = eng.submit(p_cow, 24, rid=2)   # maps owner's pages
        while eng.has_work():
            eng.step()
        if pc:
            got = (np.asarray(owner.tokens), np.asarray(cow.tokens))
            assert eng.kv_stats()["prefix_tokens_saved"] > 0
            assert eng.stats()["dispatches"]["cow_pages"] == 1
        else:
            want = (np.asarray(owner.tokens), np.asarray(cow.tokens))
    np.testing.assert_array_equal(got[0], want[0], err_msg="owner")
    np.testing.assert_array_equal(got[1], want[1], err_msg="cow reader")


def test_refcount_survives_owner_retirement(model):
    """Shared pages outlive the request that computed them: a later
    request with the same prefix hits the cache after the owner retired,
    and the pages return to the pool only when the cache lets go."""
    rng = _rng(4)
    pre = _toks(rng, 64)
    eng = _engine(model)
    subs = [(1, np.concatenate([pre, _toks(rng, 12)]), 8),
            (2, np.concatenate([pre, _toks(rng, 5)]), 8)]
    _, reqs = _serve(eng, subs)              # serialized: 1 retires first
    assert all(r.status == "ok" for r in reqs)
    kv = eng.kv_stats()
    assert kv["prefix_tokens_saved"] >= 64   # req 2 skipped the prefix
    assert kv["prefix_cached_pages"] > 0
    assert _pool_whole(eng)
    for p in range(kv["pages_total"]):       # the cache's one reference
        assert eng._pool.refcount(p) in (0, 1)
    assert eng._prefix.evict(kv["pages_total"]) == kv["prefix_cached_pages"]
    assert eng._pool.available() == kv["pages_total"]


def test_chunked_prefill_resume_long_prompts(model):
    """Prompts past the largest bucket resume their chunked prefill at
    the first divergent page (page-aligned); streams equal the cold
    engine's, which chunks them from 0."""
    rng = _rng(5)
    shared = _toks(rng, 96)
    subs = [(1, np.concatenate([shared, _toks(rng, 70)]), 8),
            (2, np.concatenate([shared, _toks(rng, 81)]), 8)]
    kw = dict(max_len=256, max_slots=2, prompt_buckets=(16, 64))
    warm = _engine(model, prefix_cache=True, **kw)
    got, _ = _serve(warm, subs)
    cold = _engine(model, prefix_cache=False, **kw)
    want, _ = _serve(cold, subs)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert warm.kv_stats()["prefix_tokens_saved"] == 96
    # 166 tokens: 2 full chunks + a final one cold; request 2 resumes at 96
    assert cold.stats()["dispatches"]["chunk"] > (
        warm.stats()["dispatches"]["chunk"])


# ------------------------------------------------ pool-pressure drills


def test_pool_exhausted_defers_admission_never_fails(model):
    """A pool well below max_slots full sequences: admissions defer with
    ``serving.kv_pool_exhausted``, every request finishes ok with the
    uncontended engine's stream, and retirement returns every grant."""
    rng = _rng(6)
    subs = [(i, _toks(rng, 10), 40) for i in range(6)]
    tight = _engine(model, max_slots=6, prompt_buckets=(16,), pool_pages=6)
    tight.start(segment=4)
    reqs = [tight.submit(p, new, rid=rid) for rid, p, new in subs]
    blocked = False
    while tight.has_work():
        tight.step()
        blocked |= tight.admission_blocked and bool(tight.queued_requests())
    assert blocked
    got = [np.asarray(r.tokens, np.int32) for r in reqs]
    assert all(r.status == "ok" for r in reqs)
    assert counters().get("serving.kv_pool_exhausted", 0) > 0
    roomy = _engine(model, max_slots=6, prompt_buckets=(16,))
    want, _ = _serve(roomy, subs, serialize_first=False)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert _pool_whole(tight)


@pytest.mark.parametrize("pool_pages", [5, 10])
def test_preemption_resumes_identically(model, pool_pages):
    """Decode growth outrunning the pool preempts the youngest slot
    (``serving.kv_preempted``) instead of failing it; the preempted
    request re-admits with its emitted tokens folded into its prompt and
    its stream equals the uncontended run's. At 10 pages of 16 a request
    is preempted twice: its second fold appends only the tokens emitted
    since the first."""
    rng = _rng(7 if pool_pages == 5 else 1)
    n, plen, new = (4, 6, 60) if pool_pages == 5 else (6, 6, 100)
    subs = [(i, _toks(rng, plen), new) for i in range(n)]
    kw = (dict(max_slots=4, max_len=96, prompt_buckets=(8,))
          if pool_pages == 5 else
          dict(max_slots=4, max_len=128, page_size=16, prompt_buckets=(8,)))
    tight = _engine(model, pool_pages=pool_pages, **kw)
    got, reqs = _serve(tight, subs, serialize_first=False)
    assert all(r.status == "ok" for r in reqs)
    assert counters().get("serving.kv_preempted", 0) > 0
    for r, (_, p, _) in zip(reqs, subs):
        # a folded prompt is the original plus the tokens it had emitted
        np.testing.assert_array_equal(r.prompt[:plen], p)
        np.testing.assert_array_equal(r.prompt[plen:], r.tokens[:r.folded])
    if pool_pages == 10:
        # more preemptions than preempted requests: one was preempted twice
        preempted = [r for r in reqs if r.preempted]
        assert counters()["serving.kv_preempted"] > len(preempted)
        assert all(r.folded > 0 for r in preempted)
    want, _ = _serve(_engine(model, **kw), subs, serialize_first=False)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert _pool_whole(tight)


def test_preempted_fold_past_chunk_width(model):
    """A preempted request whose folded prompt (original + emitted)
    outgrows the largest bucket re-admits through chunked prefill even
    on an engine whose max_len is not a chunk multiple (``submit()``
    rejects such long prompts; preemption makes them), and the streams
    equal the uncontended run's."""
    rng = _rng(15)
    kw = dict(max_slots=2, max_len=24, page_size=8, prompt_buckets=(16,),
              prefix_cache=False)
    # 4-token prompts grow together until the 4-page pool is spent at
    # length 16; the younger is preempted with 13 tokens emitted
    subs = [(i, _toks(rng, 4), 19) for i in range(2)]
    tight = _engine(model, pool_pages=4, **kw)
    got, reqs = _serve(tight, subs, serialize_first=False)
    assert all(r.status == "ok" for r in reqs)
    assert counters().get("serving.kv_preempted", 0) > 0
    assert max(r.prompt.size for r in reqs) == 17
    assert tight.stats()["dispatches"]["final_chunk"] > 0
    want, _ = _serve(_engine(model, **kw), subs, serialize_first=False)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_kv_bytes_count_shared_pages_once(model):
    """Slots mapping the same cached pages report no more bytes in use
    than the pool holds; grants stay the fragmentation denominator."""
    rng = _rng(16)
    pre = _toks(rng, 64)
    eng = _engine(model)
    eng.start(segment=2)
    reqs = [eng.submit(np.concatenate([pre, _toks(rng, 4)]), 30, rid=1)]
    eng.step()                            # rid 1 admits, pages cached
    reqs += [eng.submit(np.concatenate([pre, _toks(rng, 4)]), 30, rid=r)
             for r in (2, 3)]
    for _ in range(3):
        eng.step()                        # rids 2-3 share the prefix
    kv = eng.kv_stats()
    assert kv["slot_occupancy"] == 0.75
    pool_bytes = kv["pages_total"] * eng.page_size * kv["bytes_per_token"]
    assert 0 < kv["bytes_in_use"] <= pool_bytes, kv
    assert kv["pages_granted"] < sum(len(eng._slot_pages[s])
                                     for s in range(eng.max_slots))
    assert 0.0 <= kv["fragmentation_pct"] <= 100.0
    for r in reqs:
        eng.abort(r.rid)
    assert not eng.has_work() and _pool_whole(eng)


# --------------------------------------------------- deadlines, abort


def test_deadline_retires_queued_and_seated_requests(model):
    """``deadline_s=0`` retires a request ``timed_out``: a seated one
    after its first segment, with its partial tokens, and a queued one
    without ever being admitted; its pages return."""
    rng = _rng(9)
    eng = _engine(model, max_slots=1)
    eng.start(segment=3)
    seated = eng.submit(_toks(rng, 10), 20, deadline_s=0, rid=1)
    queued = eng.submit(_toks(rng, 10), 20, deadline_s=0, rid=2)
    done = eng.step()
    assert {r.rid for r in done} == {1, 2}
    assert seated.status == queued.status == "timed_out"
    assert len(seated.tokens) == 4 and queued.tokens == []
    assert not eng.has_work() and _pool_whole(eng)
    assert eng.stats()["timed_out"] == 2


def test_run_timeout_retires_everything(model):
    rng = _rng(10)
    prompts = [_toks(rng, n) for n in (5, 40, 12)]
    eng = _engine(model, max_slots=2)
    outs, stats = eng.run(prompts, 16, segment=4, timeout_s=0)
    assert stats["statuses"] == ["timed_out"] * 3
    assert stats["timed_out"] == 3 and _pool_whole(eng)
    outs, stats = eng.run(prompts, 16, segment=4,
                          request_deadline_s=[None, 0, None])
    assert stats["statuses"] == ["ok", "timed_out", "ok"]
    assert [len(o) for o in outs[::2]] == [16, 16]
    with pytest.raises(ValueError, match="request_deadline_s"):
        eng.run(prompts, 16, request_deadline_s=[None])


def test_abort_queued_and_seated_requests(model):
    """``abort`` pulls a queued request and a seated one out as
    ``cancelled``, keeps the seated one's partial tokens, returns its
    pages, and leaves the other streams untouched."""
    rng = _rng(11)
    subs = [(i, _toks(rng, 12), 12) for i in range(3)]
    want, _ = _serve(_engine(model, max_slots=2), subs,
                     serialize_first=False)
    eng = _engine(model, max_slots=2)
    eng.start(segment=4)
    reqs = [eng.submit(p, new, rid=rid) for rid, p, new in subs]
    eng.step()
    assert [r.rid for r in eng.queued_requests()] == [2]
    assert eng.free_slots() == 0
    assert eng.abort(2) is reqs[2] and reqs[2].status == "cancelled"
    seated = eng.abort(1, status="cancelled")
    assert seated is reqs[1] and len(seated.tokens) == 5
    np.testing.assert_array_equal(seated.tokens, want[1][:5])
    assert eng.abort(1) is None and eng.abort(99) is None
    assert [r.rid for r in eng.active_requests()] == [0]
    while eng.has_work():
        eng.step()
    np.testing.assert_array_equal(reqs[0].tokens, want[0])
    assert reqs[0].status == "ok" and eng.stats()["cancelled"] == 2
    assert _pool_whole(eng)


class _ExpiresAfter(Deadline):
    """A deadline that reads expired from its ``n``-th check on."""

    def __init__(self, n):
        super().__init__(None)
        self.checks, self.n = 0, n

    def expired(self):
        self.checks += 1
        return self.checks >= self.n


def test_deadline_between_chunks_stops_the_prefill(model):
    """A 200-token prompt (three 64-token chunks and a final one) whose
    deadline expires after its first chunk retires ``timed_out`` with no
    further chunk dispatched and its pages back in the pool."""
    rng = _rng(12)
    eng = _engine(model, max_len=256, max_slots=2, prompt_buckets=(16, 64))
    eng.start(segment=4)
    req = eng.submit(_toks(rng, 200), 8, deadline_s=_ExpiresAfter(2))
    done = eng.step()
    assert done == [req] and req.status == "timed_out" and not req.tokens
    d = eng.stats()["dispatches"]
    assert d["chunk"] == 1 and d["final_chunk"] == 0
    assert not eng.has_work() and _pool_whole(eng)


# --------------------------------------------------- engine arguments


def test_max_len_round_up_is_surfaced(model):
    """The page-multiple round-up of ``max_len`` is logged and surfaced
    in ``kv_stats()`` and ``stats()['kv']``."""
    eng = _engine(model, max_len=100, page_size=32)   # -> 128
    assert eng.max_len == 128
    kv = eng.stats()["kv"]
    assert kv["max_len"] == 128 and kv["max_len_rounded_from"] == 100
    clean = _engine(model, max_len=128, page_size=32)
    assert clean.kv_stats()["max_len_rounded_from"] is None


def test_pool_must_hold_one_full_sequence(model):
    with pytest.raises(ValueError, match="pool_pages"):
        _engine(model, pool_pages=2)          # < per_seq (128/32 = 4)


def test_pipeline_default_and_true_run_pipelined(model):
    """The pipeline is the default scheduler, as in JAX: the engine built
    without ``pipeline`` and with ``pipeline=True`` runs it, and
    ``pipeline=False`` the serial scheduler; all serve."""
    for pipeline, want in (("default", True), (True, True), (False, False)):
        kw = {} if pipeline == "default" else {"pipeline": pipeline}
        eng = ContinuousBatchingEngine(model, max_slots=4, max_len=128,
                                       page_size=32, prompt_buckets=(16,),
                                       **kw)
        _, stats = eng.run([np.arange(5, dtype=np.int32)], 3)
        assert stats["statuses"] == ["ok"]
        assert stats["pipelined"] is want


def test_token_base_offsets_the_sampling_stream(model):
    """A failover resume: the original prompt plus the first k emitted
    tokens with ``token_base=k`` continues the uninterrupted sampled
    stream exactly."""
    rng = _rng(13)
    p = _toks(rng, 9)
    kw = dict(do_sample=True, top_k=8, max_slots=2)
    eng = _engine(model, **kw)
    eng.start(segment=4)
    full = eng.submit(p, 12, rid=5)
    while eng.has_work():
        eng.step()
    eng.start(segment=4)
    tail = eng.submit(np.concatenate([p, full.tokens[:5]]), 7, rid=5,
                      token_base=5)
    while eng.has_work():
        eng.step()
    np.testing.assert_array_equal(tail.tokens, full.tokens[5:])
