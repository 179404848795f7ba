"""The serving engine's admission path against the JAX package: the page
pool and prefix cache, cached attention at nonzero per-row offsets, and
one run of both serial engines on traffic that chunks, resumes through a
copy-on-write page and preempts.

A tiny GQA LLaMA (hidden 64, 4 heads, 2 kv heads, 2 layers) is built by
``paddle_tpu`` from a seed and carried into the port by
``params_from_paddle_tpu``; both run in f32 on the CPU. Logits are held to
1e-5; greedy streams token-identical, each choice with a top-2 logit gap
of at least ``MIN_GAP`` (far above the ~1e-6 the two frameworks differ
by).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models import kv_pool as jax_kv_pool
from paddle_tpu.models.llama import PagedKVCache as JaxPagedKVCache
from paddle_tpu.models.serving import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu_torch.core import resilience
from paddle_tpu_torch.models import (
    ContinuousBatchingEngine,
    LlamaConfig,
    LlamaForCausalLM,
    PagedKVCache,
    params_from_paddle_tpu,
)
from paddle_tpu_torch.models import kv_pool

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=256)
MIN_GAP = 1e-4
POOL_FIELDS = ("pages_total", "pages_free", "pages_granted",
               "pages_pinned_export", "prefix_cached_pages",
               "prefix_hit_rate", "prefix_tokens_saved", "bytes_in_use",
               "bytes_per_token", "fragmentation_pct", "slot_occupancy",
               "max_len", "max_len_rounded_from", "page_size")
COUNTERS = ("serving.kv_preempted", "serving.kv_pool_exhausted")


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


# ------------------------------------------------------------ pool units


def _prefix_trace(mod):
    """One operation sequence on ``mod``'s PagePool and PrefixCache:
    chained inserts, full and partial matches, a token-verified miss,
    LRU leaf eviction with ``exclude`` and refcounts. Asserts JAX's drill
    and returns every intermediate result."""
    pool = mod.PagePool(8)
    recycled = []
    cache = mod.PrefixCache(pool, 4, recycled.extend)
    trace = []
    long_p = np.arange(16, dtype=np.int32)          # 4 full pages
    pages = pool.alloc(4)
    cache.insert(long_p, pages)
    assert len(cache) == 4
    short = long_p[:11]
    hit, matched, partial = cache.match(short)
    assert hit == pages[:2] and matched == 8
    assert partial is not None and partial.r == 3
    assert partial.page == pages[2]
    trace.append((hit, matched, partial.page, partial.r))
    other = long_p[:11].copy()
    other[2] = 99
    hit2, matched2, partial2 = cache.match(other)
    assert hit2 == [] and matched2 == 0
    assert partial2 is not None and partial2.r == 2
    trace.append((hit2, matched2, partial2.page, partial2.r))
    # a second chain sharing page 0, then a diverging third
    branch = np.concatenate([long_p[:4], np.arange(50, 58, dtype=np.int32)])
    bp = [pages[0]] + pool.alloc(2)
    pool.incref(pages[0])
    cache.insert(branch, bp)
    trace.append((len(cache), [pool.refcount(p) for p in range(8)]))
    h3, m3, p3 = cache.match(np.concatenate([branch[:10], [7, 7]]))
    trace.append((h3, m3, None if p3 is None else (p3.page, p3.r)))
    # slots let go; eviction is LRU over leaves and skips excluded pages
    pool.recycle(pool.decref(pages))
    pool.recycle(pool.decref(bp))
    trace.append((pool.available(), [pool.refcount(p) for p in range(8)]))
    freed = cache.evict(2, exclude={bp[2]})
    trace.append((freed, sorted(recycled), len(cache)))
    freed = cache.evict(10)
    assert len(cache) == 0 and pool.available() + len(recycled) == 8
    assert sorted(recycled) == sorted(set(pages) | set(bp))
    trace.append((freed, list(recycled)))
    return trace


def test_port_prefix_cache_traces_jax():
    """The same operations on both packages' classes give the same match
    pages, partial hits, eviction order and refcounts."""
    assert _prefix_trace(kv_pool) == _prefix_trace(jax_kv_pool)


def test_page_pool_traces_jax():
    def trace(mod):
        pool, out = mod.PagePool(5), []
        a = pool.alloc(3)
        out += [a, pool.alloc(3), pool.available()]
        pool.incref(a[1])
        out.append(pool.decref(a))
        pool.recycle(out[-1])
        out += [pool.alloc(4), [pool.refcount(p) for p in range(5)],
                pool.allocated()]
        return out

    assert trace(kv_pool) == trace(jax_kv_pool)


# ------------------------------------- cached attention at row offsets


def _jax_cached_forward(jm, base):
    """The JAX model over paged caches as one jitted program, as its
    engine runs it (``paddle_tpu/models/serving.py`` ``write_prompts``):
    (ids, k pools, v pools, tables[, per-row bases]) -> (logits, pools).
    ``base`` 0 is the static-offset prefill; None takes per-row bases."""
    import jax

    from paddle_tpu.jit import _FunctionalModel
    from paddle_tpu.models.generation import _make_paged_cache

    functional = _FunctionalModel(jm)
    params = {k: p._value for k, p in jm.named_parameters()}
    buffers = {k: b._value for k, b in jm.named_buffers()}
    key = jax.random.key_data(jax.random.PRNGKey(0))

    def run(ids, ks, vs, tables, bases=None):
        length = base if base is not None else bases
        caches = [_make_paged_cache(k, v, tables, 16, length)
                  for k, v in zip(ks, vs)]
        (logits, out), _ = functional(params, buffers, (ids,),
                                      {"caches": caches}, key)
        return logits, [c.k_pages for c in out], [c.v_pages for c in out]

    return jax.jit(run)


def test_cached_attention_at_per_row_offsets_matches_jax(models):
    """A 21-token prefill at offset 0, then two 8-token chunks at per-row
    bases (16, 21) and (24, 29): mid-page writes into 16-token pages,
    attention over the gathered pages with a dense per-row mask. Each
    chunk's logits within 1e-5 of the JAX model's on the same cache
    operations (jitted, as the JAX engine runs them)."""
    jm, tm = models
    rng = np.random.RandomState(3)
    ids = rng.randint(0, 128, (2, 37)).astype(np.int32)
    jc = [JaxPagedKVCache(2, 64, 2, 16, page_size=16) for _ in range(2)]
    ks, vs, tables = [c.k_pages for c in jc], [c.v_pages for c in jc], \
        jc[0].tables
    tc = [PagedKVCache(2, 64, 2, 16, page_size=16, device="cpu",
                       dtype=torch.float32) for _ in range(2)]
    want, got = [], []
    logits, ks, vs = _jax_cached_forward(jm, 0)(ids[:, :21], ks, vs, tables)
    want.append(np.asarray(logits))
    with torch.no_grad():
        got.append(tm(torch.tensor(ids[:, :21]), caches=tc).numpy())
    chunk_fwd = _jax_cached_forward(jm, None)
    bases = np.array([16, 21], np.int32)
    for step in range(2):
        for c in tc:
            c.length = torch.tensor(bases)
        chunk = np.stack([ids[0, bases[0]:bases[0] + 8],
                          ids[1, bases[1]:bases[1] + 8]])
        logits, ks, vs = chunk_fwd(chunk, ks, vs, tables, bases)
        want.append(np.asarray(logits))
        with torch.no_grad():
            got.append(tm(torch.tensor(chunk), caches=tc).numpy())
        bases = bases + 8
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                   err_msg=f"call {i}")
    assert [int(x) for x in tc[0].length] == [32, 37]


# ------------------------------------------------------- engine parity

ENGINE = dict(max_slots=3, max_len=128, page_size=16, prompt_buckets=(8, 32),
              seed=0, prefix_cache=True, pool_pages=13)
NEW = 20


def _traffic():
    """Request 0 (70 tokens, chunked) is admitted alone first, so its
    pages are cached when the rest arrive: request 1 shares its first 37
    tokens (a mid-page divergence: two shared pages and a CoW copy of the
    third, resumed at base 37), request 2 is a 90-token prompt of its own
    (chunked), requests 3-5 are short. 13 pages for 3 slots force
    deferrals and preemptions."""
    rng = np.random.RandomState(12)
    pre = rng.randint(0, 128, (40,)).astype(np.int32)
    first = np.concatenate([pre, rng.randint(0, 128, (30,))]).astype(np.int32)
    rest = [np.concatenate([pre[:37], rng.randint(0, 128, (9,))]),
            rng.randint(0, 128, (90,)), rng.randint(0, 128, (6,)),
            rng.randint(0, 128, (12,)), rng.randint(0, 128, (20,))]
    return [first] + [p.astype(np.int32) for p in rest]


def _drive(eng, prompts):
    """Submit the first request and run one step, then submit the rest
    and step to the end. Returns the requests."""
    eng.start(segment=4)
    reqs = [eng.submit(prompts[0], NEW, rid=0)]
    eng.step()
    reqs += [eng.submit(p, NEW, rid=i + 1) for i, p in enumerate(prompts[1:])]
    while eng.has_work():
        eng.step()
    return reqs


@pytest.fixture(scope="module")
def engines(models):
    """Both serial engines on ``_traffic``: JAX's (its megakernel off:
    the ``jit/fusion.py`` defect at these widths) and the port's, fused
    by default. Returns (prompts, JAX run, port run), each run the
    requests, kv_stats() and counter deltas."""
    jm, tm = models
    prompts = _traffic()
    flags = paddle.get_flags(["FLAGS_decode_megakernel"])
    paddle.set_flags({"FLAGS_decode_megakernel": 0})
    try:
        before = dict(jax_resilience.counters())
        eng = JaxEngine(jm, pipeline=False, **ENGINE)
        reqs = _drive(eng, prompts)
        after = jax_resilience.counters()
        jax_run = (reqs, eng.kv_stats(),
                   {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS})
    finally:
        paddle.set_flags(flags)
    before = resilience.counters()
    eng = ContinuousBatchingEngine(tm, pipeline=False, **ENGINE)
    reqs = _drive(eng, prompts)
    after = resilience.counters()
    port_run = (reqs, eng.kv_stats(),
                {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS},
                eng.stats())
    return prompts, jax_run, port_run


def test_engine_matches_jax_engine(models, engines):
    """One test reads the fixture, so that pytest-xdist runs the two
    engines once: token-identical greedy streams (each choice above
    ``MIN_GAP``), equal statuses, equal ``kv_stats()`` pool fields and
    equal counter deltas, on traffic that took every admission route."""
    _, tm = models
    prompts, (jreqs, jkv, jcount), (treqs, tkv, tcount, stats) = engines
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert all(r.status == "ok" for r in treqs)
    for i, (t, j) in enumerate(zip(treqs, jreqs)):
        np.testing.assert_array_equal(t.output(), j.output(),
                                      err_msg=f"request {i}")
        assert len(t.output()) == NEW
        assert _min_top2_gap(tm, prompts[i], t.output()) > MIN_GAP, i
    d = stats["dispatches"]
    assert d["chunk"] and d["final_chunk"] and d["resume"] and d["cow_pages"]
    assert stats["megakernel"]
    assert {k: tkv[k] for k in POOL_FIELDS} == {k: jkv[k] for k in POOL_FIELDS}
    assert tcount == jcount
    assert tcount["serving.kv_preempted"] > 0
    assert tcount["serving.kv_pool_exhausted"] > 0
    assert tkv["prefix_tokens_saved"] > 0
