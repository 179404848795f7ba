"""The serving engine's default scheduler, the one-deep pipeline: the
port's pipelined engine against JAX's pipelined engine, and against the
port's own serial engine (``pipeline=False``).

A tiny GQA LLaMA (hidden 64, 4 heads, 2 kv heads, 2 layers) is built by
``paddle_tpu`` from a seed and carried into the port by
``params_from_paddle_tpu``; both run in f32 on the CPU, where the port's
decode segment runs eagerly and "in flight" means computed and not yet
consumed, so every scheduling decision of the pipeline runs here. Greedy
streams against JAX are token-identical, each choice with a top-2 logit
gap of at least ``MIN_GAP`` (far above the ~1e-6 the two frameworks
differ by); the port against itself is bit-identical, greedy and sampled.
The drills follow JAX's ``tests/test_serving_pipeline.py``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import resilience as jax_resilience
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models.serving import (
    ContinuousBatchingEngine as JaxEngine,
)
from paddle_tpu_torch.core import Deadline, counters, reset_counters
from paddle_tpu_torch.models import (
    ContinuousBatchingEngine,
    LlamaConfig,
    LlamaForCausalLM,
    params_from_paddle_tpu,
)

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
# 13 pages of 16 for 3 slots of 128: admissions defer and one request is
# preempted once (JAX folds a twice-preempted request's tokens twice)
ENGINE = dict(max_slots=3, max_len=128, page_size=16, prompt_buckets=(8, 32),
              seed=0, prefix_cache=True, pool_pages=13)
NEW = 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's torch work on one intra-op thread: the engine's eager
    steps are loops of small ops, and under pytest-xdist each worker's
    thread pool otherwise spin-waits against the others'."""
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


def _traffic():
    """Request 0 (70 tokens, chunked) is admitted alone first, so its
    pages are cached when the rest arrive: request 1 shares its first 37
    tokens (two shared pages and a copy-on-write copy of the third),
    request 2 is a 90-token prompt of its own (chunked), requests 3-5 are
    short."""
    rng = np.random.RandomState(12)
    pre = rng.randint(0, 128, (40,)).astype(np.int32)
    first = np.concatenate([pre, rng.randint(0, 128, (30,))]).astype(np.int32)
    rest = [np.concatenate([pre[:37], rng.randint(0, 128, (9,))]),
            rng.randint(0, 128, (90,)), rng.randint(0, 128, (6,)),
            rng.randint(0, 128, (12,)), rng.randint(0, 128, (20,))]
    return [first] + [p.astype(np.int32) for p in rest]


def _drive(eng, prompts, new=NEW, segment=4):
    """Submit the first request and run one step, then submit the rest
    and step to the end. Returns the requests."""
    eng.start(segment=segment)
    reqs = [eng.submit(prompts[0], new, rid=0)]
    eng.step()
    reqs += [eng.submit(p, new, rid=i + 1) for i, p in enumerate(prompts[1:])]
    while eng.has_work():
        eng.step()
    return reqs


def _min_top2_gap(model, prompt, tokens):
    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits = model(torch.tensor(seq[None]))[0, prompt.size - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def _outputs(reqs):
    return [r.output() for r in reqs]


def _assert_streams_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


# ------------------------------------------------------ against JAX


@pytest.fixture(scope="module")
def jax_parity(models):
    """JAX's pipelined engine (its megakernel off: the ``jit/fusion.py``
    defect at these widths) and the port's default engine on
    ``_traffic`` with an EOS id: the 9th token of request 3's stream in a
    run without one, so that three requests stop early. Returns (prompts,
    eos, JAX run, port run), each run the requests, stats(), kv_stats()
    and counter deltas."""
    jm, tm = models
    prompts = _traffic()
    probe = _drive(ContinuousBatchingEngine(tm, pipeline=False, **ENGINE),
                   prompts)
    eos = int(probe[3].output()[8])
    flags = paddle.get_flags(["FLAGS_decode_megakernel",
                              "FLAGS_serving_pipeline"])
    paddle.set_flags({"FLAGS_decode_megakernel": 0,
                      "FLAGS_serving_pipeline": 1})
    try:
        before = dict(jax_resilience.counters())
        eng = JaxEngine(jm, eos_token_id=eos, **ENGINE)
        reqs = _drive(eng, prompts)
        after = jax_resilience.counters()
        jax_run = (reqs, eng.stats(), eng.kv_stats(),
                   {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS})
    finally:
        paddle.set_flags(flags)
    before = counters()
    eng = ContinuousBatchingEngine(tm, eos_token_id=eos, **ENGINE)
    reqs = _drive(eng, prompts)
    after = counters()
    port_run = (reqs, eng.stats(), eng.kv_stats(),
                {k: after.get(k, 0) - before.get(k, 0) for k in COUNTERS})
    return prompts, eos, jax_run, port_run


def test_pipelined_engine_matches_jax_pipelined_engine(models, jax_parity):
    """Both pipelined: token-identical greedy streams (each choice above
    ``MIN_GAP``), EOS retirements, statuses, segments, counter deltas (one
    preemption, deferred admissions) and ``kv_stats()`` pool fields."""
    _, tm = models
    prompts, eos, (jreqs, jstats, jkv, jcount), (treqs, tstats, tkv,
                                                  tcount) = jax_parity
    assert jstats["pipelined"] and tstats["pipelined"]
    assert [r.status for r in treqs] == [r.status for r in jreqs]
    assert all(r.status == "ok" for r in treqs)
    _assert_streams_equal(_outputs(treqs), _outputs(jreqs))
    stopped = [r for r in treqs if len(r.output()) < NEW]
    assert len(stopped) >= 2 and all(r.output()[-1] == eos for r in stopped)
    for i, r in enumerate(treqs):
        assert _min_top2_gap(tm, prompts[i], r.output()) > MIN_GAP, i
    assert tstats["segments"] == jstats["segments"]
    assert tstats["useful_tokens"] == jstats["useful_tokens"]
    assert tcount == jcount
    assert tcount["serving.kv_preempted"] == 1
    assert tcount["serving.kv_pool_exhausted"] > 0
    assert sum(r.preempted for r in treqs) == 1
    assert {k: tkv[k] for k in POOL_FIELDS} == {k: jkv[k] for k in POOL_FIELDS}
    d = tstats["dispatches"]
    assert d["chunk"] and d["final_chunk"] and d["resume"] and d["cow_pages"]


# ------------------------------------------- against the serial engine


def _both(model, prompts, new, segment=4, **kw):
    """The same run on the port's serial and pipelined engines."""
    out = {}
    for pipeline in (False, True):
        eng = ContinuousBatchingEngine(model, pipeline=pipeline, **kw)
        out[pipeline] = eng.run(prompts, max_new_tokens=new, segment=segment)
    return out[False], out[True]


def _mixed(seed, lengths, vocab=128):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, (n,)).astype(np.int32) for n in lengths]


SMALL = dict(max_slots=3, max_len=128, page_size=32, prompt_buckets=(16, 32))


@pytest.mark.parametrize("mode", ["greedy", "sampled", "eos"])
def test_pipelined_equals_serial(models, mode):
    """Mixed short and chunked prompts, more requests than slots:
    greedy, sampled with temperature, top-k and top-p from per-request
    streams (a speculative segment draws the stream indices past the
    segment in flight), and greedy with EOS retirement."""
    _, tm = models
    prompts = _mixed(0, (5, 70, 11, 3, 33, 9, 14))
    kw = dict(SMALL)
    if mode == "sampled":
        kw.update(do_sample=True, temperature=0.8, top_k=20, top_p=0.9,
                  seed=7)
    if mode == "eos":
        probe, _ = ContinuousBatchingEngine(tm, pipeline=False, **kw).run(
            prompts, max_new_tokens=10, segment=4)
        kw["eos_token_id"] = int(probe[0][2])
    (s_outs, s_stats), (p_outs, p_stats) = _both(tm, prompts, 10, **kw)
    assert s_stats["statuses"] == p_stats["statuses"] == ["ok"] * 7
    assert not s_stats["pipelined"] and p_stats["pipelined"]
    _assert_streams_equal(p_outs, s_outs)
    assert s_stats["useful_tokens"] == p_stats["useful_tokens"]
    if mode == "greedy":
        assert p_stats["useful_tokens"] == 70
    if mode == "sampled":
        g_outs, _ = ContinuousBatchingEngine(tm, **SMALL).run(
            prompts, max_new_tokens=10, segment=4)
        assert any(not np.array_equal(g, s) for g, s in zip(g_outs, s_outs))
    if mode == "eos":
        assert any(len(o) < 10 for o in p_outs)


@pytest.mark.parametrize("do_sample", [False, True])
def test_pipelined_preemption_equals_serial(models, do_sample):
    """A pool of 5 pages of 16 for 4 slots: growth outruns it, the
    pipelined engine preempts (draining the segment in flight first) and
    every stream equals the serial engine's on the same pool."""
    _, tm = models
    prompts = _mixed(7, (6, 6, 6, 6))
    kw = dict(max_slots=4, max_len=80, page_size=16, prompt_buckets=(8,),
              pool_pages=5, do_sample=do_sample, top_k=8, seed=3)
    reset_counters()
    (s_outs, s_stats), (p_outs, p_stats) = _both(tm, prompts, 40, **kw)
    assert s_stats["statuses"] == p_stats["statuses"] == ["ok"] * 4
    assert counters().get("serving.kv_preempted", 0) > 0
    _assert_streams_equal(p_outs, s_outs)
    reset_counters()


def test_pipelined_mid_run_submits_and_aborts_match_serial(models):
    """Requests arriving over time and one abort: the finished requests
    are token-identical; the aborted one's tokens are a prefix of the
    serial engine's (the pipelined host view runs a segment behind)."""
    _, tm = models
    prompts = _mixed(3, (5, 9, 7, 12))

    def drive(pipeline):
        eng = ContinuousBatchingEngine(tm, pipeline=pipeline,
                                       **dict(SMALL, max_slots=2))
        eng.start(segment=4)
        reqs = [eng.submit(prompts[0], 12, rid=0),
                eng.submit(prompts[1], 12, rid=1)]
        eng.step()
        reqs.append(eng.submit(prompts[2], 12, rid=2))  # arrives mid-run
        reqs.append(eng.submit(prompts[3], 30, rid=3))
        eng.step()
        eng.abort(3)
        while eng.has_work():
            eng.step()
        return reqs

    serial, piped = drive(False), drive(True)
    for i in (0, 1, 2):
        assert serial[i].status == piped[i].status == "ok"
        np.testing.assert_array_equal(piped[i].output(), serial[i].output(),
                                      err_msg=f"request {i}")
    assert serial[3].status == piped[3].status == "cancelled"
    st, pt = serial[3].output(), piped[3].output()
    np.testing.assert_array_equal(pt, st[:len(pt)])


def test_abort_in_flight_then_reuse_the_freed_pages(models):
    """The port has no free-page quarantine: a slot aborted while its
    segment is in flight returns its pages at once, and the segment still
    writes into them. A request admitted next is granted those pages; its
    stream equals its stream in a fresh engine, because the stale writes
    run before its own on the engine's one stream."""
    _, tm = models
    p_long, p_next = _mixed(21, (20, 9))
    kw = dict(max_slots=1, max_len=128, page_size=16, prompt_buckets=(8, 32),
              pool_pages=8, prefix_cache=False)
    eng = ContinuousBatchingEngine(tm, **kw)
    eng.start(segment=4)
    victim = eng.submit(p_long, 60, rid=0)
    eng.step()
    eng.step()                   # a speculative segment is now in flight
    assert eng._inflight is not None
    freed = list(eng._slot_pages[0])
    assert eng.abort(0) is victim and victim.status == "cancelled"
    assert eng.kv_stats()["pages_free"] == kw["pool_pages"]
    nxt = eng.submit(p_next, 30, rid=1)
    eng.step()                   # drains, then admits into the freed pages
    assert eng._slot_req[0] is nxt
    assert set(eng._slot_pages[0]) <= set(freed)
    while eng.has_work():
        eng.step()
    fresh = ContinuousBatchingEngine(tm, **kw)
    fresh.start(segment=4)
    want = fresh.submit(p_next, 30, rid=1)
    while fresh.has_work():
        fresh.step()
    assert nxt.status == want.status == "ok"
    np.testing.assert_array_equal(nxt.output(), want.output())


class _ExpiresAfter(Deadline):
    """A deadline that reads expired from its ``n``-th check on."""

    def __init__(self, n):
        super().__init__(None)
        self.checks, self.n = 0, n

    def expired(self):
        self.checks += 1
        return self.checks >= self.n


def test_pipelined_deadlines_and_timeout(models):
    """``timeout_s`` and per-request deadlines retire as the serial
    engine does; a deadline that expires mid-run retires its request with
    a prefix of its serial stream and leaves the others' streams intact,
    and the pool is whole at the end."""
    _, tm = models
    prompts = _mixed(10, (5, 40, 12))
    eng = ContinuousBatchingEngine(tm, **SMALL)
    _, stats = eng.run(prompts, 16, segment=4, timeout_s=0)
    assert stats["statuses"] == ["timed_out"] * 3
    s_outs, _ = ContinuousBatchingEngine(tm, pipeline=False, **SMALL).run(
        prompts, 16, segment=4)
    p_outs, p_dl = eng.run(prompts, 16, segment=4,
                           request_deadline_s=[None, 0, None])
    assert p_dl["statuses"] == ["ok", "timed_out", "ok"]
    for i in (0, 2):
        np.testing.assert_array_equal(p_outs[i], s_outs[i])

    def drive(pipeline):
        e = ContinuousBatchingEngine(tm, pipeline=pipeline, **SMALL)
        e.start(segment=4)
        reqs = [e.submit(p, 16, rid=i, deadline_s=_ExpiresAfter(4)
                         if i == 1 else None)
                for i, p in enumerate(prompts)]
        while e.has_work():
            e.step()
        kv = e.kv_stats()
        return reqs, kv["pages_free"] + kv["prefix_cached_pages"] \
            == kv["pages_total"]

    (serial, s_whole), (piped, p_whole) = drive(False), drive(True)
    assert s_whole and p_whole
    assert [r.status for r in piped] == ["ok", "timed_out", "ok"]
    assert [r.status for r in serial] == ["ok", "timed_out", "ok"]
    for i in (0, 2):
        np.testing.assert_array_equal(piped[i].output(), s_outs[i])
        np.testing.assert_array_equal(serial[i].output(), s_outs[i])
    for r in (serial[1], piped[1]):
        np.testing.assert_array_equal(r.output(),
                                      s_outs[1][:len(r.output())])


def test_warmed_engine_matches_unwarmed(models):
    """``warmup()`` returns JAX's keys (nothing to capture on the CPU) and
    a warmed engine emits what an unwarmed one does, greedy and
    sampled."""
    _, tm = models
    prompts = _mixed(9, (5, 40, 11))
    for kw in (dict(), dict(do_sample=True, temperature=0.9, seed=3)):
        cold, _ = ContinuousBatchingEngine(tm, **SMALL, **kw).run(
            prompts, max_new_tokens=7, segment=3)
        warm = ContinuousBatchingEngine(tm, **SMALL, **kw)
        w = warm.warmup(segment=3)
        assert set(w) == {"programs", "cached", "seconds"}
        assert w["programs"] == 0 and w["cached"] == 0 and w["seconds"] >= 0
        got, _ = warm.run(prompts, max_new_tokens=7, segment=3)
        _assert_streams_equal(got, cold)


def test_pipeline_stats_and_group_widths(models):
    _, tm = models
    prompts = _mixed(10, (6, 6, 6))
    for pipeline, want in ((None, True), (True, True), (False, False)):
        eng = ContinuousBatchingEngine(tm, pipeline=pipeline, **SMALL)
        _, stats = eng.run(prompts, max_new_tokens=8, segment=2)
        assert stats["pipelined"] is want
        assert stats["host_gap_ms"] >= 0.0
        assert stats["host_gap_total_s"] >= 0.0
        assert not eng.has_work()
    assert "host_gap_ms" in ContinuousBatchingEngine.stats.__doc__
    assert ContinuousBatchingEngine(tm, **SMALL).group_widths() == (1, 2, 3)
    assert ContinuousBatchingEngine(
        tm, **dict(SMALL, max_slots=8)).group_widths() == (1, 2, 4, 8)
