"""The port's decode megakernel against the JAX package's.

Kernel level: the same numpy inputs (a seed, heads 4, kv heads 2, head dim
8, pages of 16, as ``tests/test_decode_megakernel.py`` builds them) go
through the JAX ``fused_decode_layer`` (the Pallas kernel in interpret
mode), the JAX ``reference_decode_layer`` (the unfused composition) and the
port's ``fused_decode_layer_plain``, in f32. Tolerance: atol and rtol 1e-5;
the frameworks sum the projections and the softmax in different orders,
which moves f32 results by ~1e-6.

Engine level: the tiny GQA LLaMA of ``tests/test_torch_llama.py`` with the
JAX model's weights. The port's engine takes the fused path on the CPU by
default (the fused plain version); its greedy streams equal the JAX
engine's unfused program and the port's own ``decode_megakernel=0``
engine, with every compared choice's top-2 logit gap above ``MIN_GAP``,
far above that noise.

Probes: the port keeps the JAX probe's structural checks and replaces its
12 MiB VMEM budget with the CUDA kernel's limits, so the 438M widths that
the JAX probe declines are taken by the port.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models.serving import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.ops.pallas import decode_megakernel as jax_mk
from paddle_tpu_torch.models import (
    ContinuousBatchingEngine,
    LlamaConfig,
    LlamaForCausalLM,
    params_from_paddle_tpu,
)
from paddle_tpu_torch.models import llama as llama_mod
from paddle_tpu_torch.ops.cuda import decode_megakernel as mk


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


ATOL = RTOL = 1e-5
MIN_GAP = 1e-4
CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=128)
ENGINE = dict(max_slots=3, max_len=64, page_size=16, prompt_buckets=(8, 16))
SEGMENT = 4


def _case(seed, lens, heads=4, kvh=2, d=8, page=16, pages_per_seq=8,
          extra_pages=3):
    """Numpy inputs of one layer: random weights and a paged pool whose
    tables give each sequence distinct pages; the last page is the dump
    page, in no table."""
    rng = np.random.RandomState(seed)
    b, hidden = len(lens), heads * d
    npages = b * pages_per_seq + extra_pages

    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    pos = np.arange(page * pages_per_seq + 1)[:, None]
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2) / d))
    ang = np.concatenate([pos * inv, pos * inv], axis=-1)
    case = dict(
        x=w(b, 1, hidden), ln1_weight=w(hidden) + 1.0, ln1_eps=1e-6,
        wq=w(hidden, heads * d), wk=w(hidden, kvh * d),
        wv=w(hidden, kvh * d), wo=w(heads * d, hidden),
        rope_cos=np.cos(ang).astype(np.float32),
        rope_sin=np.sin(ang).astype(np.float32),
        ln2_weight=w(hidden) + 1.0, ln2_eps=1e-6,
        k_pages=w(npages, page, kvh, d), v_pages=w(npages, page, kvh, d),
        tables=rng.permutation(npages - 1)[:b * pages_per_seq]
        .reshape(b, pages_per_seq).astype(np.int32),
        lengths=np.asarray(lens, np.int32), heads=heads)
    return case, npages - 1


def _jax_args(case):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in case.items()}


@functools.lru_cache(maxsize=None)
def _reference(lens, kvh, pages_per_seq, heads=4, d=8):
    """JAX ``reference_decode_layer`` outputs as numpy (shared by both
    flush modes), jitted once per case: its eager ops would each compile
    on their own."""
    case, _ = _case(3, list(lens), heads=heads, kvh=kvh, d=d,
                    pages_per_seq=pages_per_seq)
    args = _jax_args(case)
    static = {k: args.pop(k) for k in ("heads", "ln1_eps", "ln2_eps")}
    ref = jax.jit(functools.partial(jax_mk.reference_decode_layer, **static))
    return [np.asarray(a) for a in ref(**args)]


def _port(case, dump_page):
    args = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in case.items()}
    h_mid, y2 = mk.fused_decode_layer(**args, dump_page=dump_page)
    return [t.numpy() for t in (h_mid, y2, args["k_pages"], args["v_pages"])]


def _assert_outputs(got, want, keep, label):
    for name, g, w in zip(("h_mid", "y2"), got[:2], want[:2]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{label}: {name}")
    for name, g, w in zip(("k_pages", "v_pages"), got[2:], want[2:]):
        np.testing.assert_allclose(g[keep], np.asarray(w)[keep], atol=ATOL,
                                   rtol=RTOL, err_msg=f"{label}: {name}")


@pytest.mark.parametrize("kvh,lens,mode,heads,d", [
    pytest.param(kvh, lens, mode, 4, 8, id=f"{kvh}-lens{i}-{mode}")
    for i, (kvh, lens, mode) in enumerate(
        [(kvh, lens, mode)
         for lens in ((0, 5), (15, 16, 0, 31), (127, 1, 64, 33))
         for kvh, mode in ((2, "dump"), (2, "writeback"))]
        + [(1, (17,), "dump")])] + [
    # a GQA group of 12 (12 heads of 8 on one kv head), and a head dim
    # that is not a multiple of 8
    pytest.param(1, (17, 40), "dump", 12, 8, id="group12"),
    pytest.param(2, (15, 33), "writeback", 4, 12, id="d12")])
def test_plain_matches_jax_megakernel_and_reference(kvh, lens, mode, heads,
                                                    d):
    """Fresh sequences (length 0), appends at and across page boundaries,
    near-full depths, one kv head, a group of 12 and D = 12: the port's
    plain version equals the unfused reference and, but at D = 12, the
    Pallas kernel (interpret mode) in the dump-page and the write-back
    flush modes. The Pallas kernel's dump page absorbs garbage by design,
    so it is left out of that comparison."""
    pps = max(n // 16 for n in lens) + 2
    case, dump = _case(3, list(lens), heads=heads, kvh=kvh, d=d,
                       pages_per_seq=pps)
    dump_page = dump if mode == "dump" else None
    got = _port(case, dump_page)
    keep = np.ones(case["k_pages"].shape[0], bool)
    _assert_outputs(got, _reference(lens, kvh, pps, heads, d), keep,
                    "reference")
    if d != 8:  # D = 12 against the reference alone, to keep the suite fast
        return
    want = jax_mk.fused_decode_layer(**_jax_args(case), dump_page=dump_page,
                                     interpret=True)
    if mode == "dump":
        keep[dump] = False
    _assert_outputs(got, want, keep, "pallas")


def test_dump_page_changes_nothing_in_the_port():
    case, dump = _case(5, [15, 16, 0, 31], pages_per_seq=4)
    for a, b in zip(_port(case, dump), _port(case, None)):
        np.testing.assert_array_equal(a, b)


def test_append_past_the_table_is_skipped_and_attention_capped():
    """A depth whose page lies past the table stores nothing; attention
    reads only the first ``attn_pages`` columns, as the unfused paged
    attention does."""
    case, _ = _case(6, [40, 64], pages_per_seq=4)
    args = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in case.items()}
    k0 = args["k_pages"].clone()
    args["tables"] = args["tables"][:, :2].contiguous()  # 32 positions
    mk.fused_decode_layer(**args, attn_pages=1)
    assert torch.equal(args["k_pages"], k0)
    case, _ = _case(6, [20, 30], pages_per_seq=4)
    full = _port(case, None)
    args = {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in case.items()}
    capped = mk.fused_decode_layer(**args, attn_pages=1)
    # both rows' positions 16.. are cut off: the outputs change
    assert not np.allclose(capped[0].numpy(), full[0])


# ------------------------------------------------------------ the engine


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jm = JaxLlamaForCausalLM(JaxLlamaConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu",
                          dtype=torch.float32)
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}, tm)
    return jm, tm


@pytest.fixture(scope="module")
def engines(models):
    """Greedy streams of the JAX engine (unfused program), the port's
    fused engine (with a spy on the fused layer) and the port's unfused
    engine: 7 requests of mixed lengths on 3 slots, so slots retire,
    readmit and idle on the dump page."""
    jm, tm = models
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 128, (n,)).astype(np.int32)
               for n in (5, 11, 3, 16, 9, 14, 7)]
    flags = paddle.get_flags(["FLAGS_decode_megakernel"])
    paddle.set_flags({"FLAGS_decode_megakernel": 0})
    try:
        want, _ = JaxEngine(jm, **ENGINE).run(prompts, max_new_tokens=10,
                                              segment=SEGMENT)
    finally:
        paddle.set_flags(flags)
    out = {}
    for mode in (1, 0):
        calls = []

        def spy(*args, **kw):
            calls.append(kw["lengths"].clone())
            return mk.fused_decode_layer(*args, **kw)

        eng = ContinuousBatchingEngine(tm, decode_megakernel=mode, **ENGINE)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(llama_mod, "fused_decode_layer", spy)
            got, stats = eng.run(prompts, max_new_tokens=10, segment=SEGMENT)
        out[mode] = (eng, got, stats, calls)
    return prompts, want, out


def _min_top2_gap(model, prompt, tokens):
    seq = np.concatenate([prompt, tokens[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits = model(torch.tensor(seq[None]))[0, prompt.size - 1:]
    top2 = torch.topk(logits, 2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


def test_fused_engine_streams_match_jax_and_unfused_engines(models, engines):
    _, tm = models
    prompts, want, out = engines
    _, fused, fstats, _ = out[1]
    _, unfused, ustats, _ = out[0]
    assert fstats["megakernel"] is True and ustats["megakernel"] is False
    assert fstats["statuses"] == ["ok"] * len(prompts)
    for i, (w, f, u) in enumerate(zip(want, fused, unfused)):
        np.testing.assert_array_equal(f, w, err_msg=f"request {i} vs JAX")
        np.testing.assert_array_equal(f, u, err_msg=f"request {i} vs "
                                                    f"unfused")
        assert _min_top2_gap(tm, prompts[i], f) > MIN_GAP, f"request {i}"


def test_fused_engine_pools_equal_unfused_engine_pools(engines):
    _, _, out = engines
    feng, ueng = out[1][0], out[0][0]
    keep = np.ones(feng._ks[0].shape[0], bool)
    keep[feng._dump_page] = False  # idle rows store there in any order
    for i in range(feng._nl):
        for f, u in ((feng._ks[i], ueng._ks[i]), (feng._vs[i], ueng._vs[i])):
            np.testing.assert_allclose(f.numpy()[keep], u.numpy()[keep],
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"layer {i}")


def test_fused_layer_runs_once_per_layer_per_decode_step(engines):
    _, _, out = engines
    _, _, fstats, fcalls = out[1]
    _, _, _, ucalls = out[0]
    steps = fstats["segments"] * SEGMENT
    assert len(fcalls) == CFG["num_hidden_layers"] * steps
    assert all(c.shape == (ENGINE["max_slots"],) for c in fcalls)
    assert ucalls == []


def test_probe_declines_outside_an_engine_scope(models):
    _, tm = models
    layer = tm.model.layers[0]
    cache = llama_mod.PagedKVCache(2, 32, 2, 16, page_size=16, device="cpu",
                                   dtype=torch.float32)
    cache.length = torch.tensor([3, 5], dtype=torch.int32)
    x = torch.zeros((2, 1, 64))
    assert mk.megakernel_supported(layer, cache)
    assert not layer._megakernel_step(x, cache)  # no scope: never fires
    with mk.megakernel_scope(True):
        assert layer._megakernel_step(x, cache)
        with mk.megakernel_scope(False):
            assert not layer._megakernel_step(x, cache)
        cache.length = 3  # one depth for every row: the unfused path
        assert not layer._megakernel_step(x, cache)


# ------------------------------------------------------------ the probes


def _pair(**over):
    cfg = {**CFG, "num_hidden_layers": 1, **over}
    paddle.seed(1)
    jm = JaxLlamaForCausalLM(JaxLlamaConfig(**cfg))
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu",
                          dtype=torch.float32)
    return jm, tm


def test_probes_accept_the_tiny_config(models):
    jm, tm = models
    assert jax_mk.megakernel_model_supported(jm)
    assert mk.megakernel_model_supported(tm)


def test_probes_differ_at_the_438m_widths():
    """The one intended difference: at hidden 1536 and 12 heads of 128 the
    q/k/v/o weights (18.9 MB in bf16) exceed the JAX probe's 12 MiB VMEM
    budget (decode_megakernel.py:69-71, :151-156), and the port, whose
    kernels stream the weights, takes the layer; in f32 and in bf16 it is
    within the CUDA kernels' limits too, and so are head dim 96 and a
    group of 12. A hidden size past ``MAX_HIDDEN`` (8192) is declined."""
    jm, tm = _pair(hidden_size=1536, num_attention_heads=12,
                   num_key_value_heads=12,
                   max_position_embeddings=256)
    assert not jax_mk.megakernel_model_supported(jm)
    assert mk.megakernel_model_supported(tm)
    layer = tm.model.layers[0]
    norms = (layer.input_layernorm, layer.post_attention_layernorm)
    for dtype in (torch.float32, torch.bfloat16):
        layer.to(dtype)
        assert mk._kernel_takes(layer.self_attn, norms, 128, 1536)
        assert mk._kernel_takes(layer.self_attn, norms, 96, 1536)
        assert not mk._kernel_takes(layer.self_attn, norms, 128, 8192)
    tm = LlamaForCausalLM(LlamaConfig(**{  # a group of 12
        **CFG, "num_hidden_layers": 1, "hidden_size": 96,
        "num_attention_heads": 12, "num_key_value_heads": 1}), device="cpu",
        dtype=torch.float32)
    assert mk.megakernel_model_supported(tm)


def test_card_probe_takes_every_dtype_head_dim_and_group():
    """The card probe's limits are the kernels' own: one float type
    throughout (bf16 or f32), any even head dim up to 256 and any group
    (the structural probe checks those two), and a hidden size that is a
    multiple of 8 up to ``MAX_HIDDEN``; f16, a mix of types, a hidden past
    ``MAX_HIDDEN`` or off the multiple of 8 are declined."""
    def layer(dtype, ln_dtype=None):
        w = lambda dt: types.SimpleNamespace(weight=torch.empty(2, dtype=dt))
        attn = types.SimpleNamespace(q_proj=w(dtype), k_proj=w(dtype),
                                     v_proj=w(dtype), o_proj=w(dtype))
        return attn, (w(ln_dtype or dtype), w(ln_dtype or dtype))

    for dtype in (torch.bfloat16, torch.float32):
        attn, norms = layer(dtype)
        for d in range(2, mk.MAX_HEAD_DIM + 1, 2):
            for hidden in (8, 1536, mk.MAX_HIDDEN):
                assert mk._kernel_takes(attn, norms, d, hidden), (dtype, d)
        assert not mk._kernel_takes(attn, norms, 128, mk.MAX_HIDDEN + 8)
        assert not mk._kernel_takes(attn, norms, 128, 1540)
        assert not mk._kernel_takes(attn, norms, 2 * mk.MAX_HEAD_DIM, 1536)
    assert not mk._kernel_takes(*layer(torch.float16), 128, 1536)
    assert not mk._kernel_takes(*layer(torch.bfloat16, torch.float32), 128,
                                1536)


def test_probes_decline_a_biased_projection():
    jm, tm = _pair()
    jm.model.layers[0].self_attn.q_proj.bias = paddle.zeros([64])
    tm.model.layers[0].self_attn.q_proj.bias = torch.nn.Parameter(
        torch.zeros(64))
    assert not jax_mk.megakernel_model_supported(jm)
    assert not mk.megakernel_model_supported(tm)


def test_probes_decline_heads_not_divisible_by_kv_heads():
    jm, tm = _pair(num_key_value_heads=3)
    assert not jax_mk.megakernel_model_supported(jm)
    assert not mk.megakernel_model_supported(tm)
    eng = ContinuousBatchingEngine(tm, **ENGINE)
    assert eng.stats()["megakernel"] is False


def test_engine_decides_once_and_subclasses_can_opt_out(models):
    """The decision is made at construction; a subclass whose o_proj
    output is a partial sum sets ``_megakernel_ok = False``."""
    _, tm = models

    class PartialSumEngine(ContinuousBatchingEngine):
        _megakernel_ok = False

    assert ContinuousBatchingEngine(tm, **ENGINE).stats()["megakernel"]
    assert not PartialSumEngine(tm, **ENGINE).stats()["megakernel"]
    assert not ContinuousBatchingEngine(
        tm, decode_megakernel=0, **ENGINE).stats()["megakernel"]
