"""float32 through the port's serving kernels: RMSNorm, RoPE, the flash
forward and paged decode.

The JAX package's LLaMA is f32 by default and every Pallas kernel is
generic in its dtype, so the port's default model is f32 too and its four
serving kernels have f32 instantiations on the card.

On the CPU (where the port runs its kernels' plain versions): the port's
default model builds f32 parameters as JAX's does, and one decoder layer at
the 438M model's widths (hidden 1536, 12 heads of 128, intermediate 4096;
a one-layer model with a 256-token vocabulary around it) in f32 against
JAX's: a 128-token prefill, which JAX serves with its Pallas flash kernel
in interpret mode, then 3 decode steps through the paged cache (JAX's
Pallas paged_attention in interpret mode), logits within 1e-5 relative L2
(two f32 frameworks summing in other orders agree to ~1e-7).

On the card (the ``cuda`` marker; skipped without one): each f32 kernel
against its plain version at the edge shapes of tests/test_torch_cuda.py
and tests/test_torch_head_dims.py (head dims 32-256, GQA, segments,
lengths 0, 1 and across a page), within 1e-4 + 1e-4 |want| with TF32 off;
each f32 launch counted under ``<kernel>[f32]``; f16 and f64 refused; the
public entries' f32 gradients (the f32 backward kernels, held in full by
tests/test_torch_f32_train.py) equal the plain versions'. These import
neither JAX nor ``paddle_tpu``; run them without the repository's
conftest where JAX is missing::

    python -m pytest --noconftest -q -p no:cacheprovider -m cuda tests/test_torch_f32.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM, PagedKVCache

# one decoder layer at the 438M widths (chip_smoke.py CFG_438M); the vocab
# is cut so that the head stays small
CFG = dict(vocab_size=256, hidden_size=1536, intermediate_size=4096,
           num_hidden_layers=1, num_attention_heads=12,
           max_position_embeddings=512)
REL_L2 = 1e-5
PREFILL, DECODE_STEPS = 128, 3
RTOL = ATOL = 1e-4  # the card cases: f32 kernel vs f32 plain version


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
    from paddle_tpu_torch.models import params_from_paddle_tpu

    paddle.seed(0)
    jm = JaxLlamaForCausalLM(JaxLlamaConfig(**CFG))
    tm = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    params_from_paddle_tpu(
        {k: np.asarray(v) for k, v in jm.raw_state()[0].items()}, tm)
    return jm, tm


def test_default_model_is_f32_as_in_jax(models):
    """``LlamaForCausalLM(cfg)`` builds f32 parameters, the JAX model's
    dtype (``LlamaConfig(dtype="float32")``); bf16 is asked for by name."""
    jm, tm = models
    jax_dtypes = {str(np.asarray(v).dtype)
                  for v in jm.raw_state()[0].values()}
    assert jax_dtypes == {"float32"}
    assert tm.dtype == torch.float32
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    bf = LlamaForCausalLM(LlamaConfig(**{**CFG, "hidden_size": 64,
                                         "intermediate_size": 128,
                                         "num_attention_heads": 4}),
                          device="cpu", dtype=torch.bfloat16)
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}


def test_layer_at_438m_widths_prefill_and_decode_match_jax(models,
                                                           monkeypatch):
    """A 128-token prefill (JAX: the Pallas flash kernel, interpret mode)
    and 3 decode steps through the paged cache (JAX: Pallas
    paged_attention, interpret mode), f32 in both, logits within 1e-5
    relative L2 at every position."""
    import paddle_tpu as paddle
    from paddle_tpu.models.llama import PagedKVCache as JaxPagedKVCache
    from paddle_tpu.ops.pallas import decode_attention as jda
    from paddle_tpu.ops.pallas import flash_attention as jfa

    calls = {"flash": 0, "paged": 0}

    def spy(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(jfa, "flash_attention",
                        spy("flash", jfa.flash_attention))
    monkeypatch.setattr(jda, "paged_attention",
                        spy("paged", jda.paged_attention))
    jm, tm = models
    cfg = tm.config
    b, total = 2, PREFILL + DECODE_STEPS
    ids = np.random.RandomState(3).randint(0, CFG["vocab_size"],
                                           (b, total)).astype(np.int32)
    jc = [JaxPagedKVCache(b, 256, cfg.num_key_value_heads, cfg.head_dim,
                          page_size=128)]
    tc = [PagedKVCache(b, 256, cfg.num_key_value_heads, cfg.head_dim,
                       page_size=128, device="cpu", dtype=torch.float32)]
    want = [np.asarray(jm(paddle.to_tensor(ids[:, :PREFILL]),
                          caches=jc)[0]._value)]
    with torch.no_grad():
        got = [tm(torch.tensor(ids[:, :PREFILL]), caches=tc).numpy()]
        for t in range(PREFILL, total):
            want.append(np.asarray(jm(paddle.to_tensor(ids[:, t:t + 1]),
                                      caches=jc)[0]._value))
            got.append(tm(torch.tensor(ids[:, t:t + 1]), caches=tc).numpy())
    assert calls == {"flash": 1, "paged": DECODE_STEPS}  # JAX's kernels
    assert jc[0].length == tc[0].length == total
    assert [g.dtype for g in got] == [np.float32] * len(got)
    rel = [_rel_l2(g, w) for g, w in zip(got, want)]
    assert max(rel) <= REL_L2, rel
    # the pools hold the same keys and values
    np.testing.assert_allclose(tc[0].k_pages.numpy(),
                               np.asarray(jc[0].k_pages), rtol=0, atol=1e-5)


def _e2_inputs(kernel, rng):
    """f32 numpy inputs of one serving kernel at e2's shapes (the 438M's
    widths): RMSNorm on a decode step's (8, 1536) rows with weight and
    bias, RoPE and the flash forward on a bucket-128 prefill of 12 heads
    of 128, paged decode of 8 slots in the engine's pool layout (page
    128, 4 columns and a dump page, lengths 9-183)."""
    if kernel == "rms_norm":
        return (rng.randn(8, 1536), 1.0 + 0.1 * rng.randn(1536),
                0.1 * rng.randn(1536))
    if kernel in ("rope", "flash"):
        return tuple(rng.randn(2, 128, 12, 128) for _ in range(3))
    b, page, cols = 8, 128, 4
    n_pages = b * cols + 1
    lens = rng.randint(9, 184, b)
    tables = np.full((b, cols + 1), n_pages - 1, np.int32)
    perm, used = rng.permutation(b * cols), 0
    for i, n in enumerate(lens):
        tables[i, :-(-n // page)] = perm[used:used - (-n // page)]
        used -= -n // page
    return (rng.randn(b, 12, 128), rng.randn(n_pages, page, 12, 128),
            rng.randn(n_pages, page, 12, 128), tables, lens)


@pytest.mark.parametrize("kernel", ["rms_norm", "rope", "flash", "paged"])
def test_f32_serving_kernels_match_pallas_at_e2_shapes(kernel):
    """Each serving kernel's module in f32 (its plain version, as the CPU
    runs it) against the JAX Pallas kernel in interpret mode on the same
    numpy inputs, within 2e-5 (f32 sums in other orders)."""
    import jax.numpy as jnp
    from paddle_tpu.ops.pallas import decode_attention as jda
    from paddle_tpu.ops.pallas import flash_attention as jfa
    from paddle_tpu.ops.pallas import fused_ops as jfo
    from paddle_tpu.ops.pallas import rms_norm as jrn
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    ins = [a.astype(np.float32) if a.dtype == np.float64 else a.astype(
        np.int32) for a in _e2_inputs(kernel, np.random.RandomState(9))]
    t = [torch.from_numpy(a) for a in ins]
    j = [jnp.asarray(a) for a in ins]
    if kernel == "rms_norm":
        got = [rn.rms_norm_rows(*t, epsilon=1e-6)[0]]
        want = [jrn.rms_norm(*j, 1e-6, True)]
    elif kernel == "rope":
        cos, sin = _rope_tables(128, 512, 10000.0, "cpu")
        pos = torch.arange(128, dtype=torch.int32).expand(2, 128)
        got = fo.fused_rope_at(t[0], t[1], cos, sin, pos.contiguous())
        want = jfo.fused_rope(j[0], j[1], jnp.asarray(cos[:128].numpy()),
                              jnp.asarray(sin[:128].numpy()))
    elif kernel == "flash":
        got = fa.flash_attention_fwd(*t, causal=True)
        o, lse = jfa._fwd(*(jnp.swapaxes(a, 1, 2) for a in j), True,
                          1.0 / np.sqrt(128))
        want = [jnp.swapaxes(o, 1, 2), lse[..., 0]]
    else:
        got = [da.paged_attention(*t, pages_per_seq=4)]
        want = [jda.paged_attention(*j, pages_per_seq=4)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)


# ------------------------------------------------------------ on the card

@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _launched(name):
    from paddle_tpu_torch.ops.cuda import launch_counts

    return launch_counts[name]


@pytest.mark.cuda
@pytest.mark.parametrize("affine", ["weight", "weight+bias", "bias", "none"])
@pytest.mark.parametrize("n,d,aligned", [(1, 64, True), (8, 1536, True),
                                         (37, 100, True), (5, 2048, True),
                                         (3, 3072, True), (3, 1536, False)])
def test_f32_rms_norm_kernel(gen, n, d, aligned, affine):
    """The vector kernel (D a multiple of 4 up to 2048, aligned) and the
    strided one (D = 100, D = 3072, x off 16-byte alignment)."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    x = (_randn(gen, n * d + 1)[1:].view(n, d) if not aligned
         else _randn(gen, n, d))
    w = _randn(gen, d) if "weight" in affine else None
    b = _randn(gen, d) if "bias" in affine else None
    launch_counts.clear()
    y, r = rn.rms_norm_rows(x, w, b, epsilon=1e-5)
    assert _launched("rms_norm[f32]") == 1 and _launched("rms_norm") == 0
    py, pr = rn.rms_norm_plain(x, w, b, epsilon=1e-5)
    _close(y, py)
    torch.testing.assert_close(r, pr, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,kvh,d", [(2, 7, 4, 2, 64), (3, 1, 16, 2, 128),
                                         (8, 128, 12, 12, 128),
                                         (2, 9, 32, 32, 96),
                                         (1, 5, 4, 2, 256), (2, 3, 4, 4, 32)])
def test_f32_rope_kernel(gen, b, s, h, kvh, d):
    """Both directions, positions outside the table (clamped), and k =
    None."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import launch_counts

    cos, sin = _rope_tables(d, 64, 10000.0, "cuda")
    q, k = _randn(gen, b, s, h, d), _randn(gen, b, s, kvh, d)
    pos = torch.randint(-3, 70, (b, s), generator=gen, device="cuda",
                        dtype=torch.int32)
    launch_counts.clear()
    for inverse in (False, True):
        for got, want in zip(fo.fused_rope_at(q, k, cos, sin, pos, inverse),
                             fo.fused_rope_plain(q, k, cos, sin, pos,
                                                 inverse)):
            _close(got, want)
        got, none = fo.fused_rope_at(q, None, cos, sin, pos, inverse)
        assert none is None
        _close(got, fo.fused_rope_plain(q, None, cos, sin, pos, inverse)[0])
    assert _launched("fused_rope[f32]") == _launched("fused_rope_bwd[f32]") == 2
    assert _launched("fused_rope") == _launched("fused_rope_bwd") == 0


@pytest.mark.cuda
@pytest.mark.parametrize("h,kvh,d,page,pps", [(16, 2, 128, 16, 3),
                                              (4, 4, 64, 128, None),
                                              (12, 12, 128, 128, 2),
                                              (32, 32, 96, 128, None),
                                              (16, 2, 256, 16, 3),
                                              (8, 4, 80, 16, None),
                                              (4, 2, 32, 128, 2)])
def test_f32_paged_attention_kernel(gen, h, kvh, d, page, pps):
    """Lengths 0, 1, one page, across a page and the full table, dump-page
    tails; D = 64 and 128 take the vector kernel, the rest the other."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import launch_counts

    cols, b = 4, 5
    n_pages = b * cols + 1
    rng = np.random.RandomState(0)
    lengths = np.array([0, 1, page, 3 * page + 5, 4 * page], np.int32)
    tables = np.full((b, cols + 1), n_pages - 1, np.int32)
    perm, used = rng.permutation(n_pages - 1), 0
    for i, n in enumerate(lengths):
        k_ = -(-int(n) // page)
        tables[i, :k_] = perm[used:used + k_]
        used += k_
    q = _randn(gen, b, h, d)
    kp, vp = _randn(gen, n_pages, page, kvh, d), _randn(gen, n_pages, page,
                                                        kvh, d)
    args = (q, kp, vp, torch.tensor(tables, device="cuda"),
            torch.tensor(lengths, device="cuda"))
    launch_counts.clear()
    got = da.paged_attention(*args, pages_per_seq=pps)
    assert _launched("paged_attention[f32]") == 1
    _close(got, da.paged_attention_plain(*args, pages_per_seq=pps))
    assert torch.all(got[0] == 0)


def _segments(kind, b, sq, sk):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    rng = np.random.RandomState(sq + sk)
    if kind == "seq_lens":
        return fa.build_segments(b, sq, sk, rng.randint(1, sk + 1, b),
                                 device="cuda")
    q = np.sort(rng.randint(0, 5, (b, sq)), 1)
    k = np.sort(rng.randint(0, 5, (b, sk)), 1)
    k[k == 3] = 4  # segment 3 has no key: its rows see nothing
    return (torch.tensor(q, dtype=torch.int32, device="cuda"),
            torch.tensor(k, dtype=torch.int32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("seg", [None, "seq_lens", "pair"])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", [
    (2, 32, 32, 12, 12, 128, True),    # the serving path's bucket 32
    (8, 128, 128, 12, 12, 128, True),  # e2's prefill bucket 128
    (1, 50, 50, 8, 2, 64, True),       # ragged length, GQA group 4
    (2, 5, 70, 16, 2, 128, True),      # causal offset sk - sq
    (1, 33, 17, 4, 4, 64, False),
    (2, 70, 70, 8, 8, 96, True),
    (1, 100, 100, 4, 2, 256, True),
    (2, 5, 70, 8, 2, 256, True),
    (1, 33, 17, 4, 4, 32, False),
    (1, 50, 50, 8, 2, 80, True),       # the padded route (to 96)
])
def test_f32_flash_attention_kernel(gen, seg, b, sq, sk, h, kvh, d, causal):
    """out and lse against the plain version; with segments, rows with no
    visible key exactly 0 with lse -1e30."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts

    q_seg, k_seg = (None, None) if seg is None else _segments(seg, b, sq, sk)
    q = _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, sk, kvh, d), _randn(gen, b, sk, kvh, d)
    launch_counts.clear()
    out, lse = fa.flash_attention_fwd(q, k, v, causal, q_seg, k_seg)
    name = ("flash_attention" + ("" if seg is None else "[seg]")
            + ("" if d in fa.HEAD_DIMS else "[pad]") + "[f32]")
    assert dict(launch_counts) == {name: 1}
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal, q_seg, k_seg)
    _close(out, pout)
    torch.testing.assert_close(lse, plse, rtol=RTOL, atol=ATOL)
    if seg == "pair":
        none = (q_seg == 3)[:, None, :].expand_as(lse)
        assert bool(none.any()) and bool((lse[none] == -1e30).all())
        assert bool((out.transpose(1, 2)[none] == 0).all())


@pytest.mark.cuda
def test_f32_public_entries_and_the_backward_refusal(gen):
    """``flash_attention`` and ``scaled_dot_product_attention`` take f32
    under no_grad; under autograd the forward runs and the backward runs
    the f32 dK/dV and dQ kernels, whose gradients are the plain version's,
    as the RMSNorm backward's are. (The backward kernels once refused f32;
    the test keeps its name.)"""
    from paddle_tpu_torch.ops import nn_kernels as nk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    q, k, v = (_randn(gen, 2, 64, 4, 64) for _ in range(3))
    g = _randn(gen, 2, 64, 4, 64)
    want, lse = fa.flash_attention_fwd_plain(q, k, v, True)
    with torch.no_grad():
        _close(fa.flash_attention(q, k, v, is_causal=True), want)
        _close(nk.scaled_dot_product_attention(q, k, v, is_causal=True),
               want)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    out = fa.flash_attention(ql, kl, vl, is_causal=True)
    _close(out.detach(), want)
    launch_counts.clear()
    out.backward(g)
    assert dict(launch_counts) == {"flash_attention_bwd_dkdv[f32]": 1,
                                   "flash_attention_bwd_dq[f32]": 1}
    for t, w in zip((ql, kl, vl), fa.flash_attention_bwd_plain(
            q, k, v, want, lse, g, True)):
        _close(t.grad, w)
    x = _randn(gen, 4, 64).requires_grad_()
    w = _randn(gen, 64).requires_grad_()
    gy = _randn(gen, 4, 64)
    launch_counts.clear()
    nk.rms_norm(x, w).backward(gy)
    assert launch_counts["rms_norm_bwd[f32]"] == 1
    _, r = rn.rms_norm_plain(x.detach(), w.detach(), epsilon=1e-6)
    want_dx, want_dw, _ = rn.rms_norm_bwd_plain(x.detach(), w.detach(), r,
                                                gy)
    _close(x.grad, want_dx)
    _close(w.grad, want_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_f16_and_f64_raise(gen, dtype):
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    x = _randn(gen, 1, 8, 2, 64, dtype=dtype)
    with pytest.raises(TypeError, match="float32"):
        rn.rms_norm_rows(x[0, 0], x[0, 0, 0])
    cos, sin = _rope_tables(64, 16, 10000.0, "cuda")
    pos = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        fo.fused_rope_at(x, x, cos, sin, pos)
    with pytest.raises(TypeError, match="float32"):
        fa.flash_attention_fwd(x, x, x)
    tab = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32"):
        da.paged_attention(x[:, 0], x, x, tab, one)


@pytest.mark.cuda
def test_f32_model_serves_on_card_through_the_f32_kernels(gen):
    """A small f32 LLaMA (the default dtype) on the card: its logits within
    1e-4 relative L2 of the same weights on the CPU through the plain
    versions, and behind the engine it launches the four f32 kernels and
    no bf16 one, decoding unfused (the megakernel takes bf16 only)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import ContinuousBatchingEngine
    from paddle_tpu_torch.ops.cuda import launch_counts

    cfg = LlamaConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=2,
                      max_position_embeddings=256)
    card = LlamaForCausalLM(cfg, generator=seed(0, "cuda"))
    cpu = LlamaForCausalLM(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    ids = np.random.RandomState(2).randint(0, 512, (2, 96))
    with torch.no_grad():
        got = card(torch.tensor(ids, device="cuda")).cpu()
        want = cpu(torch.tensor(ids))
    assert float((got - want).norm() / want.norm()) <= 1e-4
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int32)
               for n in (5, 30, 17, 64)]
    launch_counts.clear()
    outs, stats = ContinuousBatchingEngine(
        card, max_slots=2, max_len=128, page_size=64,
        prompt_buckets=(32, 64)).run(prompts, max_new_tokens=8, segment=4)
    counts = dict(launch_counts)
    assert stats["statuses"] == ["ok"] * len(prompts)
    assert [len(o) for o in outs] == [8] * len(prompts)
    assert not stats["megakernel"]
    for name in ("rms_norm", "fused_rope", "flash_attention",
                 "paged_attention"):
        assert counts.get(name + "[f32]", 0) > 0, counts
        assert counts.get(name, 0) == 0, counts
