"""The port's CUDA kernels against their plain versions on the card, at
shapes off the serving and training paths' (ragged lengths, head dims 32
to 256 and the padded route's 80, GQA groups up to 8, causal offsets, empty rows, clamped positions, row
counts off the RMSNorm backward's strip; paged decode at split-boundary
lengths, head dims off 16-byte rows and groups past 16, two calls bit for bit;
RoPE at the decode shape and head dims 20 to 256;
the decode megakernel at a small size, at the 438M serving decode, on
GQA, at head dims 12, 80, 96 and 256, at groups 12 and 16, at B = 1 and
B = 20, replayed from a CUDA graph, back to back and on two streams; the
bias-dropout-residual-
LayerNorm kernel at BERT-base's shape, in f32, at odd widths and off
alignment; the segment-masked flash kernels with seq_lens, packed ids and
a pair), the refusals of what the kernels do not take, a tiny model
served fused and unfused, its decode segments replayed from captured
CUDA graphs against the eager serial engine (streams, launches credited
per replay, a capture mid-session, an abort in flight and the reuse of
its pages), a tiny model trained on the card, the incubate
layer and a small BERT trained on the card.

Every test here needs a GPU and skips without one (the marker ``cuda``).
They import neither JAX nor ``paddle_tpu``; where JAX is not installed, run
them without the repository's conftest (which imports JAX)::

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: atol 1e-3 + one bf16 ulp (2^-7) relative; kernel and plain
version sum in f32 in different orders and round to bf16 at the end.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

RTOL, ATOL = 2.0 ** -7, 1e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _close(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=RTOL,
                               atol=ATOL)


# the wide kernel's widths (past 4096 up to 16384) at a decode step's
# rows, a ragged count and a prefill's; 16392 is past its limit
RMS_WIDE = [(n, d) for d in (4104, 8192, 12288, 16384)
            for n in (1, 8, 37, 1024)] + [(3, 16392)]


@pytest.mark.parametrize("affine", ["weight", "weight+bias", "bias", "none"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,d", [(1, 64), (3, 1536), (37, 100), (5, 4096),
                                 (2, 8192)] + RMS_WIDE)
def test_rms_norm_kernel(gen, n, d, aligned, affine):
    """The vector kernel (D a multiple of 8 up to 4096, 16-byte aligned),
    the wide one (D a multiple of 8 past 4096 up to 16384, aligned: a
    block a row) and the strided one (D = 100, D = 16392, or x one
    element off alignment), with and without weight and bias; one launch
    each."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    x = _randn(gen, n * d + 1)[1:].view(n, d) if not aligned else _randn(
        gen, n, d)
    w = _randn(gen, d) if "weight" in affine else None
    b = _randn(gen, d) if "bias" in affine else None
    launch_counts.clear()
    y, r = rn.rms_norm_rows(x, w, b, epsilon=1e-5)
    assert dict(launch_counts) == {"rms_norm": 1}
    py, pr = rn.rms_norm_plain(x, w, b, epsilon=1e-5)
    _close(y, py)
    torch.testing.assert_close(r, pr, rtol=1e-5, atol=0)


# the 438M's and Phi-3's decode step (8, 1, H, D), its prefill, and head
# dims 32, 80, 256 and 20 (half not a multiple of 8: the element path)
ROPE_SHAPES = [(2, 7, 4, 2, 64), (3, 1, 16, 2, 128), (1, 33, 12, 12, 128),
               (2, 9, 32, 32, 96), (8, 1, 12, 12, 128), (8, 1, 32, 32, 96),
               (2, 5, 4, 2, 32), (2, 5, 32, 8, 80), (1, 6, 16, 2, 256),
               (3, 4, 6, 2, 20)]


@pytest.mark.parametrize("b,s,h,kvh,d", ROPE_SHAPES)
def test_rope_kernel(gen, b, s, h, kvh, d):
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import fused_ops as fo

    cos, sin = _rope_tables(d, 64, 10000.0, "cuda")
    q, k = _randn(gen, b, s, h, d), _randn(gen, b, s, kvh, d)
    # includes positions outside the table, which both versions clamp
    pos = torch.randint(-3, 70, (b, s), generator=gen, device="cuda",
                        dtype=torch.int32)
    for got, want in zip(fo.fused_rope_at(q, k, cos, sin, pos),
                         fo.fused_rope_plain(q, k, cos, sin, pos)):
        _close(got, want)
    # k = None: the kernel rotates q alone
    got, none = fo.fused_rope_at(q, None, cos, sin, pos)
    assert none is None
    _close(got, fo.fused_rope_plain(q, None, cos, sin, pos)[0])


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", [
    (2, 32, 32, 12, 12, 128, True),    # the serving path's bucket 32
    (1, 50, 50, 8, 2, 64, True),       # ragged length, GQA group 4
    (2, 5, 70, 16, 2, 128, True),      # causal offset sk - sq
    (1, 33, 17, 4, 4, 64, False),
    (2, 70, 70, 8, 8, 96, True),       # Phi-3's head dim
    (1, 100, 100, 4, 2, 256, True),    # 32-key tiles, Q from shared memory
    (2, 5, 70, 8, 2, 256, True),       # ... with a causal offset
    (1, 33, 17, 4, 4, 32, False),
    (1, 50, 50, 8, 2, 80, True),       # the padded route (to 96)
])
def test_flash_attention_kernel(gen, b, sq, sk, h, kvh, d, causal):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    q = _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, sk, kvh, d), _randn(gen, b, sk, kvh, d)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    assert out.shape == q.shape
    _close(out, pout)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


@pytest.mark.parametrize("h,kvh,d,page,pps", [(16, 2, 128, 16, 3),
                                              (4, 4, 64, 128, None),
                                              (12, 12, 128, 128, 2),
                                              (32, 32, 96, 128, None),
                                              (16, 2, 256, 16, 3),
                                              (8, 4, 80, 16, None),
                                              (4, 2, 32, 128, 2),
                                              (8, 2, 72, 64, None),
                                              (4, 2, 36, 16, 3),
                                              (6, 6, 100, 128, None),
                                              # groups past 16: chunks
                                              (96, 8, 128, 128, None),
                                              (128, 8, 64, 16, 3),
                                              (32, 1, 128, 16, None),
                                              (18, 1, 80, 16, 3),
                                              (24, 2, 256, 128, 2),
                                              (40, 1, 72, 64, None)])
def test_paged_attention_kernel(gen, h, kvh, d, page, pps):
    """Lengths 0, 1, the split boundaries (multiples of 32) +-1, page
    boundaries, the full table and past it (clamped to the walk), with
    dump-page tails; D = 72 and 36 (16-byte rows and not), 100 (the
    element path); a second call gives the same bits."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    cols = 4
    lengths = np.array([0, 1, 31, 32, 33, 63, 64, 65, page, 3 * page + 5,
                        4 * page, 4 * page + 9], np.int32)
    b = len(lengths)
    n_pages = b * cols + 1
    rng = np.random.RandomState(0)
    tables = np.full((b, cols + 1), n_pages - 1, np.int32)  # dump tails
    perm, used = rng.permutation(n_pages - 1), 0
    for i, n in enumerate(lengths):
        k_ = min(-(-int(n) // page), cols)
        tables[i, :k_] = perm[used:used + k_]
        used += k_
    q = _randn(gen, b, h, d)
    kp, vp = _randn(gen, n_pages, page, kvh, d), _randn(gen, n_pages, page,
                                                        kvh, d)
    args = (q, kp, vp, torch.tensor(tables, device="cuda"),
            torch.tensor(lengths, device="cuda"))
    got = da.paged_attention(*args, pages_per_seq=pps)
    _close(got, da.paged_attention_plain(*args, pages_per_seq=pps))
    assert torch.all(got[0] == 0)
    assert torch.equal(got, da.paged_attention(*args, pages_per_seq=pps))


@pytest.mark.parametrize("n,d,offset", [
    (37, 64, 0), (1, 100, 0), (19, 4096, 0), (64, 1536, 0),
    (1, 1536, 0),      # one row: one block, seven warps without a row
    (6143, 1536, 0),   # rows off every block's share
    (6144, 1536, 0),   # the 438M's training step
    (6144, 3072, 0),   # Phi-3-mini's: column sums in shared memory
    (3, 16384, 0),     # MAX_D: the strip kernel
    (37, 100, 1),      # D = 100 with x, g and dx off 16-byte alignment
    (5, 1536, 1),      # off alignment at a vector width
])
def test_rms_norm_bwd_kernel(gen, n, d, offset):
    """The vector kernel (D a multiple of 8 up to 4096, 16-byte aligned) and
    the strip kernel (any other D or alignment) against the plain version;
    a second call on the same inputs gives dx, dw and db bit for bit."""
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    def rows():
        return _randn(gen, n * d + offset)[offset:].view(n, d)

    x, g = rows(), rows()
    w = (1.0 + 0.1 * _randn(gen, d, dtype=torch.float32)).bfloat16()
    _, r = rn.rms_norm_rows(x, w, epsilon=1e-5)
    got = rn.rms_norm_bwd(x, w, r, g)
    for a, want in zip(got, rn.rms_norm_bwd_plain(x, w, r, g)):
        _close(a, want)
    for a, again in zip(got, rn.rms_norm_bwd(x, w, r, g)):
        assert torch.equal(a, again)


@pytest.mark.parametrize("b,s,h,kvh,d", ROPE_SHAPES)
def test_rope_adjoint_kernel(gen, b, s, h, kvh, d):
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import fused_ops as fo

    cos, sin = _rope_tables(d, 64, 10000.0, "cuda")
    dq, dk = _randn(gen, b, s, h, d), _randn(gen, b, s, kvh, d)
    # includes positions outside the table, which both versions clamp
    pos = torch.randint(-3, 70, (b, s), generator=gen, device="cuda",
                        dtype=torch.int32)
    for got, want in zip(
            fo.fused_rope_at(dq, dk, cos, sin, pos, inverse=True),
            fo.fused_rope_plain(dq, dk, cos, sin, pos, inverse=True)):
        _close(got, want)
    got, none = fo.fused_rope_at(dq, None, cos, sin, pos, inverse=True)
    assert none is None
    _close(got, fo.fused_rope_plain(dq, None, cos, sin, pos, inverse=True)[0])


@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", [
    (1, 100, 100, 8, 4, 64, True),     # GQA group 2, S off the 64-row tile
    (2, 70, 70, 16, 2, 128, True),     # group 8
    (2, 5, 70, 16, 2, 128, True),      # causal offset sk - sq
    (1, 33, 17, 4, 4, 64, False),
    (1, 150, 150, 12, 12, 128, True),  # MHA, three tiles, the last ragged
    (2, 70, 70, 8, 8, 96, True),       # Phi-3's head dim: 64-key tiles
    (1, 100, 100, 4, 2, 256, True),    # 32-key tiles in both kernels
    (2, 5, 70, 8, 2, 256, True),       # ... with a causal offset
    (1, 33, 17, 4, 4, 32, False),
    (1, 50, 50, 8, 2, 80, True),       # the padded route (to 96)
])
def test_flash_attention_bwd_kernels(gen, b, sq, sk, h, kvh, d, causal):
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    q, do = _randn(gen, b, sq, h, d), _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, sk, kvh, d), _randn(gen, b, sk, kvh, d)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
    for a, w in zip(got, want):
        _close(a, w)


def _segment_ids(kind, b, sq, sk):
    """Ids of one kind: ``seq_lens`` (padding -1), ``packed`` documents
    of 1-40 tokens (shared, sq == sk), or a ``pair`` for cross attention
    in which query segment 3 is missing from the keys."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    rng = np.random.RandomState(sq + sk)
    if kind == "seq_lens":
        return fa.build_segments(b, sq, sk, rng.randint(1, sk + 1, b),
                                 device="cuda")
    if kind == "packed":
        ids = np.empty((b, sq), np.int32)
        for i in range(b):
            pos, doc = 0, 0
            while pos < sq:
                n = rng.randint(1, 41)
                ids[i, pos:pos + n] = doc
                pos, doc = pos + n, doc + 1
        t = torch.tensor(ids, device="cuda")
        return t, t
    q = np.sort(rng.randint(0, 5, (b, sq)), 1)
    k = np.sort(rng.randint(0, 5, (b, sk)), 1)
    k[k == 3] = 4
    return (torch.tensor(q, dtype=torch.int32, device="cuda"),
            torch.tensor(k, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("kind", ["seq_lens", "packed", "pair"])
@pytest.mark.parametrize("b,sq,sk,h,kvh,d,causal", [
    (1, 100, 100, 8, 4, 64, True),     # GQA group 2, S off the 64-row tile
    (1, 150, 150, 12, 12, 128, True),  # MHA, three tiles, the last ragged
])
def test_flash_attention_segment_kernels(gen, kind, b, sq, sk, h, kvh, d,
                                         causal):
    """The three masked kernels against their plain versions on the same
    ids: out and lse, then dQ, dK and dV from the kernel's out and lse;
    rows with no visible key are exactly 0 with lse -1e30."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    q_seg, k_seg = _segment_ids(kind, b, sq, sk)
    q, do = _randn(gen, b, sq, h, d), _randn(gen, b, sq, h, d)
    k, v = _randn(gen, b, sk, kvh, d), _randn(gen, b, sk, kvh, d)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, q_seg, k_seg)
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal, q_seg, k_seg)
    _close(out, pout)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    if kind == "pair":
        none = (q_seg == 3)[:, :, None, None].expand_as(out)
        assert bool(none.any()) and bool((out[none] == 0).all())
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal, q_seg, k_seg)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal, q_seg,
                                        k_seg)
    for a, w in zip(got, want):
        _close(a, w)


def test_kernels_refuse_what_they_do_not_take(gen):
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    # f32 runs, forward and backward (tests/test_torch_f32.py,
    # tests/test_torch_f32_train.py); f16 is refused
    with pytest.raises(TypeError, match="bfloat16"):
        rn.rms_norm_rows(_randn(gen, 4, 64, dtype=torch.float16),
                    _randn(gen, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        rn.rms_norm_rows(_randn(gen, 64, 4).T, _randn(gen, 64))
    with pytest.raises(TypeError, match="bfloat16"):
        x = _randn(gen, 4, 64, dtype=torch.float16)
        rn.rms_norm_bwd(x, x[0], torch.ones((4, 1), device="cuda"), x)
    # head dim 96 runs on the kernels (counted), 80 on the padded route
    # (counted as [pad]); past 256 the kernels refuse
    from paddle_tpu_torch.ops.cuda import launch_counts

    for d, tag in ((96, ""), (80, "[pad]")):
        x = _randn(gen, 1, 8, 2, d)
        launch_counts.clear()
        out, lse = fa.flash_attention_fwd(x, x, x)
        got = fa.flash_attention_bwd(x, x, x, out, lse, x)
        assert launch_counts["flash_attention" + tag] == 1
        assert launch_counts["flash_attention_bwd_dkdv" + tag] == 1
        assert launch_counts["flash_attention_bwd_dq" + tag] == 1
        _close(out, fa.flash_attention_fwd_plain(x, x, x)[0])
        for a, w in zip(got, fa.flash_attention_bwd_plain(x, x, x, out, lse,
                                                          x)):
            _close(a, w)
    x = _randn(gen, 1, 8, 2, 320)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(x, x, x)
    lse = torch.zeros((1, 2, 8), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_bwd(x, x, x, x, lse, x)
    with pytest.raises(TypeError, match="bfloat16"):
        y = _randn(gen, 1, 8, 2, 64, dtype=torch.float16)
        fa.flash_attention_bwd(y, y, y, y, lse, y)
    # contiguous but 8 bytes off: the kernels copy rows 16 bytes at a time
    z = _randn(gen, 1 * 8 * 2 * 64 + 4)[4:].view(1, 8, 2, 64)
    y = _randn(gen, 1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention(z, y, y)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_attention_bwd(y, y, y, y, lse, z)
    # segment masking: the public function takes seq_lens on the card
    # (the masked kernel) and agrees with the plain version
    lens = torch.tensor([5], device="cuda")
    _close(fa.flash_attention(y, y, y, seq_lens=lens),
           fa.flash_attention_fwd_plain(y, y, y, False, *fa.build_segments(
               1, 8, 8, lens, device="cuda"))[0])
    with pytest.raises(TypeError, match="int32"):
        fa.flash_attention_fwd(y, y, y, True, lens[None].float(),
                               lens[None].float())
    # 16 query heads per kv head, once refused, now taken in chunks
    q = _randn(gen, 1, 32, 64)
    kp = _randn(gen, 2, 16, 2, 64)
    tab = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    one = torch.full((1,), 9, dtype=torch.int32, device="cuda")
    _close(da.paged_attention(q, kp, kp, tab, one),
           da.paged_attention_plain(q, kp, kp, tab, one))
    k4 = _randn(gen, 2, 16, 4, 64)  # 6 query heads on 4 kv heads
    with pytest.raises(ValueError, match="multiple of the kv heads"):
        da.paged_attention(_randn(gen, 1, 6, 64), k4, k4, tab, one)
    q, kp = _randn(gen, 1, 2, 320), _randn(gen, 2, 16, 2, 320)
    with pytest.raises(ValueError, match="head_dim"):
        da.paged_attention(q, kp, kp, tab, one)


def test_tiny_model_on_card_matches_cpu_and_serves(gen):
    """A small LLaMA in bf16 through the kernels agrees with its f32 CPU
    copy through the plain versions, and the unfused engine serves on the
    card through all four kernels."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import (
        ContinuousBatchingEngine,
        LlamaConfig,
        LlamaForCausalLM,
    )
    from paddle_tpu_torch.ops.cuda import launch_counts

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    card = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                            generator=seed(0, "cuda"))
    cpu = LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32,
                           generator=seed(0, "cpu"))
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in card.state_dict().items()})
    ids = torch.randint(0, 256, (2, 40), generator=gen, device="cuda")
    with torch.no_grad():
        got = card(ids).float().cpu()
        want = cpu(ids.cpu())
    assert float((got - want).norm() / want.norm()) < 5e-2
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 30, 12, 64, 3)]
    launch_counts.clear()
    outs, _ = ContinuousBatchingEngine(
        card, max_slots=2, max_len=128, page_size=16,
        prompt_buckets=(16, 64), decode_megakernel=0).run(
        prompts, max_new_tokens=6, segment=3)
    assert all(launch_counts[k] > 0 for k in (
        "rms_norm", "fused_rope", "flash_attention", "paged_attention"))
    assert all(len(o) == 6 and 0 <= o.min() and o.max() < 256 for o in outs)


def _megakernel_args(gen, b, hidden, heads, kvh, d, page, cols, lens):
    """One layer's inputs: N(0, 0.02) weights, norm scales random powers
    of two (exact in bf16, so a scale adds no rounding), random pools of
    b * cols pages plus a dump page, tables with one trailing column,
    their tails on the dump page; x of layer-0 scale, N(0, 0.02)."""
    from paddle_tpu_torch.models.llama import _rope_tables

    n_pages = b * cols + 1
    rng = np.random.RandomState(0)
    perm, used = rng.permutation(n_pages - 1), 0
    tables = np.full((b, cols + 1), n_pages - 1, np.int32)
    for i, n in enumerate(lens):
        k_ = -(-(n + 1) // page)
        tables[i, :k_] = perm[used:used + k_]
        used += k_
    cos, sin = _rope_tables(d, 1024, 10000.0, "cuda")

    def w(*shape):
        return (0.02 * torch.randn(shape, generator=gen,
                                   device="cuda")).bfloat16()

    def scale():
        return (2.0 ** torch.randint(-1, 2, (hidden,), generator=gen,
                                     device="cuda")).bfloat16()

    return dict(
        x=w(b, 1, hidden), ln1_weight=scale(), ln1_eps=1e-6,
        wq=w(hidden, heads * d), wk=w(hidden, kvh * d),
        wv=w(hidden, kvh * d), wo=w(heads * d, hidden), rope_cos=cos,
        rope_sin=sin, ln2_weight=scale(), ln2_eps=1e-6,
        k_pages=_randn(gen, n_pages, page, kvh, d),
        v_pages=_randn(gen, n_pages, page, kvh, d),
        tables=torch.tensor(tables, device="cuda"),
        lengths=torch.tensor(lens, dtype=torch.int32, device="cuda"),
        heads=heads, attn_pages=cols, dump_page=n_pages - 1)


MEGAKERNEL_CASES = [  # b, hidden, heads, kvh, d, page, cols, lens
    (3, 256, 4, 2, 64, 16, 4, [0, 16, 63]),          # small, group 2
    (8, 1536, 12, 12, 128, 128, 4,                   # the 438M decode
     [1, 17, 127, 128, 200, 255, 256, 510]),
    (4, 1536, 12, 4, 128, 128, 4, [5, 128, 300, 511]),  # GQA, group 3
    (2, 1024, 16, 2, 64, 32, 3, [31, 95]),            # group 8, D = 64
    # head dims off 64 and 128, groups past 8, D off the 16-byte grid
    # (4-byte copies of the weights and pools)
    (8, 3072, 32, 32, 96, 128, 4, [1, 17, 127, 128, 200, 255, 256, 510]),
    (3, 640, 8, 8, 80, 16, 4, [0, 16, 63]),
    (2, 2048, 16, 2, 256, 16, 3, [5, 40]),
    (4, 4096, 32, 2, 128, 128, 4, [5, 128, 300, 511]),  # group 16
    (3, 1536, 12, 1, 128, 16, 4, [0, 17, 63]),          # group 12
    (2, 1024, 16, 1, 64, 32, 3, [31, 95]),              # group 16, D = 64
    (2, 48, 4, 2, 12, 16, 2, [3, 20]),                  # D = 12
    # one row; 20 rows, three row groups of the kernel's 8
    (1, 1536, 12, 4, 128, 128, 4, [300]),
    (20, 512, 8, 2, 64, 16, 4, [0, 1, 5, 15, 16, 17, 31, 32, 33, 47, 48, 49,
                                63, 2, 3, 7, 8, 9, 40, 62]),
    # the engine's pool layout (page 128, 4 visible columns) with every
    # depth of chip_smoke.py's MK_LENGTHS at D = 256 on 2 kv heads
    (8, 2048, 8, 2, 256, 128, 4, [1, 17, 127, 128, 200, 255, 256, 510]),
]


@pytest.mark.parametrize("b,hidden,heads,kvh,d,page,cols,lens",
                         MEGAKERNEL_CASES)
def test_decode_megakernel(gen, b, hidden, heads, kvh, d, page, cols, lens):
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk

    args = _megakernel_args(gen, b, hidden, heads, kvh, d, page, cols, lens)
    got = _fused_matches_plain(mk, args)
    # the same bits on a second launch (fixed order, no float atomics)
    again = mk.fused_decode_layer(**dict(args, k_pages=args["k_pages"].clone(),
                                         v_pages=args["v_pages"].clone()))
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def _h_mid_close(mk, args, got, want):
    """The kernel's bf16 h_mid = bf16(x + bf16(o)) against the plain
    version's (chip_smoke.py's h_mid_gate): it rounds twice, so where the
    kernel and the plain version sum o in other orders and land on the two
    sides of a rounding boundary of o, the kernel's bf16(o) is a bf16
    neighbour of the plain one and h_mid moves by up to an ulp of o. An
    element passes the one-rounding gate or equals bf16(x + o') for o' one
    of the two bf16 neighbours of the plain bf16(o); nothing else."""
    torch.cuda.synchronize()
    got, want = got[:, 0], want[:, 0]
    assert torch.isfinite(got.float()).all()
    one = ((got.float() - want.float()).abs()
           <= ATOL + RTOL * want.float().abs())
    o = mk.decode_attention_o_plain(**{
        k: v.clone() if k in ("k_pages", "v_pages") else v
        for k, v in args.items()
        if k not in ("ln2_weight", "ln2_eps", "dump_page")})
    bits = o.contiguous().view(torch.int16)
    near = torch.zeros_like(one)
    for step in (-1, 1):
        o_ = (bits + step).view(torch.bfloat16).float()
        near |= got == (args["x"][:, 0].float() + o_).to(torch.bfloat16)
    assert bool((one | near).all()), (
        f"{int((~(one | near)).sum())} h_mid elements beyond the gate")


def _fused_matches_plain(mk, args):
    """One launch against the plain version on copies of the pools;
    returns the kernel's (h_mid, y2). h_mid in bf16 by the rule of
    _h_mid_close."""
    plain = dict(args, k_pages=args["k_pages"].clone(),
                 v_pages=args["v_pages"].clone())
    o_args = dict(plain, k_pages=args["k_pages"].clone(),
                  v_pages=args["v_pages"].clone())
    got = mk.fused_decode_layer(**args)
    want = mk.fused_decode_layer_plain(**plain)
    if got[0].dtype == torch.bfloat16:
        _h_mid_close(mk, o_args, got[0], want[0])
    else:
        _close(got[0], want[0])
    # y2 against the plain norm of the kernel's own h_mid: h_mid may
    # differ by the one bf16 ulp the tolerance admits, and y2 would carry
    # it again
    _close(got[1], mk.decode_norm_plain(got[0], args["ln2_weight"], 1e-6))
    dump = args["dump_page"]
    _close(args["k_pages"][:dump], plain["k_pages"][:dump])
    _close(args["v_pages"][:dump], plain["v_pages"][:dump])
    return got


def _pools_copy(args, **over):
    return dict(args, k_pages=args["k_pages"].clone(),
                v_pages=args["v_pages"].clone(), **over)


def _as_f32(args):
    return {k: v.float() if isinstance(v, torch.Tensor)
            and v.dtype == torch.bfloat16 else v for k, v in args.items()}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_megakernel_graph_replay_matches_eager(gen, dtype):
    """The cooperative launch records into a CUDA graph (captured on a
    stream that ran the layer once, as the wrapper asks), and each replay
    gives the eager launch's bits: h_mid, y2 and the appended pools."""
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk

    args = _megakernel_args(gen, 8, 1536, 12, 4, 128, 128, 4,
                            [1, 17, 127, 128, 200, 255, 256, 510])
    if dtype == torch.float32:
        args = _as_f32(args)
    kp, vp = args["k_pages"], args["v_pages"]
    eager_args = _pools_copy(args)
    eager = mk.fused_decode_layer(**eager_args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph_args = _pools_copy(args)
    with torch.cuda.stream(side):
        mk.fused_decode_layer(**graph_args)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        out = mk.fused_decode_layer(**graph_args)
    for _ in range(2):
        graph_args["k_pages"].copy_(kp)
        graph_args["v_pages"].copy_(vp)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
        assert torch.equal(graph_args["k_pages"], eager_args["k_pages"])
        assert torch.equal(graph_args["v_pages"], eager_args["v_pages"])


def test_decode_megakernel_back_to_back_and_on_two_streams(gen):
    """Launches in a row on one stream share the kernel's kept barrier
    and counters (no synchronisation between them), at other shapes and
    types in turn, and launches on two streams each have their own; every
    launch matches the plain version, and the repeat of a launch gives its
    bits."""
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk

    cases = [
        _megakernel_args(gen, 8, 1536, 12, 12, 128, 128, 4,
                         [1, 17, 127, 128, 200, 255, 256, 510]),
        _megakernel_args(gen, 3, 640, 8, 8, 80, 16, 4, [0, 16, 63]),
        _as_f32(_megakernel_args(gen, 4, 1536, 12, 4, 128, 128, 4,
                                 [5, 128, 300, 511])),
    ]
    want = [mk.fused_decode_layer_plain(**_pools_copy(a)) for a in cases]
    runs = [_pools_copy(a) for a in cases + cases]
    got = [mk.fused_decode_layer(**r) for r in runs]
    for i, (g_, r) in enumerate(zip(got, runs)):
        a, w = cases[i % 3], want[i % 3]
        if a["x"].dtype == torch.bfloat16:
            _h_mid_close(mk, a, g_[0], w[0])
        else:
            torch.testing.assert_close(g_[0], w[0], rtol=1e-4, atol=1e-4)
        assert torch.isfinite(r["k_pages"].float()).all()
    for i in range(3):
        assert torch.equal(got[i][0], got[i + 3][0])
        assert torch.equal(got[i][1], got[i + 3][1])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    runs = [_pools_copy(cases[0]), _pools_copy(cases[1])]
    outs = []
    for s, r in zip(streams, runs):
        with torch.cuda.stream(s):
            outs.append(mk.fused_decode_layer(**r))
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    for i in range(2):
        assert torch.equal(outs[i][0], got[i][0])
        assert torch.equal(outs[i][1], got[i][1])


def test_decode_megakernel_refuses_what_it_does_not_take(gen):
    """Head dim 96, 16 query heads per kv head and f32, once refused, are
    taken now and agree with the plain version; head dim 320, an odd head
    dim, f16, mixed types and non-contiguous weights are refused."""
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk

    base = _megakernel_args(gen, 2, 256, 4, 2, 64, 16, 2, [3, 9])
    # head_dim 96
    _fused_matches_plain(mk, _megakernel_args(gen, 2, 192, 2, 2, 96, 16, 2,
                                              [3, 9]))
    # 16 query heads per kv head
    _fused_matches_plain(mk, _megakernel_args(gen, 2, 1024, 16, 1, 64, 16, 2,
                                              [3, 9]))
    # f32 activations and weights
    _fused_matches_plain(mk, {
        k: v.float() if isinstance(v, torch.Tensor) and v.is_floating_point()
        else v for k, v in base.items()})
    for d in (320, 63):
        a = _megakernel_args(gen, 2, 64 * 8, 4, 2, d, 16, 2, [3, 9])
        with pytest.raises(ValueError, match="head_dim"):
            mk.fused_decode_layer(**a)
    for dt in (torch.float16, torch.float64):
        a = {k: v.to(dt) if isinstance(v, torch.Tensor)
             and v.dtype == torch.bfloat16 else v for k, v in base.items()}
        with pytest.raises(TypeError, match="float32"):
            mk.fused_decode_layer(**a)
    a = dict(base, wq=base["wq"].float())
    with pytest.raises(TypeError, match="bfloat16"):
        mk.fused_decode_layer(**a)
    # non-contiguous weights
    a = dict(base, wq=base["wq"].T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        mk.fused_decode_layer(**a)


def test_tiny_model_serves_fused_and_unfused_on_card(gen):
    """The engine on the card takes the fused path by default (the
    megakernel, num_layers launches per decode step, no paged decode)
    and the unfused one with decode_megakernel=0; both serve every token
    and keep the pools finite. Their greedy streams may part at near-ties
    (the two paths round at other points), so they are not compared."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import (
        ContinuousBatchingEngine,
        LlamaConfig,
        LlamaForCausalLM,
    )
    from paddle_tpu_torch.ops.cuda import launch_counts

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    card = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                            generator=seed(0, "cuda"))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 30, 12, 64, 3)]
    for mode in (1, 0):
        eng = ContinuousBatchingEngine(card, max_slots=2, max_len=128,
                                       page_size=16, prompt_buckets=(16, 64),
                                       decode_megakernel=mode)
        # the capture's eager warm-up segment launches too: before the
        # counts are zeroed
        eng.warmup(segment=3)
        launch_counts.clear()
        outs, stats = eng.run(prompts, max_new_tokens=6, segment=3)
        torch.cuda.synchronize()
        assert stats["megakernel"] is bool(mode)
        assert all(len(o) == 6 and 0 <= o.min() and o.max() < 256
                   for o in outs)
        assert all(bool(torch.isfinite(t).all()) for t in eng._ks + eng._vs)
        steps = stats["segments"] * 3
        if mode:
            assert launch_counts["fused_decode_layer"] == 2 * steps
            assert launch_counts["paged_attention"] == 0
        else:
            assert launch_counts["fused_decode_layer"] == 0
            assert launch_counts["paged_attention"] > 0


def _tiny_card_model():
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    return LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                            generator=seed(0, "cuda"))


def _eager_serial_engine():
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    class EagerSerial(ContinuousBatchingEngine):
        _capture_decode = False

    return EagerSerial


@pytest.mark.parametrize("mode", [1, 0])
def test_captured_segment_credits_an_eager_segments_launches(gen, mode):
    """A decode segment's graph records the launches of its capture, and
    each replay credits them: they equal the launches of the same segment
    run eagerly, and a run's fused launches are layers x decode steps
    with speculative segments counted."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine
    from paddle_tpu_torch.ops.cuda import launch_counts

    card = _tiny_card_model()
    eng = ContinuousBatchingEngine(card, max_slots=2, max_len=128,
                                   page_size=16, prompt_buckets=(16, 64),
                                   decode_megakernel=mode)
    assert eng.warmup(segment=3)["programs"] == 1
    again = eng.warmup(segment=3)
    assert again["programs"] == 0 and again["cached"] == 1
    prog = eng._programs[3]
    assert prog.graph is not None and sum(prog.launches.values()) > 0
    launch_counts.clear()
    with eng._device_turn():
        eng._segment_body(prog)
    torch.cuda.synchronize()
    assert dict(launch_counts) == dict(prog.launches)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 30, 12, 64, 3)]
    launch_counts.clear()
    _, stats = eng.run(prompts, max_new_tokens=9, segment=3)
    torch.cuda.synchronize()
    steps = stats["segments"] * 3
    assert stats["pipelined"]
    name = "fused_decode_layer" if mode else "paged_attention"
    assert launch_counts[name] == 2 * steps


@pytest.mark.parametrize("do_sample", [False, True])
def test_captured_pipelined_engine_matches_eager_serial_on_card(gen,
                                                                do_sample):
    """The default engine (pipelined, decode segments replayed from
    captured graphs) emits the eager serial engine's streams bit for bit,
    greedy and sampled from per-request streams, fused and unfused."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    card = _tiny_card_model()
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 30, 12, 64, 3, 17, 9)]
    kw = dict(max_slots=3, max_len=128, page_size=16, prompt_buckets=(16, 64),
              do_sample=do_sample, top_k=20, top_p=0.9, seed=4)
    for mode in (1, 0):
        want, _ = _eager_serial_engine()(
            card, pipeline=False, decode_megakernel=mode, **kw).run(
            prompts, max_new_tokens=12, segment=4)
        got, stats = ContinuousBatchingEngine(
            card, decode_megakernel=mode, **kw).run(
            prompts, max_new_tokens=12, segment=4)
        assert stats["pipelined"] and stats["statuses"] == ["ok"] * 7
        for i, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{mode} {i}")


def test_capture_mid_session_keeps_the_streams_on_card(gen):
    """A capture while a speculative segment is in flight (``warmup`` of
    another segment length mid-session) restores the decode state the
    next replay continues from: the streams equal the eager serial
    engine's."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    card = _tiny_card_model()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 30, 12)]
    kw = dict(max_slots=3, max_len=128, page_size=16, prompt_buckets=(16, 64))
    want, _ = _eager_serial_engine()(card, pipeline=False, **kw).run(
        prompts, max_new_tokens=20, segment=4)
    eng = ContinuousBatchingEngine(card, **kw)
    eng.start(segment=4)
    reqs = [eng.submit(p, 20, rid=i) for i, p in enumerate(prompts)]
    eng.step()
    eng.step()
    assert eng._inflight is not None
    assert eng.warmup(segment=5)["programs"] == 1
    while eng.has_work():
        eng.step()
    for i, (r, w) in enumerate(zip(reqs, want)):
        np.testing.assert_array_equal(r.output(), w, err_msg=f"{i}")


def test_abort_in_flight_then_reuse_the_freed_pages_on_card(gen):
    """On the card a segment in flight really runs after the host freed
    the aborted slot's pages: the request granted those pages next still
    emits its stream from a fresh engine."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    card = _tiny_card_model()
    rng = np.random.RandomState(2)
    p_long, p_next = (rng.randint(0, 256, (n,)).astype(np.int32)
                      for n in (20, 9))
    kw = dict(max_slots=1, max_len=128, page_size=16, prompt_buckets=(16, 64),
              pool_pages=8, prefix_cache=False)
    eng = ContinuousBatchingEngine(card, **kw)
    eng.start(segment=8)
    eng.submit(p_long, 100, rid=0)
    eng.step()
    eng.step()
    assert eng._inflight is not None
    freed = list(eng._slot_pages[0])
    eng.abort(0)
    nxt = eng.submit(p_next, 30, rid=1)
    eng.step()
    assert set(eng._slot_pages[0]) <= set(freed)
    while eng.has_work():
        eng.step()
    fresh = ContinuousBatchingEngine(card, **kw)
    fresh.start(segment=8)
    want = fresh.submit(p_next, 30, rid=1)
    while fresh.has_work():
        fresh.step()
    np.testing.assert_array_equal(nxt.output(), want.output())


def test_tiny_model_trains_on_card_through_the_backward_kernels(gen):
    """A small GQA LLaMA in bf16: its gradients agree with an f32 CPU copy
    through the plain versions, and AdamW steps through TrainStep lower
    the loss, launching every backward kernel."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        LlamaConfig,
        LlamaForCausalLM,
        LlamaPretrainingCriterion,
    )
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=256)
    card = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                            generator=seed(0, "cuda"))
    cpu = LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32,
                           generator=seed(0, "cpu"))
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in card.state_dict().items()})
    ids = torch.randint(0, 256, (2, 96), generator=gen, device="cuda")
    crit = LlamaPretrainingCriterion()
    crit(card(ids), ids).backward()
    crit(cpu(ids.cpu()), ids.cpu()).backward()
    want = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        rel = (p.grad.float().cpu() - want[name].grad).norm() / want[
            name].grad.norm()
        assert rel < 5e-2, name
    card.zero_grad()
    launch_counts.clear()
    step = TrainStep(card, crit, AdamW(learning_rate=1e-3,
                                       parameters=card.parameters(),
                                       multi_precision=True))
    losses = step.run(ids, steps=4, labels=ids).tolist()
    assert losses[-1] < losses[0]
    assert all(launch_counts[k] > 0 for k in (
        "rms_norm_bwd", "fused_rope_bwd", "flash_attention_bwd_dkdv",
        "flash_attention_bwd_dq"))


@pytest.mark.parametrize("rows,h,dtype,training,aligned", [
    (4096, 768, torch.bfloat16, True, True),    # BERT-base, 32 x 128
    (4096, 768, torch.bfloat16, False, True),
    (4096, 768, torch.float32, True, True),
    (1024, 1536, torch.bfloat16, True, True),
    (37, 1000, torch.bfloat16, True, True),     # a partly filled last vector
    (5, 100, torch.bfloat16, True, True),       # H % 8 != 0: element loads
    (5, 100, torch.float32, False, True),
    (9, 64, torch.bfloat16, True, False),       # off 16-byte alignment
    (3, 4096, torch.bfloat16, True, True),      # the longest row in registers
    (3, 5000, torch.float32, True, True),       # longer: the strided path
])
def test_bias_dropout_residual_ln_kernel(gen, rows, h, dtype, training,
                                         aligned):
    from paddle_tpu_torch.ops.cuda import fused_ops as fo

    def rand(*shape, dt=dtype):
        return _randn(gen, *shape, dtype=dt)

    if aligned:
        x, res = rand(rows, h), rand(rows, h)
    else:  # views one element into their storage: 2 bytes off
        x, res = (rand(rows * h + 1)[1:].view(rows, h) for _ in range(2))
    # bias and scale in f32 beside a bf16 x: the kernel upcasts either
    bias, scale = 0.1 * rand(h, dt=torch.float32), 1 + 0.1 * rand(h)
    lnb = 0.1 * rand(h)
    mask = torch.rand((rows, h), generator=gen, device="cuda") < 0.9
    args = (x, res, bias, scale, lnb, mask, 0.1, 1e-5, training)
    y, mean, rstd = fo.bias_dropout_residual_ln_fwd(*args)
    py, pmean, prstd = fo.bias_dropout_residual_ln_plain(*args)
    _close(y, py)
    torch.testing.assert_close(mean, pmean, rtol=0,
                               atol=1e-5 * pmean.abs().max().item())
    torch.testing.assert_close(rstd, prstd, rtol=1e-5, atol=0)
    assert y.dtype == dtype and mean.dtype == torch.float32


def test_bias_dropout_residual_ln_layer_on_card(gen):
    """The incubate layer in bf16 launches the kernel once per forward and
    its gradients agree with an f32 CPU copy through the plain versions."""
    from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
    from paddle_tpu_torch.ops.cuda import launch_counts

    layer = FusedBiasDropoutResidualLayerNorm(
        256, dropout_rate=0.0, device="cuda", dtype=torch.bfloat16)
    cpu = FusedBiasDropoutResidualLayerNorm(256, dropout_rate=0.0,
                                            device="cpu")
    x = _randn(gen, 2, 8, 256).requires_grad_()
    res, dy = _randn(gen, 2, 8, 256), _randn(gen, 2, 8, 256)
    launch_counts.clear()
    y = layer(x, res)
    assert launch_counts["bias_dropout_residual_ln"] == 1
    y.backward(dy)
    xc = x.detach().float().cpu().requires_grad_()
    yc = cpu(xc, res.float().cpu())
    yc.backward(dy.float().cpu())
    rel = (y.detach().float().cpu() - yc.detach()).norm() / yc.norm()
    assert rel < 1e-2
    rel = (x.grad.float().cpu() - xc.grad).norm() / xc.grad.norm()
    assert rel < 2e-2


def test_bias_dropout_residual_ln_refuses_what_it_does_not_take(gen):
    from paddle_tpu_torch.ops.cuda import fused_ops as fo

    x = _randn(gen, 4, 64)
    p = _randn(gen, 64)
    mask = torch.ones((4, 64), dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        h = x.half()
        fo.bias_dropout_residual_ln_fwd(h, h, p, p, p, mask, 0.1, 1e-5, True)
    with pytest.raises(TypeError, match="residual"):
        fo.bias_dropout_residual_ln_fwd(x, x.float(), p, p, p, mask, 0.1,
                                        1e-5, True)
    with pytest.raises(TypeError, match="mask"):
        fo.bias_dropout_residual_ln_fwd(x, x, p, p, p, None, 0.1, 1e-5, True)
    with pytest.raises(ValueError, match="mask"):
        fo.bias_dropout_residual_ln_fwd(x, x, p, p, p, mask[:2], 0.1, 1e-5,
                                        True)
    with pytest.raises(ValueError, match="elements"):
        fo.bias_dropout_residual_ln_fwd(x, x, p[:32], p, p, mask, 0.1, 1e-5,
                                        True)
    with pytest.raises(ValueError, match="contiguous"):
        t = _randn(gen, 64, 4).T
        fo.bias_dropout_residual_ln_fwd(t, t, p, p, p, mask, 0.1, 1e-5, True)


def test_tiny_bert_trains_on_card_through_the_flash_kernels(gen):
    """A small BERT (head_dim 64) in bf16: gradients against an f32 CPU
    copy, and AdamW steps through TrainStep lower the loss, launching the
    flash forward, dK/dV and dQ kernels once per layer and step."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        BertForPretraining,
        BertPretrainingCriterion,
        bert_tiny_config,
    )
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_tiny_config(hidden_size=128, num_attention_heads=2,
                           intermediate_size=256,
                           max_position_embeddings=128)
    card = BertForPretraining(cfg, dtype=torch.bfloat16,
                              generator=seed(0, "cuda"))
    cpu = BertForPretraining(cfg, device="cpu", generator=seed(0, "cpu"))
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in card.state_dict().items()})
    ids = torch.randint(0, 256, (2, 128), generator=gen, device="cuda")
    nsp = torch.randint(0, 2, (2, 1), generator=gen, device="cuda")
    crit = BertPretrainingCriterion()
    crit(*card(ids), ids, nsp).backward()
    crit(*cpu(ids.cpu()), ids.cpu(), nsp.cpu()).backward()
    want = dict(cpu.named_parameters())
    for name, p in card.named_parameters():
        if want[name].grad is None:
            assert p.grad is None, name
            continue
        rel = (p.grad.float().cpu() - want[name].grad).norm() / want[
            name].grad.norm()
        assert rel < 5e-2, name
    card.zero_grad()
    step = TrainStep(card, lambda a, b, lab: crit(a, b, *lab),
                     AdamW(learning_rate=1e-3, parameters=card.parameters(),
                           multi_precision=True))
    launch_counts.clear()
    losses = step.run(ids, steps=4, labels=(ids, nsp)).tolist()
    assert losses[-1] < losses[0]
    for k in ("flash_attention", "flash_attention_bwd_dkdv",
              "flash_attention_bwd_dq"):
        assert launch_counts[k] == 4 * cfg.num_hidden_layers, k


# the update's launch groups: (parameter dtype, f32 masters, moment1 dtype,
# coupled L2)
ADAM_CASES = [(torch.bfloat16, True, torch.float32, False),
              (torch.bfloat16, True, torch.bfloat16, False),
              (torch.bfloat16, False, torch.bfloat16, True),
              (torch.bfloat16, False, torch.float32, False),
              (torch.float32, False, torch.float32, True),
              (torch.float32, False, torch.bfloat16, False)]


def _adam_group(gen, pdt, master, mdt, sizes):
    """Parameters of ``sizes`` (the last one 1 element off 16-byte
    alignment), f32 masters or none, random moments (moment2 > 0), lr
    multipliers, decay coefficients and clip slots cycling through
    their cases; returns (group, grads per step) on the card."""
    from paddle_tpu_torch.ops.cuda.multi_tensor_adam import AdamTensors

    work = torch.float32 if master else pdt
    ps, ws, ms, vs = [], [], [], []
    for k, shape in enumerate(sizes):
        n = int(np.prod(shape))
        off = 1 if k == len(sizes) - 1 else 0
        p = _randn(gen, n + off, dtype=pdt)[off:].view(shape)
        ps.append(p)
        ws.append(p.float().clone() if master else None)
        ms.append((0.01 * _randn(gen, *shape, dtype=torch.float32)).to(mdt))
        vs.append((1e-4 * torch.rand(shape, generator=gen, device="cuda"))
                  .to(work))
    grads = [[_randn(gen, p.numel() + 1, dtype=pdt)[1:].view(p.shape)
              if k == len(sizes) - 1 else _randn(gen, *p.shape, dtype=pdt)
              for k, p in enumerate(ps)] for _ in range(3)]
    n = len(sizes)
    group = AdamTensors(ps, ws, ms, vs, [(1.0, 0.5, 2.0)[k % 3]
                                         for k in range(n)],
                        [(0.0, 0.01, 0.1)[k % 3] for k in range(n)],
                        [(-1, 0, 1)[k % 3] for k in range(n)])
    return group, grads


def _clone_group(group):
    from paddle_tpu_torch.ops.cuda.multi_tensor_adam import AdamTensors

    def c(ts):
        return [None if t is None else t.clone() for t in ts]

    return AdamTensors(c(group.params), c(group.masters), c(group.moment1),
                       c(group.moment2), group.lr_mults, group.coeffs,
                       group.slots)


@pytest.mark.parametrize("pdt,master,mdt,coupled", ADAM_CASES)
def test_multi_tensor_adam_kernel(gen, pdt, master, mdt, coupled):
    """Three steps of the update kernel against its plain version on the
    same state: sizes off the chunk and the 8-element vector (1, 7, 8,
    33 x 129, a chunk + 3, three chunks) and a tensor off 16-byte
    alignment, clipped and unclipped tensors, lr multipliers, decay on and
    off. One launch a step. f32 work values within 1e-6 relative (the same
    IEEE operations in the same order), bf16 ones within one bf16 ulp."""
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda import multi_tensor_adam as mta

    sizes = [(1,), (7,), (8,), (33, 129), (mta.CHUNK + 3,),
             (3 * mta.CHUNK,), (4099,)]
    group, grads = _adam_group(gen, pdt, master, mdt, sizes)
    ref = _clone_group(group)
    state = torch.tensor([1e-3, 0.0, 0.5, 0.25], device="cuda")
    launch_counts.clear()
    for t, gs in enumerate(grads, start=1):
        state[1] = t
        mta.multi_tensor_adam(group, gs, state, coupled=coupled)
        mta.multi_tensor_adam_plain(ref, gs, state, coupled=coupled)
    torch.cuda.synchronize()
    tag = "[f32]" if pdt == torch.float32 else ""
    assert launch_counts == {"multi_tensor_adam" + tag: 3}
    tol = (dict(rtol=1e-6, atol=1e-9) if group.work_dtype == torch.float32
           else dict(rtol=2.0 ** -8, atol=1e-6))
    for got, want in ((group.params, ref.params),
                      (group.masters, ref.masters),
                      (group.moment1, ref.moment1),
                      (group.moment2, ref.moment2)):
        for a, b in zip(got, want):
            if a is not None:
                assert torch.isfinite(a.float()).all()
                torch.testing.assert_close(a.float(), b.float(), **tol)


def test_multi_tensor_adam_refuses_what_it_does_not_take(gen):
    """f16 parameters, a gradient of another dtype or not contiguous, a
    state vector not f32: raised before any launch."""
    from paddle_tpu_torch.ops.cuda import multi_tensor_adam as mta

    state = torch.tensor([1e-3, 1.0], device="cuda")
    p = _randn(gen, 64, dtype=torch.float16)
    g16 = mta.AdamTensors([p], [None], [torch.zeros_like(p)],
                          [torch.zeros_like(p)], [1.0], [0.0], [-1])
    with pytest.raises(TypeError):
        mta.multi_tensor_adam(g16, [p.clone()], state)
    q = _randn(gen, 8, 8)
    grp = mta.AdamTensors([q], [None], [torch.zeros_like(q)],
                          [torch.zeros_like(q)], [1.0], [0.0], [-1])
    with pytest.raises(ValueError):
        mta.multi_tensor_adam(grp, [q.float()], state)
    with pytest.raises(ValueError):
        mta.multi_tensor_adam(grp, [_randn(gen, 8, 8).t()], state)
    with pytest.raises(TypeError):
        mta.multi_tensor_adam(grp, [q.clone()], state.double())
