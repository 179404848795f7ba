"""The port's CUDA kernels against their plain versions on the card, at
shapes off the serving and training paths' (ragged lengths, head dims 32
to 256 and the padded route's 80, GQA groups up to 8, causal offsets, empty rows, clamped positions, row
counts off the RMSNorm backward's strip; the decode megakernel at a small
size, at the 438M serving decode and on GQA; the bias-dropout-residual-
LayerNorm kernel at BERT-base's shape, in f32, at odd widths and off
alignment; the segment-masked flash kernels with seq_lens, packed ids and
a pair), the refusals of what the kernels do not take, a tiny model
served fused and unfused, a tiny model trained on the card, the incubate
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


@pytest.mark.parametrize("affine", ["weight", "weight+bias", "bias", "none"])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n,d", [(1, 64), (3, 1536), (37, 100), (5, 4096),
                                 (2, 8192)])
def test_rms_norm_kernel(gen, n, d, aligned, affine):
    """The vector kernel (D a multiple of 8 up to 4096, 16-byte aligned) and
    the strided one (D = 100, D = 8192, or x one element off alignment),
    with and without weight and bias."""
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    x = _randn(gen, n * d + 1)[1:].view(n, d) if not aligned else _randn(
        gen, n, d)
    w = _randn(gen, d) if "weight" in affine else None
    b = _randn(gen, d) if "bias" in affine else None
    y, r = rn.rms_norm_rows(x, w, b, epsilon=1e-5)
    py, pr = rn.rms_norm_plain(x, w, b, epsilon=1e-5)
    _close(y, py)
    torch.testing.assert_close(r, pr, rtol=1e-5, atol=0)


@pytest.mark.parametrize("b,s,h,kvh,d", [(2, 7, 4, 2, 64), (3, 1, 16, 2, 128),
                                         (1, 33, 12, 12, 128),
                                         (2, 9, 32, 32, 96)])
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
                                              (4, 2, 32, 128, 2)])
def test_paged_attention_kernel(gen, h, kvh, d, page, pps):
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    cols, b = 4, 5
    n_pages = b * cols + 1
    rng = np.random.RandomState(0)
    lengths = np.array([0, 1, page, 3 * page + 5, 4 * page], np.int32)
    tables = np.full((b, cols + 1), n_pages - 1, np.int32)  # dump tails
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
    got = da.paged_attention(*args, pages_per_seq=pps)
    _close(got, da.paged_attention_plain(*args, pages_per_seq=pps))
    assert torch.all(got[0] == 0)


@pytest.mark.parametrize("n,d", [(37, 64), (1, 100), (19, 4096),
                                 (64, 1536)])
def test_rms_norm_bwd_kernel(gen, n, d):
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    x, g = _randn(gen, n, d), _randn(gen, n, d)
    w = (1.0 + 0.1 * _randn(gen, d, dtype=torch.float32)).bfloat16()
    _, r = rn.rms_norm_rows(x, w, epsilon=1e-5)
    for got, want in zip(rn.rms_norm_bwd(x, w, r, g),
                         rn.rms_norm_bwd_plain(x, w, r, g)):
        _close(got, want)


@pytest.mark.parametrize("b,s,h,kvh,d", [(2, 7, 4, 2, 64), (1, 33, 12, 12, 128),
                                         (2, 9, 32, 32, 96)])
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
    q = _randn(gen, 1, 32, 64)
    kp = _randn(gen, 2, 16, 2, 64)  # 16 query heads per kv head
    tab = torch.zeros((1, 2), dtype=torch.int32, device="cuda")
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="query heads per kv head"):
        da.paged_attention(q, kp, kp, tab, one)
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


@pytest.mark.parametrize("b,hidden,heads,kvh,d,page,cols,lens", [
    (3, 256, 4, 2, 64, 16, 4, [0, 16, 63]),          # small, group 2
    (8, 1536, 12, 12, 128, 128, 4,                   # the 438M decode
     [1, 17, 127, 128, 200, 255, 256, 510]),
    (4, 1536, 12, 4, 128, 128, 4, [5, 128, 300, 511]),  # GQA, group 3
    (2, 1024, 16, 2, 64, 32, 3, [31, 95]),            # group 8, D = 64
])
def test_decode_megakernel(gen, b, hidden, heads, kvh, d, page, cols, lens):
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk

    args = _megakernel_args(gen, b, hidden, heads, kvh, d, page, cols, lens)
    plain = dict(args, k_pages=args["k_pages"].clone(),
                 v_pages=args["v_pages"].clone())
    got = mk.fused_decode_layer(**args)
    want = mk.fused_decode_layer_plain(**plain)
    _close(got[0], want[0])
    # y2 against the plain norm of the kernel's own h_mid: h_mid may
    # differ by the one bf16 ulp the tolerance admits, and y2 would carry
    # it again
    _close(got[1], mk.decode_norm_plain(got[0], args["ln2_weight"], 1e-6))
    dump = args["dump_page"]
    _close(args["k_pages"][:dump], plain["k_pages"][:dump])
    _close(args["v_pages"][:dump], plain["v_pages"][:dump])
    # the same bits on a second launch (fixed order, no float atomics)
    again = mk.fused_decode_layer(**dict(args, k_pages=args["k_pages"].clone(),
                                         v_pages=args["v_pages"].clone()))
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_decode_megakernel_refuses_what_it_does_not_take(gen):
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk

    base = _megakernel_args(gen, 2, 256, 4, 2, 64, 16, 2, [3, 9])
    # head_dim 96
    a = _megakernel_args(gen, 2, 192, 2, 2, 96, 16, 2, [3, 9])
    with pytest.raises(ValueError, match="head_dim"):
        mk.fused_decode_layer(**a)
    # 16 query heads per kv head
    a = _megakernel_args(gen, 2, 1024, 16, 1, 64, 16, 2, [3, 9])
    with pytest.raises(ValueError, match="query heads per kv head"):
        mk.fused_decode_layer(**a)
    # f32 activations and weights
    a = {k: v.float() if isinstance(v, torch.Tensor) and v.is_floating_point()
         else v for k, v in base.items()}
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
