"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper in ``paddle_tpu_torch/ops/cuda`` runs its plain
PyTorch version (the CUDA kernels run only on the card; ``chip_smoke.py``
holds them against these plain versions there). The JAX side runs its
Pallas kernels in interpret mode, as its own tests do. Inputs come from
numpy with a seed; everything is f32, and the tolerance, 2e-5, covers
reassociation of f32 sums (the results agree to ~1e-6).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_kernels as jax_nn
from paddle_tpu.ops.pallas import decode_attention as jax_da
from paddle_tpu.ops.pallas import flash_attention as jax_fa
from paddle_tpu.ops.pallas import fused_ops as jax_fo
from paddle_tpu.ops.pallas import rms_norm as jax_rn
from paddle_tpu_torch.models.llama import _rope_tables
from paddle_tpu_torch.ops import nn_kernels
from paddle_tpu_torch.ops.cuda import decode_attention as da
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import fused_ops as fo
from paddle_tpu_torch.ops.cuda import rms_norm as rn


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


TOL = dict(atol=2e-5, rtol=2e-5)


def _np(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_matches_pallas():
    rng = np.random.RandomState(0)
    x, w = _np(rng, 16, 128), 1.0 + 0.1 * _np(rng, 128)
    want = jax_rn.rms_norm(jnp.asarray(x), jnp.asarray(w),
                           jnp.zeros((128,), jnp.float32), 1e-6, False)
    y, r = rn.rms_norm_rows(_t(x), _t(w), epsilon=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    _, (_, _, want_r, _) = jax_rn._vjp_fwd(
        jnp.asarray(x), jnp.asarray(w), None, 1e-6, False)
    np.testing.assert_allclose(r.numpy(), np.asarray(want_r), **TOL)
    # the model-facing op takes any leading shape
    y3 = nn_kernels.rms_norm(_t(x).reshape(2, 8, 128), _t(w),
                             epsilon=1e-6)
    np.testing.assert_allclose(y3.reshape(16, 128).numpy(), np.asarray(want),
                               **TOL)


def test_rope_matches_pallas_fused_rope():
    rng = np.random.RandomState(1)
    b, s, h, kvh, d = 2, 24, 4, 2, 32
    q, k = _np(rng, b, s, h, d), _np(rng, b, s, kvh, d)
    cos, sin = _rope_tables(d, 64, 10000.0, "cpu")
    wq, wk = jax_fo.fused_rope(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(cos.numpy()),
                               jnp.asarray(sin.numpy()))
    gq, gk = nn_kernels.rotary_position_embedding(_t(q), _t(k), cos, sin)
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)


def test_rope_matches_jax_gather_path_per_row_positions():
    rng = np.random.RandomState(2)
    b, s, h, kvh, d = 3, 1, 4, 2, 32
    q, k = _np(rng, b, s, h, d), _np(rng, b, s, kvh, d)
    pos = np.array([[5], [0], [63]], np.int32)  # per-slot decode depths
    cos, sin = _rope_tables(d, 64, 10000.0, "cpu")
    wq, wk = jax_nn.rotary_position_embedding(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos.numpy()),
        jnp.asarray(sin.numpy()), position_ids=jnp.asarray(pos))
    gq, gk = nn_kernels.rotary_position_embedding(_t(q), _t(k), cos, sin,
                                                  _t(pos))
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(causal):
    rng = np.random.RandomState(3)
    b, s, h, kvh, d = 2, 128, 4, 2, 32
    q, k, v = _np(rng, b, s, h, d), _np(rng, b, s, kvh, d), _np(rng, b, s, kvh, d)
    want_o, want_lse = jax_fa._fwd(
        *(jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)), causal,
        1.0 / math.sqrt(d))
    out, lse = fa.flash_attention_fwd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(),
                               np.swapaxes(np.asarray(want_o), 1, 2), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0],
                               **TOL)
    got = nn_kernels.scaled_dot_product_attention(_t(q), _t(k), _t(v),
                                                  is_causal=causal)
    np.testing.assert_allclose(got.numpy(), out.numpy(), atol=0, rtol=0)


def _paged_inputs(rng, lengths, cols, page=16, kvh=2, h=4, d=32):
    """Pool with scattered tables: each row's pages are a random draw from
    the pool; cells past a row's pages hold the last (dump) page."""
    b = len(lengths)
    n_pages = b * cols + 1
    perm = rng.permutation(n_pages - 1)
    tables = np.full((b, cols), n_pages - 1, np.int32)
    used = 0
    for i, n in enumerate(lengths):
        np_ = min(-(-n // page), cols)
        tables[i, :np_] = perm[used:used + np_]
        used += np_
    return (_np(rng, b, h, d), _np(rng, n_pages, page, kvh, d),
            _np(rng, n_pages, page, kvh, d), tables,
            np.asarray(lengths, np.int32))


@pytest.mark.parametrize("pages_per_seq,h,kvh", [
    pytest.param(None, 4, 2, id="None"), pytest.param(3, 4, 2, id="3"),
    # GQA groups past 8: multi-query attention and a group of 12
    pytest.param(None, 12, 1, id="h12-kvh1"),
    pytest.param(3, 24, 2, id="h24-kvh2")])
def test_paged_attention_matches_pallas(pages_per_seq, h, kvh):
    rng = np.random.RandomState(4)
    # page boundaries (16, 32, 48), mid-page, one token, and a length
    # past the pages_per_seq cap
    q, kp, vp, tables, lens = _paged_inputs(rng, [16, 32, 7, 1, 48, 60],
                                            cols=4, kvh=kvh, h=h)
    want = jax_da.paged_attention(*(jnp.asarray(a) for a in
                                    (q, kp, vp, tables, lens)),
                                  pages_per_seq=pages_per_seq)
    got = da.paged_attention(*(_t(a) for a in (q, kp, vp, tables, lens)),
                             pages_per_seq=pages_per_seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_masked_decode_attention_matches_pallas():
    rng = np.random.RandomState(5)
    b, max_len, kvh, h, d = 3, 48, 2, 4, 32
    q = _np(rng, b, h, d)
    kc, vc = _np(rng, b, max_len, kvh, d), _np(rng, b, max_len, kvh, d)
    lens = np.array([48, 17, 1], np.int32)
    want = jax_da.masked_decode_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, lens)))
    got = da.masked_decode_attention(*(_t(a) for a in (q, kc, vc, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_attention_zero_length_row_is_zero():
    rng = np.random.RandomState(6)
    q, kp, vp, tables, _ = _paged_inputs(rng, [16, 5], cols=2)
    got = da.paged_attention(*(_t(a) for a in (q, kp, vp, tables)),
                             torch.tensor([0, 5], dtype=torch.int32))
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()


@pytest.mark.parametrize("case", ["rms_norm", "rope", "flash", "paged"])
def test_wrappers_take_plain_version_only_on_cpu(case):
    """A tensor that is neither on the CPU nor usable by a kernel (here on
    the meta device) raises instead of falling back to the plain version."""
    m = torch.device("meta")
    e = lambda *s, dt=torch.bfloat16: torch.empty(s, device=m, dtype=dt)
    calls = {
        "rms_norm": lambda: rn.rms_norm_rows(e(8, 64), e(64)),
        "rope": lambda: fo.fused_rope_at(e(1, 4, 2, 64), e(1, 4, 2, 64),
                                      e(8, 64, dt=torch.float32),
                                      e(8, 64, dt=torch.float32),
                                      e(1, 4, dt=torch.int32)),
        "flash": lambda: fa.flash_attention_fwd(
            e(1, 4, 2, 64), e(1, 4, 2, 64), e(1, 4, 2, 64)),
        "paged": lambda: da.paged_attention(
            e(1, 2, 64), e(3, 16, 2, 64), e(3, 16, 2, 64),
            e(1, 2, dt=torch.int32), e(1, dt=torch.int32)),
    }
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        calls[case]()
