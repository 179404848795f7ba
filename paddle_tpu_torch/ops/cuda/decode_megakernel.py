"""The decode megakernel: the whole attention half of one decoder layer's
decode step in one launch. The hand-written kernel
(``csrc/decode_megakernel.cuh``), its plain PyTorch version, the wrapper
that picks between them by device, and the probes that decide whether a
layer and a cache can take it.

Counterpart of ``paddle_tpu/ops/pallas/decode_megakernel.py``
(``fused_decode_layer`` :322, ``_megakernel`` :189). For each row b of a
decode step (one new token per sequence, per-sequence pre-append depths):

    xn = rms_norm(x_b) * ln1 -> q, k, v = xn @ wq, wk, wv
    -> neox RoPE of q and k at position clip(lengths[b], 0, rows - 1)
    -> store the new k/v row at (tables[b, len // page], len % page)
    -> online-softmax attention of the query heads over positions [0, len]
       of the visible table columns -> o = att @ wo
    -> h_mid = x + o, y2 = rms_norm(h_mid) * ln2

and the MLP half runs on ``y2`` outside the kernel. Two differences from
the JAX function:

* The pools are updated in place and only ``(h_mid, y2)`` is returned (the
  JAX function returns new pools). The kernel stores just the appended
  row, so the JAX kernel's two flush modes (write-back :244-254, dump page
  :374-385) leave the same pools here: ``dump_page`` stays in the
  signature for parity and changes nothing.
* The probes keep every structural check of the JAX probe (:126-183) but
  not its byte budget. ``MEGAKERNEL_VMEM_BUDGET`` (:69-71) caps the q/k/v/o
  weights at 12 MiB because the Pallas kernel stages them whole in the
  TPU's VMEM (:354, :394-397); the 438M model's 18.9 MB decline there.
  The CUDA kernel streams the weights from device memory once a step
  for the whole batch and holds at most a window of the batch's
  activations in shared memory, so its limits are its own, checked when
  the weights live on a CUDA device: one float type throughout, bf16 or
  f32; a head dim up to ``MAX_HEAD_DIM``; a hidden size that is a
  multiple of 8 up to ``MAX_HIDDEN``. Any GQA group is taken, and any
  batch up to ``MAX_BATCH``. The 438M model takes the fused path on the
  card in both types, and so do Phi-3-mini's widths (head dim 96).

One kernel, ``csrc/decode_megakernel.cuh``, for every case (bf16 and
f32, any even head dim up to 256, any group), entered through
``csrc/decode_megakernel_bf16.cu`` and ``csrc/decode_megakernel_f32.cu``:
a persistent cooperative launch on every SM that splits the q/k/v and
o_proj GEMVs across the SMs, each weight read once a step for all rows,
with grid barriers between its stages (see the source). Its scratch and
barrier state are allocated once per (device, stream) and kept across
calls. An f32 launch counts as ``fused_decode_layer[f32]``.

Outside ``megakernel_scope(True)`` (which the serving engine enters for
its decode steps when it decided at construction to take the fused path)
the layer hook never fires: the port has no global flag.

The plain version rounds where the Pallas kernel rounds (and the CUDA
kernel rounds there too): xn to the model dtype before the projections
(:211-213); q, k and v kept in f32 (:225-237) and the appended row
attended in f32 (:277, :295); k/v rounded to the pool dtype when stored
(:261-266); att rounded to the model dtype before o_proj (:306); o_proj
summed in f32 and rounded; ``h_mid = x + o`` in the model dtype (:314);
``y2 = bf16(h * rsqrt(...)) * ln2`` (:316-319). In f32 that is the
unfused composition, ``reference_decode_layer`` (:439-485).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch

from . import _build

__all__ = ["fused_decode_layer", "fused_decode_layer_plain",
           "decode_attention_o_plain", "decode_norm_plain",
           "megakernel_layer_supported", "megakernel_model_supported",
           "megakernel_supported", "megakernel_scope", "megakernel_enabled",
           "MAX_HEAD_DIM", "MAX_HIDDEN", "MAX_BATCH"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
NEG_INF = -1e30
# the CUDA kernel's limits (csrc/decode_megakernel.cuh)
MAX_HEAD_DIM = 256  # the attention slot's q, k and v rows (kMaxD)
MAX_HIDDEN = 4096  # the shared-memory window of the batch's xn
MAX_BATCH = 4096  # the attention stage's row tables in shared memory

# per-thread stack of scopes: the engine pins dispatch around its calls
_scope = threading.local()


@contextlib.contextmanager
def megakernel_scope(on):
    """Fused decode steps on (True) or off (False) for the enclosed calls
    in this thread. The serving engine runs its decode forward under
    ``megakernel_scope(decided_at_construction)`` and its prefill under
    ``megakernel_scope(False)``."""
    stack = _scope.__dict__.setdefault("stack", [])
    stack.append(bool(on))
    try:
        yield
    finally:
        stack.pop()


def megakernel_enabled():
    """True inside the innermost ``megakernel_scope(True)`` of this thread;
    False inside ``megakernel_scope(False)`` and outside any scope."""
    stack = getattr(_scope, "stack", None)
    return bool(stack) and stack[-1]


def _kernel_takes(attn, norms, d, hidden):
    """The CUDA kernel's own limits, for weights on a CUDA device: q/k/v/o
    and the norm scales contiguous and of one type, bf16 or f32; ``d`` up
    to ``MAX_HEAD_DIM``; ``hidden`` a multiple of 8 up to ``MAX_HIDDEN``.
    Every GQA group is taken."""
    ws = [attn.q_proj.weight, attn.k_proj.weight, attn.v_proj.weight,
          attn.o_proj.weight] + [ln.weight for ln in norms]
    return (d <= MAX_HEAD_DIM and hidden <= MAX_HIDDEN and hidden % 8 == 0
            and ws[0].dtype in _build.FLOATS
            and all(w.dtype == ws[0].dtype and w.is_contiguous()
                    for w in ws))


def megakernel_layer_supported(layer):
    """Structural probe over one decoder layer: bias-free q/k/v/o, RMSNorm
    weights without bias, RoPE tables, ``h % kvh == 0`` and an even head
    dim (the JAX probe's checks, :137-150); and, when the weights live on
    a CUDA device, the kernel's limits in place of the JAX VMEM budget."""
    try:
        attn = layer.self_attn
        cfg = attn.config
        h, kv, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        if h % kv or d % 2:
            return False
        for lin in (attn.q_proj, attn.k_proj, attn.v_proj, attn.o_proj):
            if getattr(lin, "bias", None) is not None:
                return False
        norms = (layer.input_layernorm, layer.post_attention_layernorm)
        for ln in norms:
            if getattr(ln, "weight", None) is None:
                return False
            if getattr(ln, "bias", None) is not None:
                return False
        if not hasattr(attn, "rope_cos") or not hasattr(attn, "rope_sin"):
            return False
        if attn.q_proj.weight.is_cuda and not _kernel_takes(
                attn, norms, d, cfg.hidden_size):
            return False
    except AttributeError:
        return False
    return True


def megakernel_model_supported(model):
    """True when the model has at least one decoder layer and every one
    passes :func:`megakernel_layer_supported` (the engine's probe)."""
    layers = [m for m in model.modules()
              if hasattr(m, "self_attn") and hasattr(m, "mlp")
              and hasattr(m, "input_layernorm")
              and hasattr(m, "post_attention_layernorm")]
    return bool(layers) and all(megakernel_layer_supported(m)
                                for m in layers)


def megakernel_supported(layer, cache):
    """Full eligibility for one fused decode step: a supported layer and a
    paged cache with per-sequence (B,) depths."""
    if not megakernel_layer_supported(layer):
        return False
    k_pages = getattr(cache, "k_pages", None)
    if k_pages is None or k_pages.dim() != 4:
        return False
    length = getattr(cache, "length", None)
    return isinstance(length, torch.Tensor) and length.dim() == 1


def decode_norm_plain(x, weight, eps):
    """RMSNorm over the last axis rounded where the Pallas kernel rounds
    it (:211-213, :316-319): ``bf16(x * rsqrt(mean x^2 + eps)) * weight``
    in x's dtype (two roundings; ``rms_norm_plain`` rounds once)."""
    xf = _build.upcast(x)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * weight


def decode_attention_o_plain(x, *, ln1_weight, ln1_eps, wq, wk, wv, wo,
                             rope_cos, rope_sin, k_pages, v_pages, tables,
                             lengths, heads, attn_pages=None):
    """The plain version's ``o = att @ wo`` (B, hidden), summed in f32 and
    rounded to x's dtype, with the append into the pools: everything of
    :func:`fused_decode_layer_plain` before the residual. The append is
    skipped for a row whose ``len // page`` lies past the table; masked
    positions weigh 0, so a row with no visible position gives ``o = 0``."""
    b = x.shape[0]
    n_pages, page, kvh, d = k_pages.shape
    dt = x.dtype
    xn = _build.upcast(decode_norm_plain(x[:, 0], ln1_weight, ln1_eps))
    wt = xn.dtype
    q = (xn @ wq.to(wt)).view(b, heads, d)
    k = (xn @ wk.to(wt)).view(b, kvh, d)
    v = (xn @ wv.to(wt)).view(b, kvh, d)
    cos2 = rope_cos.reshape(-1, d)
    sin2 = rope_sin.reshape(-1, d)
    lens = lengths.long()
    pos = lens.clamp(0, cos2.shape[0] - 1)
    c, s = cos2.to(wt)[pos][:, None, :], sin2.to(wt)[pos][:, None, :]
    half = d // 2

    def rope(t):
        return t * c + torch.cat([-t[..., half:], t[..., :half]], -1) * s

    q, k = rope(q), rope(k)
    # the append: one row per sequence, in place; a row whose page lies
    # past the table writes its clamped cell's own content back (no
    # boolean indexing, so no host sync and the call can be graph-captured)
    cols = tables.shape[1]
    col = lens // page
    ok = (col < cols)[:, None, None]
    ids = tables.long().gather(1, col.clamp(max=cols - 1)[:, None])[:, 0]
    ids, off = ids.clamp(0, n_pages - 1), lens % page
    k_pages[ids, off] = torch.where(ok, k.to(k_pages.dtype), k_pages[ids, off])
    v_pages[ids, off] = torch.where(ok, v.to(v_pages.dtype), v_pages[ids, off])
    # attention over positions [0, len] of the visible columns; the new
    # row is attended in f32, as the Pallas kernel substitutes it
    walk = cols if attn_pages is None else min(attn_pages, cols)
    vis = tables[:, :walk].long().clamp(0, n_pages - 1)
    kk = k_pages[vis].reshape(b, walk * page, kvh, d).to(wt)
    vv = v_pages[vis].reshape(b, walk * page, kvh, d).to(wt)
    t = torch.arange(walk * page, device=x.device)
    new = (t[None, :] == lens[:, None])[:, :, None, None]
    kk = torch.where(new, k[:, None], kk)
    vv = torch.where(new, v[:, None], vv)
    group = heads // kvh
    kk = kk.repeat_interleave(group, dim=2)
    vv = vv.repeat_interleave(group, dim=2)
    sc = torch.einsum("bhd,bthd->bht", q * (1.0 / math.sqrt(d)), kk)
    valid = (t[None, :] <= lens[:, None])[:, None, :]
    sc = sc.masked_fill(~valid, NEG_INF)
    p = torch.exp(sc - sc.amax(-1, keepdim=True)) * valid
    att = torch.einsum("bht,bthd->bhd", p, vv)
    att = att / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return (_build.upcast(att.to(dt)).reshape(b, heads * d)
            @ wo.to(wt)).to(dt)


def fused_decode_layer_plain(x, *, ln1_weight, ln1_eps, wq, wk, wv, wo,
                             rope_cos, rope_sin, ln2_weight, ln2_eps,
                             k_pages, v_pages, tables, lengths, heads,
                             attn_pages=None, dump_page=None):
    """See :func:`fused_decode_layer`: :func:`decode_attention_o_plain`,
    then ``h_mid = x + o`` in x's dtype and its ln2."""
    del dump_page  # only the appended row is stored: see the module doc
    o = decode_attention_o_plain(
        x, ln1_weight=ln1_weight, ln1_eps=ln1_eps, wq=wq, wk=wk, wv=wv,
        wo=wo, rope_cos=rope_cos, rope_sin=rope_sin, k_pages=k_pages,
        v_pages=v_pages, tables=tables, lengths=lengths, heads=heads,
        attn_pages=attn_pages)
    h_mid = x[:, 0] + o
    y2 = decode_norm_plain(h_mid, ln2_weight, ln2_eps)
    return h_mid[:, None], y2[:, None]


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


# (dtype, b, hidden, heads, kv heads, d, page, walk) -> (work bytes, state
# int32s), from the library's own plan
_sizes: dict = {}
# (device index, stream handle) -> [work, state, retired buffers]: the
# kernel's scratch and barrier state, kept across calls. A buffer that is
# outgrown stays referenced, so that a CUDA graph captured with it keeps
# valid memory.
_scratch: dict = {}


def _scratch_for(x, dt, b, hidden, heads, kvh, d, page, walk):
    key = (dt, b, hidden, heads, kvh, d, page, walk)
    sizes = _sizes.get(key)
    if sizes is None:
        out = (ctypes.c_longlong * 2)()
        fn = _build.function("ptt_fused_decode_layer_scratch",
                             [_I] * 8 + [ctypes.POINTER(ctypes.c_longlong)])
        _build.check(fn(x.element_size(), b, hidden, heads, kvh, d, page,
                        walk, out), "fused_decode_layer")
        sizes = _sizes[key] = (int(out[0]), int(out[1]))
    slot_key = (x.device.index, _build.stream_of(x))
    slot = _scratch.get(slot_key)
    if (slot is None or slot[0].numel() < sizes[0]
            or slot[1].numel() < sizes[1]):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "fused_decode_layer: no scratch of this size on the "
                "capturing stream; run the layer once on it before capture")
        work = max(sizes[0], slot[0].numel() if slot else 0)
        state = max(sizes[1], slot[1].numel() if slot else 0)
        retired = (slot[2] + [slot[0], slot[1]]) if slot else []
        # zeroed once: the kernel leaves its barrier at rest
        slot = _scratch[slot_key] = [
            torch.empty(work, dtype=torch.uint8, device=x.device),
            torch.zeros(state, dtype=torch.int32, device=x.device), retired]
    return slot[0], slot[1]


def fused_decode_layer(x, *, ln1_weight, ln1_eps, wq, wk, wv, wo, rope_cos,
                       rope_sin, ln2_weight, ln2_eps, k_pages, v_pages,
                       tables, lengths, heads, attn_pages=None,
                       dump_page=None):
    """One fused decode step of one decoder layer's attention half.

    x (B, 1, hidden); weights in the ``(in, out)`` layout, wq (hidden,
    heads * D), wk and wv (hidden, KVH * D), wo (heads * D, hidden); f32
    (rows, D) RoPE tables; pools (num_pages, page, KVH, D); tables (B,
    cols) int32; lengths (B,) int32 PRE-append depths. ``attn_pages`` caps
    the table columns attention reads; ``dump_page`` changes nothing here
    (see the module doc). Returns ``(h_mid, y2)``, each (B, 1, hidden),
    and writes the new k/v rows into the pools; the caller advances the
    cache's length by one.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (activations, norm scales, weights and pools all bf16 or all
    f32, f32 RoPE tables, int32 tables and lengths, all contiguous and
    16-byte aligned; an even D up to ``MAX_HEAD_DIM``, any number of query
    heads per kv head, hidden a multiple of 8 up to ``MAX_HIDDEN``, up to
    ``MAX_BATCH`` rows) or raises, a refused cooperative launch included.
    An f32 launch counts as ``fused_decode_layer[f32]``."""
    kw = dict(ln1_weight=ln1_weight, ln1_eps=ln1_eps, wq=wq, wk=wk, wv=wv,
              wo=wo, rope_cos=rope_cos, rope_sin=rope_sin,
              ln2_weight=ln2_weight, ln2_eps=ln2_eps, k_pages=k_pages,
              v_pages=v_pages, tables=tables, lengths=lengths, heads=heads,
              attn_pages=attn_pages, dump_page=dump_page)
    if x.device.type == "cpu":
        return fused_decode_layer_plain(x, **kw)
    name = "fused_decode_layer"
    _build.expect(name, "x", x, _build.FLOATS, 3)
    dt = x.dtype
    for arg in ("ln1_weight", "ln2_weight"):
        _build.expect(name, arg, kw[arg], dt, 1)
    for arg in ("wq", "wk", "wv", "wo"):
        _build.expect(name, arg, kw[arg], dt, 2)
    for arg in ("rope_cos", "rope_sin"):
        _build.expect(name, arg, kw[arg], torch.float32, 2)
    _build.expect(name, "k_pages", k_pages, dt, 4)
    _build.expect(name, "v_pages", v_pages, dt, 4)
    _build.expect(name, "tables", tables, torch.int32, 2)
    _build.expect(name, "lengths", lengths, torch.int32, 1)
    b, s, hidden = x.shape
    n_pages, page, kvh, d = k_pages.shape
    cols = tables.shape[1]
    if (s != 1 or b > MAX_BATCH or v_pages.shape != k_pages.shape or d % 2
            or d > MAX_HEAD_DIM or heads % kvh
            or hidden % 8 or hidden > MAX_HIDDEN
            or wq.shape != (hidden, heads * d)
            or wk.shape != (hidden, kvh * d) or wv.shape != wk.shape
            or wo.shape != (heads * d, hidden)
            or ln1_weight.shape != (hidden,) or ln2_weight.shape != (hidden,)
            or rope_cos.shape[1] != d or rope_sin.shape != rope_cos.shape
            or tables.shape[0] != b or lengths.shape[0] != b):
        raise ValueError(
            f"{name}: x {tuple(x.shape)}, heads {heads}, wq "
            f"{tuple(wq.shape)}, wk {tuple(wk.shape)}, wv {tuple(wv.shape)}, "
            f"wo {tuple(wo.shape)}, rope {tuple(rope_cos.shape)}, pools "
            f"{tuple(k_pages.shape)}, tables {tuple(tables.shape)}, lengths "
            f"{tuple(lengths.shape)}; head_dim must be even and at most "
            f"{MAX_HEAD_DIM}, the query heads a multiple of the kv heads, "
            f"hidden a multiple of 8 up to {MAX_HIDDEN}, and at most "
            f"{MAX_BATCH} rows")
    if not _aligned(x, wq, wk, wv, wo, k_pages, v_pages):
        raise ValueError(f"{name}: x, weights and pools must be 16-byte "
                         f"aligned")
    walk = cols if attn_pages is None else min(attn_pages, cols)
    h_mid = torch.empty_like(x)
    y2 = torch.empty_like(x)
    work, state = _scratch_for(x, dt, b, hidden, heads, kvh, d, page, walk)
    entry = ("ptt_fused_decode_layer_f32" if dt == torch.float32
             else "ptt_fused_decode_layer")
    fn = _build.function(entry, [_P] * 17 + [_I] * 10 + [_F] * 3 + [_P])
    _build.check(fn(x.data_ptr(), ln1_weight.data_ptr(),
                    ln2_weight.data_ptr(), wq.data_ptr(), wk.data_ptr(),
                    wv.data_ptr(), wo.data_ptr(), rope_cos.data_ptr(),
                    rope_sin.data_ptr(), k_pages.data_ptr(),
                    v_pages.data_ptr(), tables.data_ptr(), lengths.data_ptr(),
                    h_mid.data_ptr(), y2.data_ptr(), work.data_ptr(),
                    state.data_ptr(), b, hidden, heads, kvh, d,
                    rope_cos.shape[0], page, n_pages, cols, walk,
                    float(ln1_eps), float(ln2_eps), 1.0 / math.sqrt(d),
                    _build.stream_of(x)), name)
    _build.count(name, dt)
    return h_mid, y2
