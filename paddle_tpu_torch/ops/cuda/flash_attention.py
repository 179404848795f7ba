"""Flash attention, forward and backward: the hand-written kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu`` and their
f32 twins), their
plain PyTorch versions, the wrappers that pick between them by device,
and the ``torch.autograd.Function`` that joins them.

Counterpart of ``paddle_tpu/ops/pallas/flash_attention.py``: the public
:func:`flash_attention` (JAX's :431, same signature, returns ``out`` and is
differentiable), :func:`flash_attention_fwd` (JAX's ``_fwd`` :137 over
``_fwd_kernel``: out and lse), and ``_bwd_dkdv_kernel`` and
``_bwd_dq_kernel`` behind its custom_vjp. Layout is the public
(B, S, H, D) of ``scaled_dot_product_attention``; the kernels read it in
place, so no transpose runs around them. Segment masking (``seq_lens``,
``segment_ids``; JAX's ``masked=True`` kernels) folds into (B, S) int32 ids
by :func:`build_segments` (JAX's :399): an entry counts only where the
query's id equals the key's, besides the causal term.

A query row with no visible key (causal with sq > sk, or a segment missing
from the keys) gets out = 0 and lse = -1e30 in every version here, and adds
nothing to dQ, dK or dV. JAX leaves such rows "finite garbage" whose value
depends on its tiles, so the port defines them once.

Head dims: the kernels are built at the widths of :data:`HEAD_DIMS`, and
take any other head dim up to :data:`MAX_HEAD_DIM` (JAX's
``flash_attention_supported`` bound) by the padded route
(:func:`padded_fwd`, :func:`padded_bwd`): q, k, v (and dO) zero-padded to
the next built width, the kernels launched with the scale of the true
head dim, out, dQ, dK and dV sliced back. Zero columns add nothing to
q . k and give zero output and gradient columns, so the result is the
unpadded function's; such launches count as ``<kernel>[pad]``.

Dtypes: every kernel takes bf16 (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, tensor cores) and f32 (the forward
``csrc/flash_attention_f32.cu``, dK/dV ``csrc/flash_attention_bwd_f32.cu``
and dQ ``csrc/flash_attention_bwd_dq_f32.cu``, all on the tensor cores in
3xTF32: JAX's f32 kernels round nothing, and one TF32 product would miss
the f32 gate), q, k, v, out and dO all of one dtype; an f32 launch counts
with ``[f32]`` appended, after ``[seg]`` and ``[pad]``
(``flash_attention_bwd_dq[seg][f32]``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_bwd_dkdv",
           "flash_attention_bwd_dq", "FlashAttentionFunction",
           "build_segments", "segment_ranges", "native_head_dim",
           "padded_fwd", "padded_bwd", "HEAD_DIMS", "MAX_HEAD_DIM"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 128, 256)  # the kernels' instantiations
MAX_HEAD_DIM = 256  # the widest head dim the kernels take, padded or not
CHUNK = 32  # rows per entry of the segment-range table


def build_segments(b, sq, sk, seq_lens=None, segment_ids=None, *,
                   device=None):
    """Fold per-sequence valid lengths and/or packed-segment ids into (B,
    Sq) and (B, Sk) int32 segment ids on ``device``, the port's copy of
    JAX's ``build_segments``. Padding positions get -1, so they match only
    other padding of the same row. ``segment_ids`` is one (B, S) array
    (shared: requires sq == sk) or a ``(q_ids, k_ids)`` pair for cross
    attention. Returns ``(q_seg, k_seg)``, or ``(None, None)`` when neither
    is given."""
    if seq_lens is None and segment_ids is None:
        return None, None

    def ids(a):
        return torch.as_tensor(a, device=device).to(torch.int32)

    if segment_ids is not None:
        if isinstance(segment_ids, (tuple, list)):
            q_seg, k_seg = ids(segment_ids[0]), ids(segment_ids[1])
        else:
            if sq != sk:
                raise ValueError(
                    f"a single shared segment_ids array requires sq == sk "
                    f"(got sq={sq}, sk={sk}); pass a (q_ids, k_ids) pair "
                    f"for cross-attention")
            q_seg = k_seg = ids(segment_ids)
    else:
        q_seg = torch.zeros((b, sq), dtype=torch.int32, device=device)
        k_seg = q_seg if sq == sk else torch.zeros(
            (b, sk), dtype=torch.int32, device=device)
    if seq_lens is not None:
        lens = ids(seq_lens)[:, None]

        def cut(seg):
            pos = torch.arange(seg.shape[1], device=device)[None]
            return torch.where(pos < lens, seg, -1).to(torch.int32)

        # one array for both sides stays one (the kernels then build one
        # range table)
        q_seg, k_seg = (cut(q_seg),) * 2 if k_seg is q_seg else (cut(q_seg),
                                                                 cut(k_seg))
    return q_seg, k_seg


def segment_ranges(seg):
    """(min, max) of each CHUNK ids of a (B, S) id array: two (B, ceil(S /
    CHUNK)) int32 tensors, the last chunk's tail filled with its row's last
    id. The kernels skip a tile pair whose id ranges do not meet: no id of
    one side can equal an id of the other there. Bookkeeping of plain torch
    ops before a launch (one launch when S is a multiple of CHUNK)."""
    b, s = seg.shape
    n = -(-s // CHUNK)
    if n * CHUNK != s:
        seg = torch.cat([seg, seg[:, -1:].expand(b, n * CHUNK - s)], 1)
    lo, hi = torch.aminmax(seg.view(b, n, CHUNK), dim=-1)
    return lo, hi


def _keep(sq, sk, causal, q_seg, k_seg, device):
    """Which (query, key) entries count, as a bool mask broadcasting to
    (B, H, Sq, Sk), or None when all do: causal rows see keys ``c <= r +
    (Sk - Sq)``, and with segments only keys of the row's own id."""
    keep = None
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
            sk - sq)
    if q_seg is not None:
        same = (q_seg[:, None, :, None] == k_seg[:, None, None, :])
        keep = same if keep is None else same & keep
    return keep


def native_head_dim(d):
    """The kernels' width that serves head dim ``d``: ``d`` itself when it
    is one of :data:`HEAD_DIMS`, else the next of them (the padded route).
    Raises ``ValueError`` past :data:`MAX_HEAD_DIM`."""
    for w in HEAD_DIMS:
        if d <= w:
            return w
    raise ValueError(f"flash_attention: head_dim {d} is past the kernels' "
                     f"{MAX_HEAD_DIM} (scaled_dot_product_attention takes "
                     f"the plain composition there)")


def _pad_to(t, width):
    d = t.shape[-1]
    return t if d == width else torch.nn.functional.pad(t, (0, width - d))


def padded_fwd(fwd, q, k, v, causal=True, q_seg=None, k_seg=None):
    """``fwd`` (a forward with the signature of
    :func:`flash_attention_fwd_plain`) at the next built width: q, k, v
    zero-padded to :func:`native_head_dim`, ``scale`` that of the true head
    dim, out sliced back; lse is unchanged by the zero columns."""
    d = q.shape[-1]
    w = native_head_dim(d)
    out, lse = fwd(_pad_to(q, w), _pad_to(k, w), _pad_to(v, w), causal,
                   q_seg, k_seg, scale=1.0 / math.sqrt(d))
    return out[..., :d].contiguous(), lse


def padded_bwd(bwd, q, k, v, out, lse, do, causal=True, q_seg=None,
               k_seg=None):
    """``bwd`` (a backward with the signature of
    :func:`flash_attention_bwd_plain`) at the next built width, as
    :func:`padded_fwd`: ``delta = rowsum(dO * O)`` is the same at either
    width, and dQ, dK, dV are sliced back."""
    d = q.shape[-1]
    w = native_head_dim(d)
    grads = bwd(*(_pad_to(t, w) for t in (q, k, v, out)), lse, _pad_to(do, w),
                causal, q_seg, k_seg, scale=1.0 / math.sqrt(d))
    return tuple(g[..., :d].contiguous() for g in grads)


def flash_attention_fwd_plain(q, k, v, causal=True, q_seg=None, k_seg=None,
                              *, scale=None):
    """q (B, Sq, H, D), k/v (B, Sk, KVH, D) -> (out like q, lse (B, H, Sq)
    f32). Softmax in f32 of ``(q * scale) . k``, ``scale`` 1 / sqrt(D)
    unless given; causal rows see keys ``c <= r + (Sk - Sq)``; with (B,
    Sq) ``q_seg`` and (B, Sk) ``k_seg`` an entry counts only where the ids
    are equal; query head h reads kv head ``h // (H // KVH)``. A row with
    no visible key gets out = 0 and lse = -1e30, as in the kernel."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = _build.upcast(q).transpose(1, 2) * scale
    kf = _build.upcast(k).transpose(1, 2).repeat_interleave(group, dim=1)
    vf = _build.upcast(v).transpose(1, 2).repeat_interleave(group, dim=1)
    s = qf @ kf.transpose(-1, -2)
    keep = _keep(sq, sk, causal, q_seg, k_seg, q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)  # all 0 on a row that sees no key
        lse = lse.masked_fill(~keep.any(-1), NEG_INF)
    out = p @ vf
    return out.transpose(1, 2).to(q.dtype), lse


def _check(name, q, k, v):
    for arg, t in (("q", q), ("k", k), ("v", v)):
        _build.expect(name, arg, t, _build.FLOATS if arg == "q" else q.dtype,
                      4)
        if t.data_ptr() % 16:  # the kernels copy rows 16 bytes at a time
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    b, sq, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or d > MAX_HEAD_DIM or h % k.shape[2] or sq == 0):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; head_dim must be at most "
                         f"{MAX_HEAD_DIM} and heads a multiple of kv heads")


def _segments(name, q, k, q_seg, k_seg):
    """``(pointers, tensors)`` of a launch's segments: the six pointers of
    the ids and their range tables, each side's, all null without segments
    (the unmasked kernels), and the tensors behind them, kept alive
    through the launch. Ids are (B, Sq) and (B, Sk) int32 on the card,
    contiguous; 4-byte alignment is all the kernels need of them."""
    if q_seg is None and k_seg is None:
        return (None,) * 6, ()
    if q_seg is None or k_seg is None:
        raise ValueError(f"{name}: q_seg and k_seg go together")
    b, sq = q.shape[:2]
    for arg, t, s in (("q_seg", q_seg, sq), ("k_seg", k_seg, k.shape[1])):
        _build.expect(name, arg, t, torch.int32, 2)
        if tuple(t.shape) != (b, s):
            raise ValueError(f"{name}: {arg} must be {(b, s)}, got "
                             f"{tuple(t.shape)}")
    q_rng = segment_ranges(q_seg)
    shared = (k_seg.data_ptr() == q_seg.data_ptr()
              and k_seg.shape == q_seg.shape)  # one id array: one table
    k_rng = q_rng if shared else segment_ranges(k_seg)
    keep = (q_seg, k_seg, *q_rng, *k_rng)  # alive through the launch
    return tuple(t.data_ptr() for t in keep), keep


def flash_attention_fwd(q, k, v, causal=True, q_seg=None, k_seg=None):
    """Attention forward with lse (see :func:`flash_attention_fwd_plain`).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (bf16 or f32, q, k and v alike, contiguous, 16-byte aligned, D at most
    256, H a multiple of KVH; ids int32 (B, Sq) and (B, Sk)) or raises. A
    head dim off :data:`HEAD_DIMS` takes the padded route. A launch with
    segments counts as ``flash_attention[seg]``, a padded one with
    ``[pad]`` appended, an f32 one with ``[f32]``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, q_seg, k_seg)
    seg = _segments("flash_attention", q, k, q_seg, k_seg)
    if q.shape[-1] in HEAD_DIMS:
        return _launch_fwd(q, k, v, causal, seg)

    def launch(q, k, v, causal, q_seg, k_seg, scale):
        return _launch_fwd(q, k, v, causal, seg, scale)

    return padded_fwd(launch, q, k, v, causal)


def _suffix(seg, scale):
    """The launch count's name suffix: ``[seg]`` for segment ids, ``[pad]``
    for the padded route (a scale given for a padded width)."""
    return ("[seg]" if seg[1] else "") + ("" if scale is None else "[pad]")


def _entry(q):
    """The C entry's suffix for q's dtype: ``_f32`` for the f32 kernels."""
    return "_f32" if q.dtype == torch.float32 else ""


def _launch_fwd(q, k, v, causal, seg, scale=None):
    name = "flash_attention"
    _check(name, q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.function("ptt_flash_attention_fwd" + _entry(q),
                         [_P] * 11 + [_I] * 6 + [_F, _I, _P])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), *seg[0], b, sq, k.shape[1], h, k.shape[2],
                    d, 1.0 / math.sqrt(d) if scale is None else scale,
                    int(bool(causal)), _build.stream_of(q)), name)
    _build.count(name + _suffix(seg, scale), q.dtype)
    return out, lse


def flash_attention(q, k, v, is_causal=False, seq_lens=None,
                    segment_ids=None):
    """(B, S, H, D) attention, the JAX package's public flash attention:
    returns ``out`` only, non-causal unless ``is_causal``, GQA by index.
    ``seq_lens`` (B,) masks queries and keys past each row's length and
    ``segment_ids`` keeps attention within equal ids (packed sequences);
    both fold into ids by :func:`build_segments` and compose with
    ``is_causal``. A padding row attends to its row's padding; a row with
    no visible key gives 0. Under autograd it records
    :class:`FlashAttentionFunction` (the forward kernel, then dK/dV and
    dQ); otherwise :func:`flash_attention_fwd` alone."""
    q_seg, k_seg = build_segments(q.shape[0], q.shape[1], k.shape[1],
                                  seq_lens, segment_ids, device=q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, bool(is_causal), q_seg,
                                            k_seg)
    return flash_attention_fwd(q, k, v, bool(is_causal), q_seg, k_seg)[0]


def _delta(out, do):
    """``rowsum(dO * O)`` as (B, H, Sq) in f32, the layout of lse; formed
    outside the kernels, as the JAX package forms it in XLA."""
    return (_build.upcast(do) * _build.upcast(out)).sum(-1).transpose(
        1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True, q_seg=None,
                              k_seg=None, *, scale=None):
    """``(dq, dk, dv)`` of :func:`flash_attention_fwd_plain` from the
    forward's ``out`` and ``lse`` and the output gradient ``do``, by the FA2
    formulas over the full score matrix, in f32: ``P = exp(S - lse)``, set
    to 0 on every masked entry (causal or segment; a row with no visible
    key, whose lse is -1e30, so adds nothing), ``dV = P^T dO``,
    ``dS = P * (dO V^T - delta) * scale`` with ``delta = rowsum(dO * O)``,
    ``dQ = dS K``, ``dK = dS^T Q``; a GQA kv head's dK and dV sum over its
    group of query heads. ``scale`` is 1 / sqrt(D) unless given."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    group = h // kvh
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = _build.upcast(q).transpose(1, 2)
    kf = _build.upcast(k).transpose(1, 2).repeat_interleave(group, dim=1)
    vf = _build.upcast(v).transpose(1, 2).repeat_interleave(group, dim=1)
    dof = _build.upcast(do).transpose(1, 2)
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale
                  - _build.upcast(lse)[..., None])
    keep = _keep(sq, sk, causal, q_seg, k_seg, q.device)
    if keep is not None:
        p = p.masked_fill(~keep, 0.0)
    ds = p * (dof @ vf.transpose(-1, -2) - _delta(out, do)[..., None]) * scale
    dq = ds @ kf
    dk = (ds.transpose(-1, -2) @ qf).view(b, kvh, group, sk, d).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(b, kvh, group, sk, d).sum(2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def _bwd_args(name, q, k, v, do, lse, delta):
    _check(name, q, k, v)
    _build.expect(name, "do", do, q.dtype, 4)
    if do.data_ptr() % 16:
        raise ValueError(f"{name}: do must be 16-byte aligned")
    _build.expect(name, "lse", lse, torch.float32, 3)
    _build.expect(name, "delta", delta, torch.float32, 3)
    b, sq, h, d = q.shape
    if do.shape != q.shape or lse.shape != (b, h, sq) or delta.shape != (
            b, h, sq):
        raise ValueError(f"{name}: q {tuple(q.shape)}, do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)}")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def _bwd_sizes(q, k, causal, scale):
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d,
            1.0 / math.sqrt(d) if scale is None else scale,
            int(bool(causal)), _build.stream_of(q))


def _launch_dkdv(q, k, v, do, lse, delta, causal, seg, scale=None):
    name = "flash_attention_bwd_dkdv"
    ptrs = _bwd_args(name, q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _build.function("ptt_" + name + _entry(q),
                         [_P] * 14 + [_I] * 6 + [_F, _I, _P])
    _build.check(fn(*ptrs, dk.data_ptr(), dv.data_ptr(), *seg[0],
                    *_bwd_sizes(q, k, causal, scale)), name)
    _build.count(name + _suffix(seg, scale), q.dtype)
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, causal, seg, scale=None):
    name = "flash_attention_bwd_dq"
    ptrs = _bwd_args(name, q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    fn = _build.function("ptt_" + name + _entry(q),
                         [_P] * 13 + [_I] * 6 + [_F, _I, _P])
    _build.check(fn(*ptrs, dq.data_ptr(), *seg[0],
                    *_bwd_sizes(q, k, causal, scale)), name)
    _build.count(name + _suffix(seg, scale), q.dtype)
    return dq


def _pad_launch(launch, q, k, v, do, lse, delta, causal, seg):
    """``launch`` on the inputs as they are at a built head dim, else on
    q, k, v and dO zero-padded to the next built width with the true
    scale, its outputs sliced back (the padded route)."""
    d = q.shape[-1]
    if d in HEAD_DIMS:
        return launch(q, k, v, do, lse, delta, causal, seg)
    w = native_head_dim(d)
    got = launch(*(_pad_to(t, w) for t in (q, k, v, do)), lse, delta, causal,
                 seg, 1.0 / math.sqrt(d))
    if isinstance(got, tuple):
        return tuple(g[..., :d].contiguous() for g in got)
    return got[..., :d].contiguous()


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, causal=True,
                             q_seg=None, k_seg=None):
    """Launch the dK/dV kernel (CUDA tensors only): ``(dk, dv)`` like k
    and v, from ``delta = rowsum(dO * O)`` (B, H, Sq) f32. With segment
    ids the launch counts as ``flash_attention_bwd_dkdv[seg]``; a head dim
    off :data:`HEAD_DIMS` takes the padded route (``[pad]``)."""
    return _pad_launch(_launch_dkdv, q, k, v, do, lse, delta, causal,
                       _segments("flash_attention_bwd_dkdv", q, k, q_seg,
                                 k_seg))


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=True, q_seg=None,
                           k_seg=None):
    """Launch the dQ kernel (CUDA tensors only): ``dq`` like q. With
    segment ids the launch counts as ``flash_attention_bwd_dq[seg]``; a
    head dim off :data:`HEAD_DIMS` takes the padded route (``[pad]``)."""
    return _pad_launch(_launch_dq, q, k, v, do, lse, delta, causal,
                       _segments("flash_attention_bwd_dq", q, k, q_seg,
                                 k_seg))


def flash_attention_bwd(q, k, v, out, lse, do, causal=True, q_seg=None,
                        k_seg=None):
    """``(dq, dk, dv)`` as :func:`flash_attention_bwd_plain`. A CPU tensor
    takes the plain version; a CUDA tensor forms ``delta`` and the segment
    range tables in torch and launches the dK/dV kernel and the dQ kernel
    (what the forward takes, plus ``out``/``do`` of q's dtype and shape
    and f32 ``lse`` (B, H, Sq), all contiguous) or raises; a head dim off
    :data:`HEAD_DIMS` takes the padded route, padding q, k, v and dO
    once for both kernels."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                         q_seg, k_seg)
    _check("flash_attention_bwd", q, k, v)
    _build.expect("flash_attention_bwd", "out", out, q.dtype, 4)
    if out.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out "
                         f"{tuple(out.shape)}")
    seg = _segments("flash_attention_bwd", q, k, q_seg, k_seg)

    def both(q, k, v, out, lse, do, causal, q_seg, k_seg, scale=None):
        delta = _delta(out, do)
        dk, dv = _launch_dkdv(q, k, v, do, lse, delta, causal, seg, scale)
        dq = _launch_dq(q, k, v, do, lse, delta, causal, seg, scale)
        return dq, dk, dv

    if q.shape[-1] in HEAD_DIMS:
        return both(q, k, v, out, lse, do, causal, q_seg, k_seg)
    return padded_bwd(both, q, k, v, out, lse, do, causal, q_seg, k_seg)


class FlashAttentionFunction(torch.autograd.Function):
    """``out = flash_attention_fwd(q, k, v, causal, q_seg, k_seg)[0]``;
    saves q, k, v, the ids, out and lse, and its backward is
    :func:`flash_attention_bwd` (no gradient for the ids)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_seg=None, k_seg=None):
        out, lse = flash_attention_fwd(q, k, v, causal, q_seg, k_seg)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, q_seg, k_seg)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_seg, k_seg = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal, q_seg, k_seg)
        return dq, dk, dv, None, None, None
