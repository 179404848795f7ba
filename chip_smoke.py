#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line and ending in ``torch.cuda.synchronize()``
so that a fault surfaces in the phase that caused it:

1. env      torch, CUDA and nvcc versions; the card's name and power limit.
2. build    the kernel library from ``paddle_tpu_torch/csrc`` (nvcc, sm_90a).
3. kernel   each kernel against its plain PyTorch version on the card, in
            bf16: the serving kernels at the serving path's shapes (the
            decode megakernel at the engine's pool layout, plus a GQA
            case; the RMSNorm forward with weight, weight and bias, bias
            alone and neither, also at widths 100 and 4096), the training
            path's backward kernels and the forward kernels at the
            training shape, (4, 1536) tokens of the 438M model (the
            RMSNorm forward also timed with a bias), plus a GQA case for
            flash dK/dV and dQ. Max abs error within
            the stated tolerance, device time per call (a CUDA graph of
            many calls, so host launch cost is excluded), the plain
            version's and a PyTorch library call's time, and the bound
            (the larger of bytes over the memory rate and flops over the
            bf16 peak); for the megakernel also the time of the port's
            own unfused layer half. Then the bias-dropout-residual-
            LayerNorm kernel at BERT-base's (4096, 768) in bf16 (training
            at rate 0.1 and eval), in f32, at (1024, 1536) and at (37,
            1000) (mean and rstd also within 1e-5 relative; timed with its
            inputs out of L2, as its bound assumes), and the flash
            kernels at BERT-base's attention, (32, 128, 12, 64)
            non-causal, forward, dK/dV and dQ. Every flash row also
            gives its achieved TFLOP/s (the function's flops over its
            time) and the share of its bound that time reaches. Last the
            flash-edge cases: the flash kernels at the shapes of
            tests/test_torch_cuda.py's flash tests (bucket 32, ragged
            lengths, GQA groups 2-8, a causal offset, sq > sk non-causal,
            three tiles with the last ragged) and at 1025 and 383 rows,
            forward, dK/dV and dQ, within the same gate.
4. flash-segments  the segment-masked flash kernels (``kSegments``)
            against their plain versions on the same ids, within the
            kernel gate on rows with a visible key, rows with none exactly
            0 (lse -1e30): (4, 1536, 12, 128) causal with packed documents
            (lengths from np.random.RandomState(11).randint(32, 1537)) and
            with all-zero ids (the mask's cost alone), both beside the
            unmasked kernels; BERT-base (32, 128, 12, 64) non-causal with
            seq_lens; GQA q (2, 512, 12, 128) on 4 kv heads causal with
            seq_lens; cross attention sq 96 on sk 160 with a (q_ids,
            k_ids) pair missing a segment; every flash-edge shape with sq
            == sk with packed ids. The first four timed (wrapper, launch
            alone, range table), with the bound from the exact pair
            count, the dense-mask SDPA and ``varlen_attn``; packed must
            beat all-zero ids.
5. varlen   ``nn.functional.flash_attn_varlen_qkvpacked`` on qkv (6144, 3,
            12, 128) bf16, causal, documents from RandomState(11) packed
            to 6144: forward and backward, the three [seg] kernels'
            launches gated, out and gradient within the kernel gate of the
            masked plain version and 5e-2 of a per-document plain loop;
            the step's time beside the per-document loop of the unmasked
            kernels, the dense-mask SDPA and ``varlen_attn``; a
            torch.profiler split; each [seg] kernel timed at this shape.
6. model    the 438M LLaMA (random N(0, 0.02) weights from a seed) in bf16
            on the card against the same weights in f32 on the CPU through
            the plain versions: one bucket-128 prefill of 2 prompts and 4
            decode steps, logits within a stated relative L2 error; the
            same decode steps again through the fused decode layers
            (per-slot depths, ``megakernel_scope(True)``), within the same
            error of the CPU run.
7. serving  the continuous-batching engine on that model: 8 slots, max_len
            512, page 128, buckets (32, 128), 24 requests of 8-119 prompt
            tokens from np.random.RandomState(7), 64 new tokens each,
            greedy, segments of 32; in two arms on the same model and
            prompts, unfused (``decode_megakernel=0``) and fused (the
            default). Launch counts are zeroed just before each arm's run
            and read just after it: the unfused arm must launch the four
            forward kernels, the fused arm the megakernel 12 times per
            decode step and paged decode never. Both arms' tokens/s and
            how far their greedy streams agree are printed, not gated.
8. grad     a 2-layer model at the 438M widths, bf16 on the card against
            f32 on the CPU, batch 1 x seq 256 through
            LlamaPretrainingCriterion: the loss and every parameter's
            gradient within stated tolerances; the labels= loss equals the
            criterion's on the card.
9. train    the slice itself: the 438M model in bf16, AdamW(lr 1e-4,
            multi_precision) and TrainStep over the criterion, batch 4 x
            seq 1536 ids from np.random.RandomState(0), 1 warm-up step and
            5 timed steps on the same batch: step ms, tokens/s, MFU, peak
            memory, losses (finite, falling, the first near ln 32000), and
            the launches of the path's seven kernels in one step, zeroed
            just before it and read just after.
10. incubate FusedBiasDropoutResidualLayerNorm(768, dropout 0.1) in bf16 on
            (32, 128, 768): three forward and backward passes, which must
            launch the kernel three times (counts zeroed just before,
            read just after); y and the five gradients within 1e-2
            relative L2 of an f32 CPU run at the masks the layer drew.
11. bert-grad a 2-layer BERT at BERT-base's widths, bf16 on the card
            against f32 on the CPU, batch 4 x seq 128: MLM logits, the
            pretraining loss and every gradient within stated tolerances.
12. bert-train  bench.py section (c2): BERT-base in bf16, AdamW(lr 1e-4,
            multi_precision), TrainStep over BertPretrainingCriterion,
            ids, MLM and NSP labels of batch 32 x seq 128 from
            np.random.RandomState(0), 1 warm-up step and 5 timed steps:
            step ms, tokens/s, MFU, peak memory, losses (finite, falling,
            the first near ln 30522 + ln 2, each within 5e-2 relative of
            the same steps in f32 on the card through the plain versions
            only), and one step's launches: flash forward, dK/dV and dQ
            12 each; RMSNorm and RoPE none.
13. head-dims  the kernels at the widths off 64 and 128, each against
            its plain version within the kernel gate and timed beside its
            bound, the plain version and F.scaled_dot_product_attention:
            flash forward, dK/dV and dQ at Phi-3-mini's (4, 1536, 32, 96)
            and (8, 128, 32, 96) causal, at (2, 2048, 16, 256) causal on
            2 kv heads (Qwen3-Next's full-attention layers), at (4, 1536,
            32, 80) causal through the padded route (Phi-2's widths,
            printed beside the native 96) and at (2, 256, 4, 32); paged
            decode at q (8, 32, 96) and q (8, 16, 256) on 2 kv heads in
            e2's pool layout; RMSNorm at width 3072 and RoPE at head dim
            96 (with k=None too). Then the flash-edge cases again at head
            dims 96 and 256.
14. phi3-serve  a LLaMA at Phi-3-mini's widths (CFG_PHI3: 32 layers,
            hidden 3072, 32 heads of 96) behind the engine on e2's
            traffic, the default decode_megakernel=1 (the megakernel
            declines head dim 96): all 24 requests finished, tokens/s,
            launches per decode step, the four unfused kernels launched;
            gated first on a 2-layer model's logits (prefill and 4 decode
            steps) against f32 on the CPU within MODEL_REL_L2.
15. phi3-train  the same widths at 4 layers (a depth cut): the train
            phase's step, batch 4 x seq 1536, 1 warm-up and 5 timed
            steps (step ms, MFU, peak memory, losses finite and
            falling); then phi3-grad, the grad phase at those widths.
16. f32-kernel  the f32 instantiations of the four serving kernels (the
            JAX model's default dtype) against their f32 plain versions
            within 1e-4 + 1e-4 |plain| (lse too), TF32 off, each timed
            beside its bound (bytes, or flops at the f32 FMA rate of 67
            TFLOP/s), the plain version and a library call: RMSNorm at
            (8, 1536) and (1024, 1536), RoPE on (8, 128, 12, 128) both
            ways and at decode positions, the flash forward at e2's
            prefill (8, 128, 12, 128) causal, at (4, 1536, 12, 128), at
            Phi-3's (8, 128, 32, 96) and at (2, 2048, 16, 256) on 2 kv
            heads (F.scaled_dot_product_attention in f32 beside it), with
            segments (rows with no key exactly 0, lse -1e30), paged decode
            in e2's pool.
17. f32-serve  the 438M in f32 behind the engine on e2's traffic (the
            default decode_megakernel=1; the megakernel takes bf16 only,
            so decode runs unfused, as in JAX), three runs, each beside a
            run of the bf16 unfused arm on the same weights rounded:
            gated on the f32 logits (prefill and 4 decode steps) within
            1e-3 relative L2 of the CPU, all 24 requests finished, the
            four [f32] kernels launched and no bf16 one; tokens/s,
            launches and device idle per decode step, peak memory, and
            how far the f32 and bf16 greedy streams agree.
18. f32-train-kernel  the f32 training path's backward kernels against
            their f32 plain versions within 1e-4 + 1e-4 |plain|, TF32
            off, each timed beside its bound (bytes, or flops at the f32
            FMA rate), the plain version and a library call
            (``autograd.grad`` through F.rms_norm or
            F.scaled_dot_product_attention in f32): the RMSNorm backward
            at (6144, 1536) and (1024, 1536), the RoPE adjoint on (4,
            1536, 12, 128), dK/dV and dQ at the training shape, GQA q (2,
            512, 12, 128) on 4 kv heads, BERT's (32, 128, 12, 64)
            non-causal, Phi-3's (4, 1536, 32, 96), (2, 2048, 16, 256) on
            2 kv heads and (4, 1536, 32, 80) through the padded route,
            and the [seg] forms at the varlen shape (1, 6144, 12, 128)
            causal with its 7 packed documents.
19. f32-grad  the grad phase in f32: a 2-layer model at the 438M widths
            on (1, 256) ids, f32 on the card against f32 on the CPU: the
            loss within 1e-5 relative, every gradient within 1e-4
            relative L2, no bf16 launch.
20. f32-train  the train phase on the 438M in f32 (the JAX model's
            default dtype), full width and depth, batch 4 x seq 1536:
            step ms, tokens/s, MFU against the bf16 peak and the f32 FMA
            peak, peak memory, losses (finite, falling, the first within
            1.0 of ln 32000), and one step's launches: the seven [f32]
            training kernels at 25/25/12/12/12/12/12 and nothing else;
            then the three f32 phases' seconds.
21. kernels one JSON line listing every ported kernel, with the unfused
            serving arm's launches for the serving kernels, the fused
            arm's for the megakernel, the LLaMA training step's for the
            backward kernels, the incubate phase's for the bdrln kernel,
            the varlen phase's for the three [seg] rows, the Phi-3
            paths' for the eight [d=96] / [h=3072] rows, f32-serve's
            for the four [f32] serving rows and f32-train's for the four
            [f32] backward rows; before it, the whole script's time.

Then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero, and so
does a machine without a GPU.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published dense peaks (NVIDIA data sheets, SXM parts at 700 W):
# (memory bytes/s, bf16 tensor-core flop/s, f32 flop/s outside the
# tensor cores)
PEAKS = {"H100": (3.35e12, 989e12, 67e12), "H200": (4.8e12, 989e12, 67e12)}
# kernel results within atol + rtol * |plain|: rtol is one bf16 ulp
# (2^-7 relative), as kernel and plain version round their f32 results to
# bf16 after summing in different orders
RTOL, ATOL = 2.0 ** -7, 1e-3
# 438M logits, bf16 on the card vs f32 on the CPU: bf16 storage rounds at
# ~2^-9 relative per op, over 12 layers of ~10 rounded ops and a
# 32000-wide head; a wrong kernel gives errors of order 1
MODEL_REL_L2 = 5e-2
# the grad phase, bf16 card vs f32 CPU: the loss (a mean of 255 f32
# log-softmaxes of bf16 logits) to 1e-2 relative; each gradient to 5e-2
# relative L2, the model phase's bound for the same rounding carried
# back through two layers; the labels= loss (f32 block logits of the
# same bf16 operands) against the criterion's (bf16 logits) to 2e-3
GRAD_LOSS_REL, GRAD_REL_L2, LABELS_REL = 1e-2, 5e-2, 2e-3
# the bdrln kernel's per-row mean and rstd: f32 row sums of 768-1536
# values in other orders, ~1e-7 relative apart; a wrong row is far off
BDRLN_STAT_REL = 1e-5
# the incubate phase, bf16 card vs f32 CPU: y and the gradients carry
# bf16 rounding (2^-9 relative) of the inputs, y and dy
INCUBATE_REL_L2 = 1e-2
# bert-train: each step's loss against an f32 run of the same steps
# through the plain versions. The bf16 weights are the f32 masters rounded
# to a grid (~8e-5 at 0.02) as coarse as one step's move (~lr = 1e-4), so
# the two trajectories part by more than one forward's rounding (1.8e-5
# relative); a wrong kernel or update parts them by order 1
BERT_TRAJ_REL = 5e-2
# the varlen phase: out and the qkv gradient, bf16 kernels on the card
# against a per-document loop of the plain versions in f32 (bf16 inputs):
# the model phase's bound for bf16 rounding, here of one attention layer
VARLEN_REL_L2 = 5e-2

CFG_438M = dict(vocab_size=32000, hidden_size=1536, intermediate_size=4096,
                num_hidden_layers=12, num_attention_heads=12,
                max_position_embeddings=1536)


def emit(phase, **kv):
    print(json.dumps({"phase": phase, **kv}), flush=True)


class PhaseFailed(Exception):
    pass


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def peaks_for(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise PhaseFailed(f"no peak figures for {name!r}")


def graph_ms(fn, calls=20, replays=10, stream=None):
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events (warm L2). A backward
    is captured on ``stream``, the stream its forward ran on, as
    ``torch.cuda.make_graphed_callables`` captures one."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        for _ in range(calls):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def cold_ms(fn, args, replays=5):
    """``graph_ms`` with the inputs out of L2: each captured call of
    ``fn`` takes its own copy of ``args`` (the tensors cloned to other
    addresses) and keeps its own output, the copies together at least
    four times the card's L2, so that every call reads its inputs from
    and writes its output to HBM, as the bound assumes."""
    set_bytes = sum(a.numel() * a.element_size() for a in args
                    if isinstance(a, torch.Tensor))
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    n = max(2, min(1024, -(-4 * l2 // set_bytes)))
    sets = [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]
    outs, turn = [], itertools.count()
    ms = graph_ms(lambda: outs.append(fn(*sets[next(turn) % n])), calls=n,
                  replays=replays)
    del outs, sets
    return ms


def eager_ms(fn, calls=50):
    """Wall time per eager call, host launch cost included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def compare(name, got, want, atol=ATOL, rtol=RTOL):
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise PhaseFailed(f"{name}: kernel output not finite")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise PhaseFailed(f"{name}: {int(bad.sum())} elements beyond "
                          f"atol {atol} + rtol {rtol}; max abs err "
                          f"{err.max().item():.3g}")
    return err.max().item()


def bound_ms(nbytes, flops, peaks, flop_rate=None):
    """The least time for the work: bytes over the memory rate against
    operations over ``flop_rate`` (default the bf16 tensor-core peak)."""
    t_bytes, t_ops = nbytes / peaks[0], flops / (flop_rate or peaks[1])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def rates(flops, ms, bms):
    """A flash row's achieved rate (the function's flops over its time,
    TFLOP/s) and the share of its bound that the time reaches."""
    return dict(tflops=flops / ms * 1e-9, bound_share=bms / ms)


def rms_norm_variants(rn, x, w, bias, tag):
    """The RMSNorm forward kernel against its plain version with the
    weight alone, with weight and bias, with the bias alone and with
    neither; y within the kernel gate, r within 1e-5 relative. Returns the
    largest error of y."""
    err = 0.0
    for wt, bt in ((w, None), (w, bias), (None, bias), (None, None)):
        y, r = rn.rms_norm_rows(x, wt, bt, epsilon=1e-6)
        py, pr = rn.rms_norm_plain(x, wt, bt, epsilon=1e-6)
        err = max(err, compare(tag, y, py))
        if (r - pr).abs().max().item() > 1e-5 * pr.abs().max().item():
            raise PhaseFailed(f"{tag}: per-row r disagrees")
    return err


def kernel_phase(peaks):
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import rms_norm as rn
    from paddle_tpu_torch.models.llama import _rope_tables

    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    hidden, heads, hd = 1536, 12, 128
    results = {}

    # RMSNorm at the decode step's (8, 1536) and a prefill's (1024, 1536),
    # then the widths off the vector path's 1536 (gate only)
    w = (1.0 + 0.1 * randn(hidden, dtype=torch.float32)).to(bf16)
    bias = 0.1 * randn(hidden)
    for n in (8, 1024):
        x = randn(n, hidden)
        err = rms_norm_variants(rn, x, w, bias, f"rms_norm({n})")
        nb = 2 * n * hidden * 2 + hidden * 2 + n * 4
        bms, by = bound_ms(nb, 4 * n * hidden, peaks)
        rec = dict(
            shape=[n, hidden], max_abs_err=err,
            ms=graph_ms(lambda: rn.rms_norm_rows(x, w, epsilon=1e-6)),
            plain_ms=graph_ms(lambda: rn.rms_norm_plain(x, w, epsilon=1e-6)),
            library_ms=graph_ms(lambda: torch.nn.functional.rms_norm(
                x, (hidden,), w, 1e-6)),
            eager_ms=eager_ms(lambda: rn.rms_norm_rows(x, w, epsilon=1e-6)),
            bound_ms=bms, bound_by=by,
            bias_ms=graph_ms(lambda: rn.rms_norm_rows(x, w, bias,
                                                      epsilon=1e-6)))
        emit("kernel", name="rms_norm", **rec)
        if n == 8:  # the decode step: the main path's most frequent call
            results["rms_norm"] = rec
    for n, d in ((37, 100), (5, 4096)):
        err = rms_norm_variants(rn, randn(n, d), randn(d), randn(d),
                                f"rms_norm({n}, {d})")
        emit("kernel", name="rms_norm", case="width", shape=[n, d],
             max_abs_err=err)
    torch.cuda.synchronize()

    # RoPE on the prefill's q/k (g = 8, bucket 128) at arange positions,
    # and on a decode step's at per-slot positions
    cos, sin = _rope_tables(hd, CFG_438M["max_position_embeddings"], 10000.0,
                            dev)
    g_, s_ = 8, 128
    q = randn(g_, s_, heads, hd)
    k = randn(g_, s_, heads, hd)
    pos = torch.arange(s_, device=dev, dtype=torch.int32).expand(
        g_, s_).contiguous()
    qo, ko = fo.fused_rope_at(q, k, cos, sin, pos)
    pq, pk = fo.fused_rope_plain(q, k, cos, sin, pos)
    err = max(compare("rope", qo, pq), compare("rope", ko, pk))
    dpos = torch.randint(0, 183, (8, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    dq, dk = randn(8, 1, heads, hd), randn(8, 1, heads, hd)
    for got, want in zip(fo.fused_rope_at(dq, dk, cos, sin, dpos),
                         fo.fused_rope_plain(dq, dk, cos, sin, dpos)):
        err = max(err, compare("rope(decode)", got, want))
    pairs = g_ * s_ * 2 * heads * hd // 2
    nb = 2 * 2 * q.numel() * 2 + pos.numel() * 4 + 2 * s_ * hd * 4
    bms, by = bound_ms(nb, 6 * pairs, peaks)
    results["fused_rope"] = rec = dict(
        shape=list(q.shape), max_abs_err=err,
        ms=graph_ms(lambda: fo.fused_rope_at(q, k, cos, sin, pos)),
        plain_ms=graph_ms(lambda: fo.fused_rope_plain(q, k, cos, sin, pos)),
        library_ms=None,
        eager_ms=eager_ms(lambda: fo.fused_rope_at(q, k, cos, sin, pos)),
        bound_ms=bms, bound_by=by)
    emit("kernel", name="fused_rope", **rec)
    torch.cuda.synchronize()

    # flash forward: the bucket-128 prefill of a full admission group
    v = randn(g_, s_, heads, hd)
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal=True)
    err = compare("flash_attention", out, pout)
    if (lse - plse).abs().max().item() > 1e-3:
        raise PhaseFailed("flash_attention: lse disagrees")
    nb = 4 * q.numel() * 2 + lse.numel() * 4
    flops = 4 * hd * g_ * heads * s_ * (s_ + 1) // 2
    bms, by = bound_ms(nb, flops, peaks)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    results["flash_attention"] = rec = dict(
        shape=list(q.shape), max_abs_err=err,
        ms=graph_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True)),
        plain_ms=graph_ms(lambda: fa.flash_attention_fwd_plain(q, k, v,
                                                               True)),
        library_ms=graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True)),
        eager_ms=eager_ms(lambda: fa.flash_attention_fwd(q, k, v,
                                                         causal=True)),
        bound_ms=bms, bound_by=by)
    rec.update(rates(flops, rec["ms"], bms))
    emit("kernel", name="flash_attention", **rec)
    torch.cuda.synchronize()

    # paged decode: 8 slots of the serving engine's pool (max_len 512,
    # page 128), scattered tables with dump-page tails, serving-like
    # lengths
    results["paged_attention"] = rec = paged_row(
        da, peaks, e2_pool(randn, heads, heads, hd))
    emit("kernel", name="paged_attention", **rec)
    torch.cuda.synchronize()
    return results


# pre-append depths of the megakernel cases: a fresh page (1), page
# boundaries (127, 128, 255, 256) and near-full (510 of 512)
MK_LENGTHS = [1, 17, 127, 128, 200, 255, 256, 510]


def megakernel_layer(kvh, gen):
    """A decoder layer at the 438M widths with ``kvh`` kv heads, drawn by
    the model's initialiser (weights N(0, 0.02), norm scales 1)."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer

    cfg = LlamaConfig(**{**CFG_438M, "num_key_value_heads": kvh})
    return LlamaDecoderLayer(cfg, generator=gen, device="cuda",
                             dtype=torch.bfloat16)


def megakernel_case(peaks, kvh, gen, randn):
    """The decode megakernel against its plain version at the e2 decode
    shape: 8 rows over the engine's pool layout (max_len 512, page 128:
    32 real pages and the dump page; tables of 4 visible columns and a
    trailing scratch column, tails on the dump page), depths MK_LENGTHS.
    x is layer 0's input, an embedding row (N(0, 0.02)); weights
    N(0, 0.02); norm scales random powers of two (0.5, 1, 2), exact in
    bf16, so that a scale adds no rounding of its own.

    h_mid and both pools (the dump page left out) are held against the
    plain version; y2 against the plain norm of the kernel's own h_mid.
    h_mid = bf16(x + bf16(o)) already admits a one-ulp difference (f32
    sums in other orders round o either way), and y2 renormalises h_mid,
    so held against the plain y2 that one ulp would count twice; the
    plain y2's difference is reported. Times the kernel, its plain
    version and the port's own unfused layer half (rms_norm kernel,
    GEMMs, RoPE kernel, cache write, paged decode kernel, o_proj,
    residual, rms_norm kernel) on the same inputs."""
    from paddle_tpu_torch.models.generation import _make_paged_cache
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk

    layer = megakernel_layer(kvh, gen)
    attn = layer.self_attn
    cfg = attn.config
    with torch.no_grad():
        for ln in (layer.input_layernorm, layer.post_attention_layernorm):
            ln.weight.copy_(2.0 ** torch.randint(
                -1, 2, ln.weight.shape, generator=gen, device="cuda"))
    b, page, per_seq = 8, 128, 4
    hidden, heads, hd = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    n_pages = b * per_seq + 1
    dump = n_pages - 1
    perm = np.random.RandomState(0).permutation(b * per_seq)
    tables = np.full((b, per_seq + 1), dump, np.int32)
    used = 0
    for i, n in enumerate(MK_LENGTHS):
        np_ = -(-(n + 1) // page)  # the pages after the append
        tables[i, :np_] = perm[used:used + np_]
        used += np_
    tab = torch.tensor(tables, device="cuda")
    lens = torch.tensor(MK_LENGTHS, dtype=torch.int32, device="cuda")
    x = randn(b, 1, hidden, std=0.02)
    kp, vp = randn(n_pages, page, kvh, hd), randn(n_pages, page, kvh, hd)
    eps = cfg.rms_norm_eps
    args = dict(ln1_weight=layer.input_layernorm.weight, ln1_eps=eps,
                wq=attn.q_proj.weight, wk=attn.k_proj.weight,
                wv=attn.v_proj.weight, wo=attn.o_proj.weight,
                rope_cos=attn.rope_cos, rope_sin=attn.rope_sin,
                ln2_weight=layer.post_attention_layernorm.weight,
                ln2_eps=eps, tables=tab, lengths=lens, heads=heads,
                attn_pages=per_seq, dump_page=dump)
    kk, kv_ = kp.clone(), vp.clone()
    pk, pv = kp.clone(), vp.clone()
    with torch.no_grad():
        got = mk.fused_decode_layer(x, k_pages=kk, v_pages=kv_, **args)
        want = mk.fused_decode_layer_plain(x, k_pages=pk, v_pages=pv, **args)
        y2_own = mk.decode_norm_plain(got[0], args["ln2_weight"], eps)
    tag = f"fused_decode_layer(kvh={kvh})"
    err = max(compare(f"{tag} h_mid", got[0], want[0]),
              compare(f"{tag} y2", got[1], y2_own),
              compare(f"{tag} k_pages", kk[:dump], pk[:dump]),
              compare(f"{tag} v_pages", kv_[:dump], pv[:dump]))
    torch.cuda.synchronize()

    def unfused():
        cache = _make_paged_cache(kp, vp, tab, page, lens, per_seq, dump)
        h = x + attn(layer.input_layernorm(x), cache=cache)
        return h, layer.post_attention_layernorm(h)

    with torch.no_grad():
        uh, uy = unfused()
    w_bytes = sum(w.numel() * 2 for w in (attn.q_proj.weight,
                                          attn.k_proj.weight,
                                          attn.v_proj.weight,
                                          attn.o_proj.weight))
    toks = sum(min(n, per_seq * page) for n in MK_LENGTHS)  # pool rows read
    nb = (w_bytes + 2 * hidden * 2 + 3 * b * hidden * 2
          + 2 * (toks + b) * kvh * hd * 2 + 2 * b * hd * 4
          + tab.numel() * 4 + b * 4)
    flops = (2 * b * hidden * (heads + 2 * kvh) * hd
             + 2 * b * heads * hd * hidden
             + 4 * (toks + b) * heads * hd)
    bms, by = bound_ms(nb, flops, peaks)
    with torch.no_grad():
        rec = dict(
            case=f"e2 decode, kv heads {kvh}", shape=[b, hidden],
            lengths=MK_LENGTHS, max_abs_err=err,
            y2_vs_plain_max_abs=float((got[1].float()
                                       - want[1].float()).abs().max()),
            h_mid_elements_differing=int((got[0] != want[0]).sum()),
            unfused_vs_fused_h_mid_max_abs=float(
                (uh.float() - got[0].float()).abs().max()),
            ms=graph_ms(lambda: mk.fused_decode_layer(
                x, k_pages=kk, v_pages=kv_, **args)),
            plain_ms=graph_ms(lambda: mk.fused_decode_layer_plain(
                x, k_pages=pk, v_pages=pv, **args), calls=5),
            library_ms=None, unfused_ms=graph_ms(unfused),
            eager_ms=eager_ms(lambda: mk.fused_decode_layer(
                x, k_pages=kk, v_pages=kv_, **args)),
            eager_unfused_ms=eager_ms(unfused),
            bound_ms=bms, bound_by=by, bound_bytes=nb, bound_flops=flops)
    emit("kernel", name="fused_decode_layer", **rec)
    torch.cuda.synchronize()
    return rec


def megakernel_phase(peaks):
    """The decode megakernel at the 438M serving decode (12 kv heads) and
    on a GQA case (4 kv heads, 3 query heads each), which the 438M model
    does not exercise."""
    from paddle_tpu_torch import seed

    gen = seed(4, "cuda")

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * std).to(torch.bfloat16)

    rec = megakernel_case(peaks, 12, gen, randn)
    megakernel_case(peaks, 4, gen, randn)
    return {"fused_decode_layer": rec}


def card_and_cpu(cfg, seeds, dtype=torch.bfloat16):
    """The model of ``cfg`` in ``dtype`` on the card (random N(0, 0.02)
    weights from ``seed(seeds[0])``) and the same weights in f32 on the
    CPU."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaForCausalLM

    card = LlamaForCausalLM(cfg, device="cuda", dtype=dtype,
                            generator=seed(seeds[0], "cuda"))
    cpu = LlamaForCausalLM(cfg, device="cpu", dtype=torch.float32,
                           generator=seed(seeds[1], "cpu"))
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in card.state_dict().items()})
    return card, cpu


def prefill_decode(model, prompts, steps, fused=False):
    """Last-position logits (f32, on the CPU) of a bucket prefill of
    ``prompts`` (B, S) into paged caches (page 128), then of each decode
    step's tokens in ``steps`` (n, B); ``fused`` gives the caches per-slot
    (B,) depths and decodes under megakernel_scope(True)."""
    from paddle_tpu_torch.models.llama import PagedKVCache
    from paddle_tpu_torch.ops.cuda.decode_megakernel import megakernel_scope

    cfg, b = model.config, prompts.shape[0]
    caches = [PagedKVCache(b, 256, cfg.num_key_value_heads, cfg.head_dim,
                           page_size=128, device=model.device,
                           dtype=model.dtype)
              for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        outs = [model(torch.tensor(prompts, device=model.device),
                      caches=caches)[:, -1].float().cpu()]
        if fused:
            for c in caches:
                c.length = torch.full((b,), c.length, dtype=torch.int32,
                                      device=model.device)
        with megakernel_scope(fused):
            for tok in steps:
                outs.append(model(torch.tensor(tok[:, None],
                                               device=model.device),
                                  caches=caches)[:, -1].float().cpu())
    return outs


def model_phase():
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.ops.cuda import launch_counts

    cfg = LlamaConfig(**CFG_438M)
    card, cpu = card_and_cpu(cfg, (0, 1))
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (2, 128))
    steps = rng.randint(0, cfg.vocab_size, (4, 2))

    def run(model, fused=False):
        return prefill_decode(model, prompts, steps, fused)

    t0 = time.monotonic()
    got, want = run(card), run(cpu)
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(got, want)]
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    torch.cuda.synchronize()
    launch_counts.clear()
    fused = run(card, fused=True)[1:]
    torch.cuda.synchronize()
    fused_launches = launch_counts["fused_decode_layer"]
    fused_rel = [float((a - b).norm() / b.norm())
                 for a, b in zip(fused, want[1:])]
    fused_finite = all(bool(torch.isfinite(a).all()) for a in fused)
    emit("model", rel_l2=rel, tolerance=MODEL_REL_L2, argmax_agree=agree,
         fused_decode_rel_l2=fused_rel,
         fused_decode_argmax_agree=[
             float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(fused, want[1:])],
         fused_decode_launches=fused_launches,
         seconds=time.monotonic() - t0)
    if not finite or max(rel) > MODEL_REL_L2:
        raise PhaseFailed(f"438M logits: finite={finite}, rel L2 {rel}")
    want_launches = len(steps) * cfg.num_hidden_layers
    if (not fused_finite or max(fused_rel) > MODEL_REL_L2
            or fused_launches != want_launches):
        raise PhaseFailed(f"438M fused decode logits: finite={fused_finite},"
                          f" rel L2 {fused_rel}, {fused_launches} launches "
                          f"of fused_decode_layer (want {want_launches})")
    del cpu
    return card


SERVE_NEW_TOKENS, SERVE_SEGMENT = 64, 32


def serving_workload(model, decode_megakernel=1):
    """The e2 serving run on ``model``: the engine (8 slots, max_len 512,
    page 128, buckets (32, 128); ``decode_megakernel`` 1 takes the fused
    decode layers, 0 the unfused ones), warmed on two requests, and the 24
    prompts of 8-119 tokens from np.random.RandomState(7). Returns
    (engine, prompts); run them with ``engine.run(prompts,
    max_new_tokens=SERVE_NEW_TOKENS, segment=SERVE_SEGMENT)``."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    vocab = model.config.vocab_size
    eng = ContinuousBatchingEngine(model, max_slots=8, max_len=512,
                                   page_size=128, prompt_buckets=(32, 128),
                                   decode_megakernel=decode_megakernel)
    rng = np.random.RandomState(7)
    warm = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in (12, 60)]
    eng.run(warm, max_new_tokens=2, segment=SERVE_SEGMENT)
    lens = rng.randint(8, 120, 24)
    return eng, [rng.randint(0, vocab, (int(n),)).astype(np.int32)
                 for n in lens]


SERVE_UNFUSED_KERNELS = ("rms_norm", "fused_rope", "flash_attention",
                         "paged_attention")


def serving_arm(model, fused, name, smi):
    """One arm of the e2 run; launch counts zeroed just before the run and
    read just after it. Returns (prompts, outputs, stats, counts)."""
    from paddle_tpu_torch.ops.cuda import launch_counts

    arm = "fused" if fused else "unfused"
    vocab = model.config.vocab_size
    eng, prompts = serving_workload(model, decode_megakernel=int(fused))
    torch.cuda.synchronize()
    launch_counts.clear()
    outs, stats = eng.run(prompts, max_new_tokens=SERVE_NEW_TOKENS,
                          segment=SERVE_SEGMENT)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    ok = all(len(o) == SERVE_NEW_TOKENS and o.min() >= 0 and o.max() < vocab
             for o in outs)
    finite = all(bool(torch.isfinite(t).all()) for t in eng._ks + eng._vs)
    steps = stats["segments"] * SERVE_SEGMENT
    emit("serving", arm=arm, megakernel=stats["megakernel"],
         requests=len(outs), new_tokens=SERVE_NEW_TOKENS,
         tokens_per_sec=stats["tokens_per_sec"], wall_s=stats["wall_s"],
         useful_tokens=stats["useful_tokens"], segments=stats["segments"],
         decode_steps=steps, mean_occupancy=stats["mean_occupancy"],
         launches=counts, kv_finite=finite, card=name, nvidia_smi=smi)
    if (not ok or not finite or stats["megakernel"] != fused
            or stats["useful_tokens"] != len(prompts) * SERVE_NEW_TOKENS):
        raise PhaseFailed(f"serving ({arm}): outputs ok={ok}, kv finite="
                          f"{finite}, megakernel {stats['megakernel']}, "
                          f"tokens {stats['useful_tokens']}")
    layers = model.config.num_hidden_layers
    if fused:
        if (counts.get("fused_decode_layer", 0) != layers * steps
                or counts.get("paged_attention", 0)):
            raise PhaseFailed(f"serving (fused): launches {counts}, want "
                              f"fused_decode_layer {layers} x {steps} and no "
                              f"paged_attention")
    else:
        missing = [k for k in SERVE_UNFUSED_KERNELS if counts.get(k, 0) <= 0]
        if missing or counts.get("fused_decode_layer", 0):
            raise PhaseFailed(f"serving (unfused): launches {counts}")
    return prompts, outs, stats, counts


def serving_phase(model, name, smi):
    """The e2 run in two arms on the same model and prompts: unfused, then
    fused. Where two greedy streams part, the top-2 logit gap of a full
    forward over the prompt and the common prefix says how near a tie the
    choice was (printed beside the logits' scale, not gated). Returns each
    arm's launch counts."""
    prompts, u_outs, u_stats, u_counts = serving_arm(model, False, name, smi)
    _, f_outs, f_stats, f_counts = serving_arm(model, True, name, smi)
    parts = [next((i for i, (a, b) in enumerate(zip(u, f)) if a != b), None)
             for u, f in zip(u_outs, f_outs)]
    gaps, scales = [], []
    with torch.no_grad():
        for prompt, u, p in zip(prompts, u_outs, parts):
            if p is None:
                continue
            seq = np.concatenate([prompt, u[:p]]).astype(np.int64)
            logits = model(torch.tensor(seq[None], device="cuda"))[0, -1]
            top2 = torch.topk(logits.float(), 2).values
            gaps.append(float(top2[0] - top2[1]))
            scales.append(float(logits.float().std()))
    emit("serving_arms", unfused_tokens_per_sec=u_stats["tokens_per_sec"],
         fused_tokens_per_sec=f_stats["tokens_per_sec"],
         streams_agree=sum(p is None for p in parts) / len(parts),
         first_index_where_streams_part=parts,
         top2_gap_where_streams_part=gaps, logit_std_there=scales)
    return {"serving": u_counts, "serving_fused": f_counts}


FLASH_NAMES = ("flash_attention", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")


def e2_pool(randn, heads, kvh, hd, seed=0):
    """Paged decode inputs in the serving engine's pool layout (8 slots,
    max_len 512, page 128: 4 columns + 1 scratch column, 32 real pages +
    the dump page), scattered tables with dump-page tails, lengths of
    np.random.RandomState(seed).randint(9, 184). Returns (q, k_pages,
    v_pages, tables, lengths, lengths as numpy, pages per sequence)."""
    b, page, per_seq = 8, 128, 4
    n_pages = b * per_seq + 1
    dump = n_pages - 1
    rng = np.random.RandomState(seed)
    lens = rng.randint(9, 184, b).astype(np.int32)
    perm = rng.permutation(b * per_seq)
    tables = np.full((b, per_seq + 1), dump, np.int32)
    used = 0
    for i, n in enumerate(lens):
        np_ = -(-int(n) // page)
        tables[i, :np_] = perm[used:used + np_]
        used += np_
    kp, vp = randn(n_pages, page, kvh, hd), randn(n_pages, page, kvh, hd)
    q = randn(b, heads, hd)
    return (q, kp, vp, torch.tensor(tables, device="cuda"),
            torch.tensor(lens, device="cuda"), lens, per_seq)


def paged_row(da, peaks, pool, f32=False):
    """The paged decode kernel against its plain version on ``pool``
    (``e2_pool``'s tuple), timed; the bound counts the K/V rows the
    lengths reach. ``f32``: the pool is f32, gated at the f32 gate, the
    flops bound at the f32 FMA rate."""
    q, kp, vp, tab, ln, lens, per_seq = pool
    b, heads, hd = q.shape
    kvh, page = kp.shape[2], kp.shape[1]
    args = (q, kp, vp, tab, ln)
    got = da.paged_attention(*args, pages_per_seq=per_seq)
    want = da.paged_attention_plain(*args, pages_per_seq=per_seq)
    err = (f32_compare if f32 else compare)(f"paged_attention(d={hd})", got,
                                            want)
    toks = int(np.minimum(lens, per_seq * page).sum())
    size = q.element_size()
    nb = (2 * q.numel() * size + 2 * toks * kvh * hd * size
          + tab.numel() * 4 + b * 4)
    bms, by = bound_ms(nb, 4 * toks * heads * hd, peaks,
                       flop_rate=peaks[2] if f32 else None)
    return dict(
        shape=[b, heads, hd], kv_heads=kvh, lengths=lens.tolist(),
        max_abs_err=err,
        ms=graph_ms(lambda: da.paged_attention(*args,
                                               pages_per_seq=per_seq)),
        plain_ms=graph_ms(lambda: da.paged_attention_plain(
            *args, pages_per_seq=per_seq)),
        library_ms=None,
        eager_ms=eager_ms(lambda: da.paged_attention(
            *args, pages_per_seq=per_seq)),
        bound_ms=bms, bound_by=by)


def flash_rows(peaks, gen, case, b, s, h, kvh, d, causal):
    """The three flash kernels at one (b, s, h, kvh, d) shape against
    their plain versions on the same inputs (out and lse, then dK, dV and
    dQ from the kernel's out and lse), within the kernel gate; each timed
    (a CUDA graph of 3 calls) beside its bound, the plain version and
    ``F.scaled_dot_product_attention`` (forward; forward + backward for
    the backward pair). A head dim off the built widths runs the padded
    route, and its time includes the pads and slices. Returns {kernel
    name: row}."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    tag = f"({case}: {b}, {s}, {h}, {kvh}, {d})"
    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal)
    errs = {"flash_attention": compare(f"flash_attention{tag}", out, pout)}
    lse_err = (lse - plse).abs().max().item()
    if lse_err > 1e-3:
        raise PhaseFailed(f"flash_attention{tag}: lse off by {lse_err:.3g}")
    del pout, plse
    delta = fa._delta(out, do)
    got_dk, got_dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                 causal)
    got_dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
    want_dq, want_dk, want_dv = fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal)
    errs["flash_attention_bwd_dkdv"] = max(
        compare(f"dk{tag}", got_dk, want_dk),
        compare(f"dv{tag}", got_dv, want_dv))
    errs["flash_attention_bwd_dq"] = compare(f"dq{tag}", got_dq, want_dq)
    del want_dq, want_dk, want_dv
    torch.cuda.empty_cache()
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    io = (q.numel() + 2 * k.numel() + do.numel()) * 2 + 2 * lse.numel() * 4
    gqa = kvh != h
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_fwd = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=gqa), calls=3, replays=3)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
        ol = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, is_causal=causal, enable_gqa=gqa)
    dol = do.transpose(1, 2)
    lib_bwd = graph_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), dol, retain_graph=True), calls=3, replays=3,
        stream=side)
    plain_bwd = graph_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal), calls=2, replays=2)
    kernels = {
        "flash_attention": (
            lambda: fa.flash_attention_fwd(q, k, v, causal),
            4 * d * pairs, 4 * q.numel() * 2 + lse.numel() * 4,
            graph_ms(lambda: fa.flash_attention_fwd_plain(q, k, v, causal),
                     calls=2, replays=2), lib_fwd),
        "flash_attention_bwd_dkdv": (
            lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                causal),
            8 * d * pairs, io + 2 * k.numel() * 2, plain_bwd, lib_bwd),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              causal),
            6 * d * pairs, io + q.numel() * 2, plain_bwd, lib_bwd)}
    rows = {}
    route = ("native" if d in fa.HEAD_DIMS
             else f"padded to {fa.native_head_dim(d)}")
    for kname, (fn, flops, nb, plain, lib) in kernels.items():
        bms, by = bound_ms(nb, flops, peaks)
        rec = dict(case=case, shape=[b, s, h, d], kv_heads=kvh,
                   causal=causal, route=route, max_abs_err=errs[kname],
                   ms=graph_ms(fn, calls=3, replays=3), plain_ms=plain,
                   library_ms=lib, bound_ms=bms, bound_by=by)
        if kname == "flash_attention":
            rec["lse_err"] = lse_err
        rec.update(rates(flops, rec["ms"], bms))
        emit("kernel", name=kname, **rec)
        rows[kname] = rec
    torch.cuda.synchronize()
    return rows


def train_kernel_phase(peaks):
    """The training path's kernels at the training shape: (4, 1536) tokens
    of the 438M model, 12 heads of 128, causal."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    dev, bf16 = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b, s, heads, hd, hidden = 4, 1536, 12, 128, 1536
    n = b * s
    results = {}

    # RMSNorm forward, then its backward, over the (6144, 1536) rows of
    # one norm
    w = (1.0 + 0.1 * randn(hidden, dtype=torch.float32)).to(bf16)
    bias = 0.1 * randn(hidden)
    x, g = randn(n, hidden), randn(n, hidden)
    err = rms_norm_variants(rn, x, w, bias, "rms_norm(train)")
    _, r = rn.rms_norm_rows(x, w, epsilon=1e-6)
    bms, by = bound_ms(2 * n * hidden * 2 + hidden * 2 + n * 4,
                       4 * n * hidden, peaks)
    emit("kernel", name="rms_norm", case="train_shape", shape=[n, hidden],
         max_abs_err=err,
         ms=graph_ms(lambda: rn.rms_norm_rows(x, w, epsilon=1e-6), calls=10),
         plain_ms=graph_ms(lambda: rn.rms_norm_plain(x, w, epsilon=1e-6),
                           calls=10),
         library_ms=graph_ms(lambda: torch.nn.functional.rms_norm(
             x, (hidden,), w, 1e-6), calls=10),
         bound_ms=bms, bound_by=by,
         # x (18.9 MB) fits the 50 MB L2, so the warm times above can read
         # below the HBM bound; these have the inputs out of L2
         cold_ms=cold_ms(lambda xx: rn.rms_norm_rows(xx, w, epsilon=1e-6),
                         (x,)),
         cold_library_ms=cold_ms(lambda xx: torch.nn.functional.rms_norm(
             xx, (hidden,), w, 1e-6), (x,)))
    # with a bias: no one PyTorch call adds it, so the yardstick is
    # F.rms_norm, the norm alone
    bms, by = bound_ms(2 * n * hidden * 2 + 2 * hidden * 2 + n * 4,
                       5 * n * hidden, peaks)
    emit("kernel", name="rms_norm", case="train_shape, bias",
         shape=[n, hidden], max_abs_err=err,
         ms=graph_ms(lambda: rn.rms_norm_rows(x, w, bias, epsilon=1e-6),
                     calls=10),
         plain_ms=graph_ms(lambda: rn.rms_norm_plain(x, w, bias,
                                                     epsilon=1e-6), calls=10),
         library_ms=graph_ms(lambda: torch.nn.functional.rms_norm(
             x, (hidden,), w, 1e-6), calls=10),
         library="F.rms_norm (the norm alone, no bias)",
         bound_ms=bms, bound_by=by,
         cold_ms=cold_ms(lambda xx: rn.rms_norm_rows(xx, w, bias,
                                                     epsilon=1e-6),
                         (x,)))
    err = max(compare(f"rms_norm_bwd {nm}", got, want) for nm, got, want in
              zip(("dx", "dw", "db"), rn.rms_norm_bwd(x, w, r, g),
                  rn.rms_norm_bwd_plain(x, w, r, g)))
    nb = 3 * n * hidden * 2 + hidden * 2 + n * 4 + 2 * hidden * 2
    bms, by = bound_ms(nb, 11 * n * hidden, peaks)
    side = torch.cuda.Stream()  # the library's forward, and its backward
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        yl = torch.nn.functional.rms_norm(xl, (hidden,), wl, 1e-6)
    results["rms_norm_bwd"] = rec = dict(
        shape=[n, hidden], max_abs_err=err,
        ms=graph_ms(lambda: rn.rms_norm_bwd(x, w, r, g), calls=10),
        plain_ms=graph_ms(lambda: rn.rms_norm_bwd_plain(x, w, r, g),
                          calls=10),
        library_ms=graph_ms(lambda: torch.autograd.grad(
            yl, (xl, wl), g, retain_graph=True), calls=10, stream=side),
        eager_ms=eager_ms(lambda: rn.rms_norm_bwd(x, w, r, g), calls=20),
        bound_ms=bms, bound_by=by)
    emit("kernel", name="rms_norm_bwd", **rec)
    torch.cuda.synchronize()

    # RoPE forward of (q, k), then its adjoint of (dq, dk), at the
    # training step's arange positions 0..1535
    cos, sin = _rope_tables(hd, CFG_438M["max_position_embeddings"], 10000.0,
                            dev)
    dq, dk = randn(b, s, heads, hd), randn(b, s, heads, hd)
    pos = torch.arange(s, device=dev, dtype=torch.int32).expand(
        b, s).contiguous()
    pairs = n * 2 * heads * hd // 2
    nb = 2 * 2 * dq.numel() * 2 + pos.numel() * 4 + 2 * s * hd * 4
    bms, by = bound_ms(nb, 6 * pairs, peaks)
    err = max(compare("fused_rope(train)", got, want) for got, want in zip(
        fo.fused_rope_at(dq, dk, cos, sin, pos),
        fo.fused_rope_plain(dq, dk, cos, sin, pos)))
    emit("kernel", name="fused_rope", case="train_shape",
         shape=list(dq.shape), max_abs_err=err,
         ms=graph_ms(lambda: fo.fused_rope_at(dq, dk, cos, sin, pos),
                     calls=10),
         plain_ms=graph_ms(lambda: fo.fused_rope_plain(dq, dk, cos, sin, pos),
                           calls=10),
         library_ms=None, bound_ms=bms, bound_by=by)
    err = max(compare("fused_rope_bwd", got, want) for got, want in zip(
        fo.fused_rope_at(dq, dk, cos, sin, pos, inverse=True),
        fo.fused_rope_plain(dq, dk, cos, sin, pos, inverse=True)))
    rope = lambda: fo.fused_rope_at(dq, dk, cos, sin, pos,  # noqa: E731
                                 inverse=True)
    results["fused_rope_bwd"] = rec = dict(
        shape=list(dq.shape), max_abs_err=err, ms=graph_ms(rope, calls=10),
        plain_ms=graph_ms(lambda: fo.fused_rope_plain(
            dq, dk, cos, sin, pos, inverse=True), calls=10),
        library_ms=None, eager_ms=eager_ms(rope, calls=20),
        bound_ms=bms, bound_by=by)
    emit("kernel", name="fused_rope_bwd", **rec)
    torch.cuda.synchronize()

    # flash forward, then dK/dV and dQ, at the training shape (MHA), and
    # on a GQA case (12 heads on 4 kv heads, S = 512), which the 438M
    # model does not exercise
    rows = flash_rows(peaks, gen, "train", b, s, heads, heads, hd, True)
    results.update({k: rows[k] for k in FLASH_NAMES[1:]})
    flash_rows(peaks, gen, "gqa", 2, 512, heads, 4, hd, True)
    return results


def grad_phase(base=CFG_438M, phase="grad", dtype=torch.bfloat16):
    """Gradients of a 2-layer model at ``base``'s widths (the 438M
    model's unless given), in ``dtype`` (bf16 unless given) on the card
    through the kernels against f32 on the CPU through the plain versions.
    In f32 the gates are F32_LOSS_REL and F32_GRAD_REL_L2, and every
    launch must be an ``[f32]`` one."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaPretrainingCriterion
    from paddle_tpu_torch.ops.cuda import launch_counts

    f32 = dtype == torch.float32
    loss_tol, grad_tol, labels_tol = (
        (F32_LOSS_REL, F32_GRAD_REL_L2, F32_LOSS_REL) if f32
        else (GRAD_LOSS_REL, GRAD_REL_L2, LABELS_REL))
    cfg = LlamaConfig(**{**base, "num_hidden_layers": 2})
    card, cpu = card_and_cpu(cfg, (2, 3), dtype)
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 256))
    crit = LlamaPretrainingCriterion()
    t0 = time.monotonic()
    launch_counts.clear()
    losses = {}
    for tag, model in (("card", card), ("cpu", cpu)):
        t = torch.tensor(ids, device=model.device)
        loss = crit(model(t), t)
        loss.backward()
        losses[tag] = float(loss.detach())
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    t = torch.tensor(ids, device="cuda")
    with torch.no_grad():
        labels_loss = float(card(t, labels=t))
    cpu_params = dict(cpu.named_parameters())
    rel = {name: float((p.grad.float().cpu() - cpu_params[name].grad).norm()
                       / cpu_params[name].grad.norm())
           for name, p in card.named_parameters()}
    loss_rel = abs(losses["card"] - losses["cpu"]) / abs(losses["cpu"])
    labels_rel = abs(labels_loss - losses["card"]) / abs(losses["card"])
    worst = max(rel, key=rel.get)
    wrong = [k for k in counts if f32 and not k.endswith("[f32]")]
    emit(phase, dtype=str(dtype), losses=losses, loss_rel=loss_rel,
         loss_tolerance=loss_tol, grad_rel_l2=rel,
         grad_rel_l2_max=[worst, rel[worst]], grad_tolerance=grad_tol,
         labels_loss=labels_loss, labels_rel=labels_rel,
         labels_tolerance=labels_tol, launches=counts,
         seconds=time.monotonic() - t0)
    if (loss_rel > loss_tol or rel[worst] > grad_tol
            or not np.isfinite(rel[worst]) or labels_rel > labels_tol
            or wrong):
        raise PhaseFailed(f"{phase}: loss rel {loss_rel:.3g}, worst gradient "
                          f"{worst} rel L2 {rel[worst]:.3g}, labels= rel "
                          f"{labels_rel:.3g}, launches off the dtype {wrong}")


TRAIN_KERNELS = ("rms_norm", "rms_norm_bwd", "fused_rope", "fused_rope_bwd",
                 "flash_attention", "flash_attention_bwd_dkdv",
                 "flash_attention_bwd_dq")


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1536, 5


def train_workload(base=CFG_438M, dtype=torch.bfloat16):
    """bench.py section (b)'s training step on the card: the 438M model
    (or ``base``'s) in ``dtype`` (bf16 unless given; random weights from
    seed 0),
    AdamW(learning_rate=1e-4, multi_precision=True), TrainStep over
    LlamaPretrainingCriterion, and one batch of TRAIN_BATCH x TRAIN_SEQ
    ids from np.random.RandomState(0). Returns (model, optimizer, step,
    ids, labels); the labels are the ids."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        LlamaConfig,
        LlamaForCausalLM,
        LlamaPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**base)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=dtype,
                             generator=seed(0, "cuda"))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    step = TrainStep(model, LlamaPretrainingCriterion(), opt)
    ids = torch.tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)), device="cuda")
    return model, opt, step, ids, ids


def timed_steps(step, ids, labels, steps=TRAIN_STEPS):
    """``steps`` steps on ``ids`` and ``labels``, each timed with CUDA
    events: returns (losses, step ms)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    losses = []
    events[0].record()
    for i in range(steps):
        losses.append(step(ids, labels=labels))
        events[i + 1].record()
    torch.cuda.synchronize()
    return ([float(x) for x in losses],
            [events[i].elapsed_time(events[i + 1]) for i in range(steps)])


def train_phase(name, smi, peaks, base=CFG_438M, phase="train",
                dtype=torch.bfloat16):
    """The training slice: TrainStep on the 438M model (or ``base``'s) at
    batch 4 x seq 1536, bench.py section (b)'s configuration, in
    ``dtype`` (bf16 unless given). In f32 the step must launch the seven
    training kernels' ``[f32]`` forms at their counts (RMSNorm 2 L + 1
    each way, the others L) and nothing else, and MFU is also given
    against the f32 FMA peak."""
    from paddle_tpu_torch.ops.cuda import launch_counts

    f32 = dtype == torch.float32
    tag = "[f32]" if f32 else ""
    torch.cuda.reset_peak_memory_stats()
    model, _, step, ids, labels = train_workload(base, dtype)
    cfg, (batch, seqlen), steps = model.config, ids.shape, TRAIN_STEPS
    n_params = sum(p.numel() for p in model.parameters())
    # the warm-up step, with the launch counts zeroed just before it and
    # read just after it: every step launches the same kernels
    torch.cuda.synchronize()
    launch_counts.clear()
    losses = [float(step(ids, labels=labels))]
    torch.cuda.synchronize()
    counts = {k + tag: launch_counts[k + tag] for k in TRAIN_KERNELS}
    others = {k: v for k, v in launch_counts.items() if k not in counts}
    timed, step_ms = timed_steps(step, ids, labels, steps)
    losses += timed
    steady = float(np.median(step_ms))
    tokens_per_sec = batch * seqlen / (steady / 1e3)
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_hidden_layers * cfg.hidden_size * seqlen)
    mfu = tokens_per_sec * flops_per_token / peaks[1]
    extra = {}
    if f32:
        extra = dict(dtype=str(dtype), mfu_f32_fma=tokens_per_sec
                     * flops_per_token / peaks[2], other_launches=others)
    emit(phase, params=n_params, batch=batch, seq=seqlen, steps=steps,
         step_ms=step_ms, step_ms_median=steady,
         tokens_per_sec=tokens_per_sec, flops_per_token=flops_per_token,
         mfu=mfu, max_memory_allocated=torch.cuda.max_memory_allocated(),
         losses=losses, launches_per_step=counts, card=name, nvidia_smi=smi,
         **extra)
    first, last = losses[0], losses[-1]
    if not all(np.isfinite(losses)):
        raise PhaseFailed(f"{phase}: a loss is not finite: {losses}")
    if abs(first - np.log(cfg.vocab_size)) > 1.0:
        raise PhaseFailed(f"{phase}: first loss {first:.4f} is more than "
                          f"1.0 from ln {cfg.vocab_size}")
    if not last < first:
        raise PhaseFailed(f"{phase}: loss did not fall: {losses}")
    missing = [k for k in counts if counts[k] <= 0]
    if missing:
        raise PhaseFailed(f"{phase}: {missing} not launched in a step")
    if f32:
        layers = cfg.num_hidden_layers
        want = {k + tag: (2 * layers + 1 if k.startswith("rms_norm")
                          else layers) for k in TRAIN_KERNELS}
        if counts != want or others:
            raise PhaseFailed(f"{phase}: launches {counts} (want {want}), "
                              f"others {others}")
    return counts


# bias-dropout-residual-LN kernel cases: (rows, H, dtype, training); the
# first, BERT-base's 32 x 128 tokens in training, is the kernels line's
BDRLN_CASES = [(4096, 768, torch.bfloat16, True),
               (4096, 768, torch.bfloat16, False),
               (4096, 768, torch.float32, True),
               (1024, 1536, torch.bfloat16, True),
               (37, 1000, torch.bfloat16, True)]
BDRLN_RATE, BDRLN_EPS = 0.1, 1e-5


def bdrln_phase(peaks):
    """The bias-dropout-residual-LayerNorm kernel against its plain version
    at BDRLN_CASES, masks from a seeded generator. Its library yardstick is
    ``F.layer_norm`` over the precomputed z: the norm alone, since no one
    PyTorch call computes the whole function. The kernel is memory-bound,
    so ``ms``, ``plain_ms`` and ``library_ms`` are timed with the inputs
    out of L2 (``cold_ms``), comparable with the bound; ``warm_ms`` replays
    one input set, which the 50 MB L2 may hold."""
    from paddle_tpu_torch.ops.cuda import fused_ops as fo

    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    results = {}
    for rows, h, dtype, training in BDRLN_CASES:
        x, res = randn(rows, h, dtype=dtype), randn(rows, h, dtype=dtype)
        bias, lnb = 0.1 * randn(h, dtype=dtype), 0.1 * randn(h, dtype=dtype)
        scale = (1.0 + 0.1 * randn(h, dtype=torch.float32)).to(dtype)
        mask = (torch.rand((rows, h), generator=gen, device="cuda")
                < 1.0 - BDRLN_RATE) if training else None
        args = (x, res, bias, scale, lnb, mask, BDRLN_RATE, BDRLN_EPS,
                training)
        case = f"({rows}, {h}) {str(dtype)[6:]} {'train' if training else 'eval'}"
        y, mean, rstd = fo.bias_dropout_residual_ln_fwd(*args)
        py, pmean, prstd = fo.bias_dropout_residual_ln_plain(*args)
        err = compare(f"bias_dropout_residual_ln {case}", y, py)
        stat_err = {}
        for what, got, want in (("mean", mean, pmean), ("rstd", rstd, prstd)):
            e = (got - want).abs().max().item()
            stat_err[what] = e
            if not e <= BDRLN_STAT_REL * want.abs().max().item():
                raise PhaseFailed(f"bias_dropout_residual_ln {case}: {what} "
                                  f"off by {e:.3g}")
        size = x.element_size()
        nb = (3 * rows * h * size + (rows * h if training else 0)
              + 3 * h * size + 2 * rows * 4)
        bms, by = bound_ms(nb, 11 * rows * h, peaks, flop_rate=peaks[2])
        z = ((x.float() + bias.float()) * (mask * (1.0 / (1.0 - BDRLN_RATE))
                                           if training else 1.0)
             + res.float()).to(dtype)
        layer_norm = torch.nn.functional.layer_norm
        rec = dict(
            case=case, shape=[rows, h], max_abs_err=err,
            mean_err=stat_err["mean"], rstd_err=stat_err["rstd"],
            ms=cold_ms(fo.bias_dropout_residual_ln_fwd, args),
            plain_ms=cold_ms(fo.bias_dropout_residual_ln_plain, args),
            library_ms=cold_ms(lambda zz: layer_norm(
                zz, (h,), scale, lnb, BDRLN_EPS), (z,)),
            library="F.layer_norm over the precomputed z (the norm alone)",
            warm_ms=graph_ms(lambda: fo.bias_dropout_residual_ln_fwd(*args)),
            warm_library_ms=graph_ms(lambda: layer_norm(
                z, (h,), scale, lnb, BDRLN_EPS)),
            eager_ms=eager_ms(lambda: fo.bias_dropout_residual_ln_fwd(*args)),
            bound_ms=bms, bound_by=by, bound_bytes=nb)
        emit("kernel", name="bias_dropout_residual_ln", **rec)
        results.setdefault("bias_dropout_residual_ln", rec)
        torch.cuda.synchronize()
    return results


BERT_ATTN = (32, 128, 12, 64)  # BERT-base at batch 32 x seq 128


def bert_flash_phase(peaks):
    """The flash kernels at BERT-base's attention, BERT_ATTN non-causal
    (head_dim 64), against their plain versions, beside
    ``F.scaled_dot_product_attention`` forward and forward + backward."""
    b, s, h, d = BERT_ATTN
    return flash_rows(peaks, torch.Generator(device="cuda").manual_seed(6),
                      "bert_shape", b, s, h, h, d, False)


# shapes off the main path's tiles, those of tests/test_torch_cuda.py's
# flash tests and two a row from a multiple of 64 on either side:
# (b, sq, sk, heads, kv_heads, d, causal)
FLASH_EDGE_CASES = [
    (2, 32, 32, 12, 12, 128, True),      # the serving path's bucket 32
    (1, 50, 50, 8, 2, 64, True),         # ragged length, GQA group 4
    (2, 5, 70, 16, 2, 128, True),        # causal offset sk - sq
    (1, 33, 17, 4, 4, 64, False),        # non-causal, sq > sk
    (1, 100, 100, 8, 4, 64, True),       # GQA group 2, off the 64-row tile
    (2, 70, 70, 16, 2, 128, True),       # GQA group 8
    (1, 150, 150, 12, 12, 128, True),    # MHA, three tiles, the last ragged
    (2, 1025, 1025, 12, 12, 128, True),  # 64 x 16 + 1: dK/dV on 64-key tiles
    (4, 383, 383, 8, 2, 64, False),      # 64 x 6 - 1
]


def flash_edge_phase(widths=None):
    """The flash forward, dK/dV and dQ kernels against their plain versions
    at FLASH_EDGE_CASES, within the kernel gate: out and lse (within
    1e-3), then dK, dV and dQ from the forward kernel's out and lse. With
    ``widths``, every case runs again at each of those head dims."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    cases = [(b, sq, sk, h, kvh, dd, causal)
             for b, sq, sk, h, kvh, d, causal in FLASH_EDGE_CASES
             for dd in (widths or (d,))]
    for b, sq, sk, h, kvh, d, causal in cases:
        tag = f"({b}, {sq}, {sk}, {h}, {kvh}, {d}, causal={causal})"
        q, do = randn(b, sq, h, d), randn(b, sq, h, d)
        k, v = randn(b, sk, kvh, d), randn(b, sk, kvh, d)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
        errs = {"out": compare(f"flash_attention{tag}", out, pout)}
        lse_err = (lse - plse).abs().max().item()
        if lse_err > 1e-3:
            raise PhaseFailed(f"flash_attention{tag}: lse off by "
                              f"{lse_err:.3g}")
        delta = fa._delta(out, do)
        got_dk, got_dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                     causal)
        got_dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal)
        for nm, got, w in zip(("dq", "dk", "dv"), (got_dq, got_dk, got_dv),
                              want):
            errs[nm] = compare(f"{nm}{tag}", got, w)
        emit("flash-edge", shape=[b, sq, sk, h, kvh, d], causal=causal,
             lse_err=lse_err, max_abs_err=errs)
    torch.cuda.synchronize()


def packed_ids(b, s, seed, lo=32, hi=1537):
    """(b, s) int32 ids of packed documents: each row takes documents of
    np.random.RandomState(seed).randint(lo, hi) tokens (one stream over
    the rows) until they fill s, the last one cut to fit; ids count the
    documents of a row from 0. Returns (ids, the documents' lengths in
    order)."""
    rng = np.random.RandomState(seed)
    ids, lens = np.empty((b, s), np.int32), []
    for i in range(b):
        pos, doc = 0, 0
        while pos < s:
            n = min(int(rng.randint(lo, hi)), s - pos)
            ids[i, pos:pos + n] = doc
            lens.append(n)
            pos, doc = pos + n, doc + 1
    return ids, lens


def seg_pairs(fa, q_seg, k_seg, sq, sk, causal):
    """The visible, same-segment (query, key) pairs of one head, counted
    exactly from the ids (the work a masked kernel must do), and the
    (B, 1, Sq, Sk) mask they come from."""
    keep = fa._keep(sq, sk, causal, q_seg, k_seg, q_seg.device)
    return int(keep.sum()), keep


def event_median_ms(fn, calls=5):
    """One warm-up call, then ``calls`` calls each between CUDA events:
    the median in ms, every call's time and the last call's result."""
    fn()
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), times, res


def varlen_library(q, k, v, cu, max_len, causal):
    """``torch.nn.attention.varlen.varlen_attn`` over (total, H, D) q, k,
    v and ``cu`` boundaries, where the card's torch has it (a yardstick,
    never called by the port): ``(fn, None)`` with ``fn(q, k, v)`` the
    call on other tensors of the same layout, or ``(None, why not)``."""
    try:
        from torch.nn.attention import varlen
    except ImportError as e:
        return None, f"no torch.nn.attention.varlen ({e})"
    import inspect
    params = inspect.signature(varlen.varlen_attn).parameters
    kw = ({"is_causal": causal} if "is_causal" in params
          else {"window_size": (-1, 0) if causal else (-1, -1)})

    def fn(q_, k_, v_):
        return varlen.varlen_attn(q_, k_, v_, cu, cu, max_len, max_len, **kw)

    try:  # the library's own refusal is reported, not the port's
        fn(q, k, v)
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError, NotImplementedError) as e:
        return None, f"varlen_attn refused: {str(e).splitlines()[0][:200]}"
    return fn, None


def device_profile(fn, steps=2):
    """``steps`` calls of ``fn`` under torch.profiler: device busy ms per
    call (the kernels' device time), the device's idle share of the wall
    time, and the kernels that took the most device time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = float(getattr(e, "self_device_time_total", 0.0))
            kernels[e.key[:80]] = (us, e.count)
    busy = sum(us for us, _ in kernels.values())
    return dict(
        wall_ms_per_call=1e3 * wall / steps,
        device_busy_ms_per_call=busy / 1e3 / steps,
        device_idle_share=1.0 - busy / 1e6 / wall,
        top_kernels=[dict(kernel=k, ms_per_call=us / 1e3 / steps,
                          launches_per_call=n / steps)
                     for k, (us, n) in sorted(kernels.items(),
                                              key=lambda kv: -kv[1][0])[:8]])


SEG_KERNELS = ("flash_attention[seg]", "flash_attention_bwd_dkdv[seg]",
               "flash_attention_bwd_dq[seg]")


def seg_check(fa, tag, q, k, v, do, causal, q_seg, k_seg, keep):
    """The three masked kernels against their plain versions on the same
    ids, within the kernel gate on rows with a visible key; rows with none
    must be exactly 0 (out, dQ) with lse -1e30, in both versions. Returns
    (errors by kernel, out, lse, delta)."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal, q_seg, k_seg)
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal, q_seg,
                                              k_seg)
    valid = keep.any(-1)[:, 0]  # (B, Sq)
    empty = int((~valid).sum())
    rows = valid[:, :, None, None].expand_as(out)
    errs = {"flash_attention[seg]": compare(f"out{tag}", out[rows],
                                            pout[rows])}
    lse_ok = valid[:, None, :].expand_as(lse)
    lse_err = (lse[lse_ok] - plse[lse_ok]).abs().max().item()
    if lse_err > 1e-3:
        raise PhaseFailed(f"flash_attention[seg]{tag}: lse off by "
                          f"{lse_err:.3g}")
    if empty and not (bool((out[~rows] == 0).all())
                      and bool((pout[~rows] == 0).all())
                      and bool((lse[~lse_ok] == fa.NEG_INF).all())
                      and bool((plse[~lse_ok] == fa.NEG_INF).all())):
        raise PhaseFailed(f"flash_attention[seg]{tag}: a row with no "
                          f"visible key is not out 0, lse -1e30")
    delta = fa._delta(out, do)
    got_dk, got_dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                 causal, q_seg, k_seg)
    got_dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal,
                                       q_seg, k_seg)
    want_dq, want_dk, want_dv = fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal, q_seg, k_seg)
    errs["flash_attention_bwd_dkdv[seg]"] = max(
        compare(f"dk{tag}", got_dk, want_dk),
        compare(f"dv{tag}", got_dv, want_dv))
    errs["flash_attention_bwd_dq[seg]"] = compare(f"dq{tag}", got_dq,
                                                  want_dq)
    if empty and not bool((got_dq[~rows] == 0).all()):
        raise PhaseFailed(f"flash_attention_bwd_dq[seg]{tag}: a row with "
                          f"no visible key has a nonzero dQ")
    torch.cuda.synchronize()
    return errs, empty, out, lse, delta


def seg_times(fa, peaks, q, k, v, do, out, lse, delta, causal, q_seg,
              k_seg, keep, pairs, calls=3, varlen_args=None):
    """Device time per call of the three masked kernels (their wrappers,
    the range tables included; ``kernel_ms`` the launch alone, the tables
    built beforehand, and ``table_ms`` the tables alone), the plain
    versions, the dense-mask SDPA (forward; ``autograd.grad`` for the
    backward pair) and, given ``varlen_args`` (q, k, v as (total, H, D),
    cu_seqlens, max length), ``varlen_attn``; each kernel's bound from the
    exact pair count."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    gqa = dict(enable_gqa=True) if kvh != h else {}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
        ol = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=keep, **gqa)
    dol = do.transpose(1, 2)
    lib_bwd = graph_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), dol, retain_graph=True), calls=calls, replays=3,
        stream=side)
    lib_fwd = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep, **gqa), calls=calls, replays=3)
    varlen_fwd = varlen_why = None
    if varlen_args is not None:
        fn, varlen_why = varlen_library(*varlen_args, causal)
        if fn is not None:
            varlen_fwd = graph_ms(lambda: fn(*varlen_args[:3]), calls=calls,
                                  replays=3)
    plain_bwd = graph_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal, q_seg, k_seg), calls=1, replays=2)
    seg_bytes = (q_seg.numel() + k_seg.numel()) * 4
    io = (q.numel() + 2 * k.numel() + do.numel()) * 2 + 2 * lse.numel() * 4
    kernels = {
        "flash_attention[seg]": (
            lambda: fa.flash_attention_fwd(q, k, v, causal, q_seg, k_seg),
            4 * d * h * pairs,
            (2 * q.numel() + 2 * k.numel()) * 2 + lse.numel() * 4,
            graph_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, causal, q_seg, k_seg), calls=1, replays=2),
            lib_fwd),
        "flash_attention_bwd_dkdv[seg]": (
            lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                causal, q_seg, k_seg),
            8 * d * h * pairs, io + 2 * k.numel() * 2, plain_bwd, lib_bwd),
        "flash_attention_bwd_dq[seg]": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              causal, q_seg, k_seg),
            6 * d * h * pairs, io + q.numel() * 2, plain_bwd, lib_bwd)}
    # the launches alone, with the range tables built once beforehand
    seg = fa._segments("flash_attention", q, k, q_seg, k_seg)
    launch_only = {
        "flash_attention[seg]": lambda: fa._launch_fwd(q, k, v, causal, seg),
        "flash_attention_bwd_dkdv[seg]": lambda: fa._launch_dkdv(
            q, k, v, do, lse, delta, causal, seg),
        "flash_attention_bwd_dq[seg]": lambda: fa._launch_dq(
            q, k, v, do, lse, delta, causal, seg)}
    table_ms = graph_ms(lambda: fa._segments("flash_attention", q, k, q_seg,
                                             k_seg), calls=calls, replays=3)
    recs = {}
    for kname, (fn, flops, nb, plain, lib) in kernels.items():
        bms, by = bound_ms(nb + seg_bytes, flops, peaks)
        ms = graph_ms(fn, calls=calls, replays=3)
        recs[kname] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bms, bound_by=by, **rates(flops, ms, bms),
                           kernel_ms=graph_ms(launch_only[kname], calls=calls,
                                              replays=3),
                           table_ms=table_ms)
    recs["flash_attention[seg]"]["varlen_library_ms"] = varlen_fwd
    if varlen_why:
        recs["flash_attention[seg]"]["varlen_library"] = varlen_why
    return recs


def unmasked_times(fa, q, k, v, do, causal, calls=3):
    """The unmasked kernels' times at the same shape, in the same call."""
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    delta = fa._delta(out, do)
    return {
        "flash_attention[seg]": graph_ms(
            lambda: fa.flash_attention_fwd(q, k, v, causal), calls=calls,
            replays=3),
        "flash_attention_bwd_dkdv[seg]": graph_ms(
            lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                causal), calls=calls,
            replays=3),
        "flash_attention_bwd_dq[seg]": graph_ms(
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              causal), calls=calls,
            replays=3)}


def flash_segments_phase(peaks):
    """The three masked kernels (``kSegments``) against their plain
    versions with the same ids, within the kernel gate; rows with no
    visible key exactly 0. The timed cases (device time per call, the
    bound from the exact pair count, its share, TFLOP/s, the dense-mask
    SDPA and, for packed documents, ``varlen_attn``): the b-438M shape
    (4, 1536, 12, 128) causal with packed documents (lengths from
    np.random.RandomState(11).randint(32, 1537)) and with all-zero ids
    (the mask's cost alone), both beside the unmasked kernels; BERT-base
    (32, 128, 12, 64) non-causal with seq_lens from RandomState(12)
    .randint(32, 129); GQA q (2, 512, 12, 128) on 4 kv heads causal with
    seq_lens. Untimed: cross attention, sq 96 on sk 160 with a (q_ids,
    k_ids) pair in which a query segment is missing from the keys, and
    every FLASH_EDGE_CASES shape with sq == sk with packed ids."""
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    def ids(a):
        return torch.tensor(a, dtype=torch.int32, device="cuda")

    b, s, h, d = 4, 1536, 12, 128
    packed, lens = packed_ids(b, s, 11)
    cases = [  # name, (b, sq, sk, h, kvh, d), causal, (q_seg, k_seg)
        ("train_packed", (b, s, s, h, h, d), True, (ids(packed),) * 2),
        ("train_zero_ids", (b, s, s, h, h, d), True,
         (ids(np.zeros((b, s))),) * 2),
        ("bert_seq_lens", (32, 128, 128, 12, 12, 64), False,
         fa.build_segments(32, 128, 128, np.random.RandomState(12).randint(
             32, 129, 32), device="cuda")),
        ("gqa_seq_lens", (2, 512, 512, 12, 4, 128), True,
         fa.build_segments(2, 512, 512, np.random.RandomState(13).randint(
             32, 513, 2), device="cuda"))]
    rng = np.random.RandomState(14)
    q_cross = np.sort(rng.randint(0, 5, (2, 96)), 1)
    k_cross = np.sort(rng.randint(0, 5, (2, 160)), 1)
    k_cross[k_cross == 3] = 4  # segment 3 of the queries sees no key
    cases.append(("cross_pair", (2, 96, 160, 8, 2, 128), False,
                  (ids(q_cross), ids(k_cross))))
    for i, (eb, sq, sk, eh, ekvh, ed, causal) in enumerate(FLASH_EDGE_CASES):
        if sq == sk:
            e_ids = ids(packed_ids(eb, sq, 15 + i, 1, max(2, sq // 2))[0])
            cases.append((f"edge{i}", (eb, sq, sk, eh, ekvh, ed), causal,
                          (e_ids, e_ids)))
    results = {}
    for name, (cb, sq, sk, ch, ckvh, cd), causal, (q_seg, k_seg) in cases:
        tag = f"[{name}]"
        q, do = randn(cb, sq, ch, cd), randn(cb, sq, ch, cd)
        k, v = randn(cb, sk, ckvh, cd), randn(cb, sk, ckvh, cd)
        pairs, keep = seg_pairs(fa, q_seg, k_seg, sq, sk, causal)
        errs, empty, out, lse, delta = seg_check(
            fa, tag, q, k, v, do, causal, q_seg, k_seg, keep)
        rec = dict(case=name, shape=[cb, sq, sk, ch, ckvh, cd],
                   causal=causal, pairs_per_head=pairs,
                   dense_pairs_per_head=cb * sq * sk,
                   rows_without_key=empty, max_abs_err=errs)
        if name in ("train_packed", "train_zero_ids", "bert_seq_lens",
                    "gqa_seq_lens"):
            varlen_args = None
            if name == "train_packed":
                cu = ids(np.concatenate([[0], np.cumsum(lens)]))
                varlen_args = (*(t.reshape(-1, *t.shape[2:])
                                 for t in (q, k, v)), cu, max(lens))
            times = seg_times(fa, peaks, q, k, v, do, out, lse, delta,
                              causal, q_seg, k_seg, keep, pairs,
                              varlen_args=varlen_args)
            if name.startswith("train"):
                for kname, ums in unmasked_times(fa, q, k, v, do,
                                                 causal).items():
                    times[kname]["unmasked_ms"] = ums
            rec["times"] = times
            results[name] = times
        emit("flash-segments", **rec)
        del keep
        torch.cuda.synchronize()
    # the skipping: packed documents must beat the same kernels with
    # all-zero ids (nothing to skip)
    slower = [k for k in SEG_KERNELS if results["train_packed"][k]["ms"]
              >= results["train_zero_ids"][k]["ms"]]
    if slower:
        raise PhaseFailed(f"flash-segments: {slower} no faster on packed "
                          f"documents than with all-zero ids")
    torch.cuda.empty_cache()
    return results


VARLEN_TOTAL, VARLEN_STEPS = 6144, 5


def varlen_phase(peaks):
    """The varlen path at the 438M's attention width:
    ``nn.functional.flash_attn_varlen_qkvpacked`` on qkv (6144, 3, 12,
    128) bf16, causal, documents from np.random.RandomState(11)
    .randint(32, 1537) packed to 6144 (cu_seqlens int32 on the card),
    forward and backward through autograd. Launch counts are zeroed just
    before the warm-up and the 5 timed steps and read just after: each
    [seg] kernel must have launched. out and the qkv gradient are finite
    and within the kernel gate of the masked plain version (f32 on the
    card, from the forward kernel's out and lse) and within 5e-2
    relative L2 of a per-document loop of the plain version. Beside the
    step's time (median of 5 CUDA-event-timed steps after one warm-up):
    a per-document loop of the port's unmasked flash_attention under
    autograd, the dense-mask SDPA and, where the card's torch has it,
    ``varlen_attn``. Then each [seg] kernel alone at this shape, for the
    kernels line."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import launch_counts

    total, h, d = VARLEN_TOTAL, 12, 128
    packed, lens = packed_ids(1, total, 11)
    bounds = np.concatenate([[0], np.cumsum(lens)])
    cu = torch.tensor(bounds, dtype=torch.int32, device="cuda")
    max_len = max(lens)
    gen = torch.Generator(device="cuda").manual_seed(16)
    qkv = torch.randn((total, 3, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    dout = torch.randn((total, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)

    def step():
        x = qkv.detach().requires_grad_()
        out, _ = F.flash_attn_varlen_qkvpacked(x, cu, cu, max_len, max_len,
                                               causal=True)
        out.backward(dout)
        return out, x.grad

    torch.cuda.synchronize()
    launch_counts.clear()
    step_ms, step_all, (out, grad) = event_median_ms(step, VARLEN_STEPS)
    torch.cuda.synchronize()
    counts = {k: launch_counts[k] for k in SEG_KERNELS}
    if not (bool(torch.isfinite(out.float()).all())
            and bool(torch.isfinite(grad.float()).all())):
        raise PhaseFailed("varlen: out or the qkv gradient is not finite")

    # against the masked plain version, from the forward kernel's out, lse
    seg = torch.tensor(packed, dtype=torch.int32, device="cuda")
    q, k, v = (qkv[None, :, i].contiguous() for i in range(3))
    do = dout[None]
    out_k, lse_k = fa.flash_attention_fwd(q, k, v, True, seg, seg)
    errs = {"out": compare("varlen out", out[None], fa.flash_attention_fwd_plain(
        q, k, v, True, seg, seg)[0])}
    want = fa.flash_attention_bwd_plain(q, k, v, out_k, lse_k, do, True, seg,
                                        seg)
    for i, nm in enumerate(("dq", "dk", "dv")):
        errs[nm] = compare(f"varlen {nm}", grad[None, :, i], want[i])
    del want
    torch.cuda.empty_cache()
    # against a per-document loop of the plain version
    loop_out, loop_grad = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        qi, ki, vi = (t[:, lo:hi] for t in (q, k, v))
        o_i, l_i = fa.flash_attention_fwd_plain(qi, ki, vi, True)
        loop_out.append(o_i[0])
        loop_grad.append(torch.stack(fa.flash_attention_bwd_plain(
            qi, ki, vi, o_i, l_i, do[:, lo:hi], True), 2)[0])
    rel = {"out": rel_l2(out, torch.cat(loop_out))}
    loop_grad = torch.cat(loop_grad)
    for i, nm in enumerate(("dq", "dk", "dv")):
        rel[nm] = rel_l2(grad[:, i], loop_grad[:, i])
    if max(rel.values()) > VARLEN_REL_L2:
        raise PhaseFailed(f"varlen: rel L2 against the per-document plain "
                          f"loop {rel} beyond {VARLEN_REL_L2}")

    # beside it: the port's unmasked kernels per document, the dense-mask
    # SDPA and varlen_attn, each forward and backward
    def loop_step():
        x = qkv.detach().requires_grad_()
        outs = [fa.flash_attention(*(x[None, lo:hi, i].contiguous()
                                     for i in range(3)), True)[0]
                for lo, hi in zip(bounds[:-1], bounds[1:])]
        torch.cat(outs).backward(dout)

    pairs, keep = seg_pairs(fa, seg, seg, total, total, True)

    def sdpa_step():
        x = qkv.detach().requires_grad_()
        o = torch.nn.functional.scaled_dot_product_attention(
            *(x[None, :, i].transpose(1, 2) for i in range(3)),
            attn_mask=keep)
        o.transpose(1, 2).backward(do)

    profile = device_profile(step)
    beside = {"port_unmasked_loop_ms": event_median_ms(loop_step)[0],
              "sdpa_dense_mask_ms": event_median_ms(sdpa_step)[0]}
    varlen_args = (q[0], k[0], v[0], cu, max_len)
    vfn, why = varlen_library(*varlen_args, True)
    if vfn is not None:
        def varlen_step():
            x = qkv.detach().requires_grad_()
            vfn(*(x[:, i].contiguous() for i in range(3))).backward(dout)

        beside["varlen_attn_ms"] = event_median_ms(varlen_step)[0]
    else:
        beside["varlen_attn"] = why
    delta = fa._delta(out_k, do)
    kernels = seg_times(fa, peaks, q, k, v, do, out_k, lse_k, delta, True,
                        seg, seg, keep, pairs, calls=2,
                        varlen_args=varlen_args)
    for kname in SEG_KERNELS:
        kernels[kname]["max_abs_err"] = errs["out"] if kname.startswith(
            "flash_attention[") else max(errs["dq"], errs["dk"], errs["dv"])
    emit("varlen", qkv=[total, 3, h, d], documents=len(lens),
         max_len=max_len, pairs_per_head=pairs,
         dense_causal_pairs_per_head=total * (total + 1) // 2,
         step_ms_median=step_ms, step_ms=step_all, step_profile=profile,
         **beside,
         max_abs_err=errs, rel_l2_vs_document_loop=rel,
         tolerance=VARLEN_REL_L2, launches=counts, kernels=kernels)
    missing = [k for k in SEG_KERNELS if counts[k] <= 0]
    if missing:
        raise PhaseFailed(f"varlen: {missing} not launched on the path")
    del keep
    torch.cuda.empty_cache()
    return kernels, counts


def rel_l2(got, want):
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).norm() / want.norm())


INCUBATE_PASSES = 3


def incubate_phase():
    """FusedBiasDropoutResidualLayerNorm(768, dropout_rate=0.1) in bf16 on
    (32, 128, 768), INCUBATE_PASSES forward and backward passes, each
    against an f32 CPU run of the plain function (forward and backward)
    at the mask the layer drew, replayed from its generator's state.
    Returns the passes' launch counts."""
    from paddle_tpu_torch.incubate.nn import FusedBiasDropoutResidualLayerNorm
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import launch_counts

    gen = torch.Generator(device="cuda").manual_seed(7)
    layer = FusedBiasDropoutResidualLayerNorm(
        768, dropout_rate=0.1, device="cuda", dtype=torch.bfloat16,
        generator=gen)
    inputs = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape):
        return torch.randn(shape, generator=inputs, device="cuda").to(
            torch.bfloat16)

    with torch.no_grad():
        for p, base in ((layer.linear_bias, 0.0), (layer.ln_scale, 1.0),
                        (layer.ln_bias, 0.0)):
            p.copy_(base + 0.1 * randn(768))
    shape = (32, 128, 768)
    runs = []
    torch.cuda.synchronize()
    launch_counts.clear()
    for _ in range(INCUBATE_PASSES):
        state = gen.get_state()
        x = randn(*shape).requires_grad_()
        res = randn(*shape).requires_grad_()
        dy = randn(*shape)
        layer.zero_grad(set_to_none=True)
        y = layer(x, res)
        y.backward(dy)
        runs.append((state, x, res, dy, y.detach(), x.grad, res.grad,
                     [p.grad for p in layer.parameters()]))
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    worst, keep = {}, []
    params = [p.detach().float().cpu().requires_grad_()
              for p in layer.parameters()]
    for state, x, res, dy, y, dx, dres, pgrads in runs:
        replay = torch.Generator(device="cuda")
        replay.set_state(state)
        mask = torch.rand((4096, 768), generator=replay,
                          device="cuda") < 1.0 - layer.dropout_rate
        keep.append(mask.float().mean().item())
        xc = x.detach().float().cpu().reshape(4096, 768).requires_grad_()
        rc = res.detach().float().cpu().reshape(4096, 768).requires_grad_()
        for p in params:
            p.grad = None
        yc = fo.BiasDropoutResidualLNFunction.apply(
            xc, rc, *params, mask.cpu(), layer.dropout_rate, 1e-5, True)
        yc.backward(dy.float().cpu().reshape(4096, 768))
        pairs = [("y", y, yc), ("dx", dx, xc.grad), ("dres", dres, rc.grad)]
        pairs += [(f"d{n}", g, p.grad) for (n, _), g, p in
                  zip(layer.named_parameters(), pgrads, params)]
        for name, got, want in pairs:
            worst[name] = max(worst.get(name, 0.0),
                              rel_l2(got.reshape(want.shape), want))
    launches = counts.get("bias_dropout_residual_ln", 0)
    emit("incubate", passes=INCUBATE_PASSES, launches=counts,
         rel_l2_max=worst, tolerance=INCUBATE_REL_L2, keep_share=keep)
    if launches != INCUBATE_PASSES:
        raise PhaseFailed(f"incubate: bias_dropout_residual_ln launched "
                          f"{launches} times in {INCUBATE_PASSES} passes")
    bad = {k: v for k, v in worst.items() if not v <= INCUBATE_REL_L2}
    if bad:
        raise PhaseFailed(f"incubate: relative L2 beyond {INCUBATE_REL_L2}: "
                          f"{bad}")
    return counts


def bert_cfg(**over):
    from paddle_tpu_torch.models import bert_base_config

    return bert_base_config(hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0, **over)


def bert_batch(cfg, batch, seq, seed):
    """ids and MLM labels (batch, seq) and NSP labels (batch, 1) on the
    card, from np.random.RandomState(seed), as bench.py (c2) draws them."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq))
    mlm = rng.randint(0, cfg.vocab_size, (batch, seq))
    nsp = rng.randint(0, 2, (batch, 1))
    return (torch.tensor(ids, device="cuda"),
            (torch.tensor(mlm, device="cuda"), torch.tensor(nsp, device="cuda")))


def bert_grad_phase():
    """A 2-layer BERT at BERT-base's widths, bf16 on the card through the
    kernels against f32 on the CPU through the plain versions, batch 4 x
    seq 128 through BertPretrainingCriterion."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import (
        BertForPretraining,
        BertPretrainingCriterion,
    )
    from paddle_tpu_torch.ops.cuda import launch_counts

    cfg = bert_cfg(num_hidden_layers=2)
    card = BertForPretraining(cfg, device="cuda", dtype=torch.bfloat16,
                              generator=seed(9, "cuda"))
    cpu = BertForPretraining(cfg, device="cpu", dtype=torch.float32,
                             generator=seed(10, "cpu"))
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in card.state_dict().items()})
    ids, (mlm, nsp) = bert_batch(cfg, 4, 128, 2)
    crit = BertPretrainingCriterion()
    t0 = time.monotonic()
    launch_counts.clear()
    out = {}
    for tag, model in (("card", card), ("cpu", cpu)):
        dev = model.nsp_head.weight.device
        logits, nsp_logits = model(ids.to(dev))
        loss = crit(logits, nsp_logits, mlm.to(dev), nsp.to(dev))
        loss.backward()
        out[tag] = (logits.detach(), float(loss.detach()))
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    logits_rel = rel_l2(out["card"][0], out["cpu"][0])
    loss_rel = abs(out["card"][1] - out["cpu"][1]) / abs(out["cpu"][1])
    cpu_params = dict(cpu.named_parameters())
    rel, unused = {}, []
    for name, p in card.named_parameters():
        want = cpu_params[name].grad
        if p.grad is None or want is None:
            if (p.grad is None) != (want is None):
                raise PhaseFailed(f"bert-grad: {name} has a gradient on one "
                                  f"side only")
            unused.append(name)
            continue
        rel[name] = rel_l2(p.grad, want)
    worst = max(rel, key=rel.get)
    emit("bert-grad", losses={k: v[1] for k, v in out.items()},
         loss_rel=loss_rel, loss_tolerance=GRAD_LOSS_REL,
         mlm_logits_rel_l2=logits_rel, logits_tolerance=MODEL_REL_L2,
         grad_rel_l2=rel, grad_rel_l2_max=[worst, rel[worst]],
         grad_tolerance=GRAD_REL_L2, no_gradient=unused, launches=counts,
         seconds=time.monotonic() - t0)
    if (logits_rel > MODEL_REL_L2 or loss_rel > GRAD_LOSS_REL
            or not rel[worst] <= GRAD_REL_L2):
        raise PhaseFailed(f"bert-grad: logits rel L2 {logits_rel:.3g}, loss "
                          f"rel {loss_rel:.3g}, worst gradient {worst} rel L2 "
                          f"{rel[worst]:.3g}")
    if min(counts.get(k, 0) for k in BERT_KERNELS) != cfg.num_hidden_layers:
        raise PhaseFailed(f"bert-grad: launches {counts}")


BERT_BATCH, BERT_SEQ = 32, 128
BERT_KERNELS = ("flash_attention", "flash_attention_bwd_dkdv",
                "flash_attention_bwd_dq")
BERT_ABSENT = ("rms_norm", "rms_norm_bwd", "fused_rope", "fused_rope_bwd",
               "bias_dropout_residual_ln")


def bert_train_workload():
    """bench.py section (c2)'s training step on the card: BERT-base with
    dropout 0 in bf16 (random weights from seed 0), AdamW(learning_rate=
    1e-4, multi_precision=True), TrainStep over BertPretrainingCriterion,
    and one batch of BERT_BATCH x BERT_SEQ ids with MLM and NSP labels
    from np.random.RandomState(0). Returns (model, optimizer, step, ids,
    labels)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        BertForPretraining,
        BertPretrainingCriterion,
    )
    from paddle_tpu_torch.optimizer import AdamW

    cfg = bert_cfg()
    model = BertForPretraining(cfg, device="cuda", dtype=torch.bfloat16,
                               generator=seed(0, "cuda"))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    crit = BertPretrainingCriterion()
    step = TrainStep(model, lambda mlm, nsp, lab: crit(mlm, nsp, *lab), opt)
    ids, labels = bert_batch(cfg, BERT_BATCH, BERT_SEQ, 0)
    return model, opt, step, ids, labels


def bert_reference_losses(cfg, state, ids, labels, steps):
    """The same steps from the same weights in f32 on the card through
    the plain versions only: an all-ones attention mask sends attention
    to the composition route (no kernel of the port runs, which the
    launch counts confirm) and AdamW updates f32 weights directly."""
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import (
        BertForPretraining,
        BertPretrainingCriterion,
    )
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.optimizer import AdamW

    model = BertForPretraining(cfg, device="cuda", dtype=torch.float32,
                               generator=torch.Generator(device="cuda"))
    model.load_state_dict(state)
    crit = BertPretrainingCriterion()
    step = TrainStep(model, lambda mlm, nsp, lab: crit(mlm, nsp, *lab),
                     AdamW(learning_rate=1e-4, parameters=model.parameters(),
                           multi_precision=True))
    ones = torch.ones(ids.shape, dtype=torch.int64, device="cuda")
    launch_counts.clear()
    losses = [float(step(ids, labels=labels, attention_mask=ones))
              for _ in range(steps)]
    torch.cuda.synchronize()
    if any(launch_counts.values()):
        raise PhaseFailed(f"bert-train: the f32 reference launched "
                          f"{dict(launch_counts)}")
    return losses


def bert_train_phase(name, smi, peaks):
    """bench.py section (c2): TrainStep on BERT-base at batch 32 x seq
    128, its losses held against an f32 run of the same steps through
    the plain versions (``bert_reference_losses``). Returns the warm-up
    step's launch counts."""
    from paddle_tpu_torch.ops.cuda import launch_counts

    torch.cuda.reset_peak_memory_stats()
    model, _, step, ids, labels = bert_train_workload()
    cfg, (batch, seqlen) = model.config, ids.shape
    n_params = sum(p.numel() for p in model.parameters())
    start = {k: v.to("cpu", torch.float32)
             for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    launch_counts.clear()
    losses = [float(step(ids, labels=labels))]
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    timed, step_ms = timed_steps(step, ids, labels, TRAIN_STEPS)
    losses += timed
    steady = float(np.median(step_ms))
    tokens_per_sec = batch * seqlen / (steady / 1e3)
    flops_per_token = (6 * n_params
                       + 12 * cfg.num_hidden_layers * cfg.hidden_size * seqlen)
    mfu = tokens_per_sec * flops_per_token / peaks[1]
    first_want = float(np.log(cfg.vocab_size) + np.log(2))
    peak_memory = torch.cuda.max_memory_allocated()
    del model, step
    torch.cuda.empty_cache()
    ref = bert_reference_losses(cfg, start, ids, labels, len(losses))
    ref_rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    emit("bert-train", params=n_params, batch=batch, seq=seqlen,
         steps=TRAIN_STEPS, step_ms=step_ms, step_ms_median=steady,
         tokens_per_sec=tokens_per_sec, flops_per_token=flops_per_token,
         mfu=mfu, max_memory_allocated=peak_memory, losses=losses,
         f32_plain_losses=ref, loss_rel=ref_rel,
         loss_tolerance=BERT_TRAJ_REL, launches_per_step=counts, card=name,
         nvidia_smi=smi)
    if not all(np.isfinite(losses)):
        raise PhaseFailed(f"bert-train: a loss is not finite: {losses}")
    if abs(losses[0] - first_want) > 1.0:
        raise PhaseFailed(f"bert-train: first loss {losses[0]:.4f} is more "
                          f"than 1.0 from ln {cfg.vocab_size} + ln 2")
    if not losses[-1] < losses[0]:
        raise PhaseFailed(f"bert-train: loss did not fall: {losses}")
    if not max(ref_rel) <= BERT_TRAJ_REL:
        raise PhaseFailed(f"bert-train: losses {losses} part from the f32 "
                          f"plain run's {ref} by up to {max(ref_rel):.3g} "
                          f"relative")
    want = {k: cfg.num_hidden_layers for k in BERT_KERNELS}
    got = {k: counts.get(k, 0) for k in (*BERT_KERNELS, *BERT_ABSENT)}
    if got != {**want, **{k: 0 for k in BERT_ABSENT}}:
        raise PhaseFailed(f"bert-train: launches per step {got}, want "
                          f"{want} and none of {BERT_ABSENT}")
    return counts


# ---- head dims off 64 and 128, and a LLaMA at Phi-3-mini's widths

# Phi-3-mini-4k-instruct's published config.json
# (huggingface.co/microsoft/Phi-3-mini-4k-instruct): LLaMA's architecture,
# 32 heads of 96 on 32 kv heads, untied embeddings, silu, no biases; bf16
# with random N(0, 0.02) weights from a seed (no checkpoint is loaded).
# Departures: Phi-3 stores q/k/v and gate/up fused, here they are separate
# projections (the same function); its sliding_window of 2047 never binds,
# as every sequence here is at most 1536 tokens.
CFG_PHI3 = dict(vocab_size=32064, hidden_size=3072, intermediate_size=8192,
                num_hidden_layers=32, num_attention_heads=32,
                num_key_value_heads=32, max_position_embeddings=4096,
                rms_norm_eps=1e-5, rope_theta=10000.0)
# phi3-train's depth cut: 4 of the 32 layers (about 0.65 B parameters,
# ~10.4 GB with f32 masters and moments)
PHI3_TRAIN_LAYERS = 4

# the flash kernels at the new widths: (case, b, s, heads, kv heads, d,
# causal), sq == sk
HEAD_DIM_FLASH_CASES = [
    ("phi3 train", 4, 1536, 32, 32, 96, True),
    ("phi3 prefill bucket", 8, 128, 32, 32, 96, True),
    ("qwen3-next full attention", 2, 2048, 16, 2, 256, True),
    ("phi2 widths, padded to 96", 4, 1536, 32, 32, 80, True),
    ("d 32", 2, 256, 4, 4, 32, True),
]
def head_dims_phase(peaks):
    """The kernels at the widths off 64 and 128: the flash kernels at
    HEAD_DIM_FLASH_CASES (Phi-3's training and prefill shapes at 96,
    Qwen3-Next's full-attention widths at 256 on 2 kv heads, Phi-2's 80 on
    the padded route, 32); paged decode at Phi-3's q (8, 32, 96) and at
    q (8, 16, 256) on 2 kv heads in e2's pool layout; RMSNorm at width
    3072 (decode and training rows) and RoPE at head dim 96 (prefill and
    training shapes, both directions). Returns the Phi-3 path's rows by
    kernel for the kernels line."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    gen = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    results = {}
    flash = {case[0]: flash_rows(peaks, gen, *case, causal)
             for *case, causal in HEAD_DIM_FLASH_CASES}
    results["flash_attention[d=96]"] = flash["phi3 prefill bucket"][
        "flash_attention"]
    for kname in FLASH_NAMES[1:]:
        results[f"{kname}[d=96]"] = flash["phi3 train"][kname]
    native, padded = flash["phi3 train"], flash["phi2 widths, padded to 96"]
    emit("head-dims", padded_route={
        kname: dict(padded_ms=padded[kname]["ms"],
                    native_96_ms=native[kname]["ms"],
                    ratio=padded[kname]["ms"] / native[kname]["ms"])
        for kname in FLASH_NAMES})

    for heads, kvh, hd in ((32, 32, 96), (16, 2, 256)):
        rec = paged_row(da, peaks, e2_pool(randn, heads, kvh, hd))
        emit("kernel", name="paged_attention", case=f"d {hd}", **rec)
        if hd == 96:
            results["paged_attention[d=96]"] = rec

    # RMSNorm at Phi-3's width: a decode step's (8, 3072), then the
    # training step's (6144, 3072) forward and backward
    hidden, n = 3072, TRAIN_BATCH * TRAIN_SEQ
    w = (1.0 + 0.1 * randn(hidden, dtype=torch.float32)).to(torch.bfloat16)
    x8 = randn(8, hidden)
    err = rms_norm_variants(rn, x8, w, randn(hidden), "rms_norm(8, 3072)")
    bms, by = bound_ms(2 * 8 * hidden * 2 + hidden * 2 + 8 * 4,
                       4 * 8 * hidden, peaks)
    results["rms_norm[h=3072]"] = rec = dict(
        shape=[8, hidden], max_abs_err=err,
        ms=graph_ms(lambda: rn.rms_norm_rows(x8, w, epsilon=1e-5)),
        plain_ms=graph_ms(lambda: rn.rms_norm_plain(x8, w, epsilon=1e-5)),
        library_ms=graph_ms(lambda: torch.nn.functional.rms_norm(
            x8, (hidden,), w, 1e-5)),
        bound_ms=bms, bound_by=by)
    emit("kernel", name="rms_norm", case="phi3 decode", **rec)
    x, g = randn(n, hidden), randn(n, hidden)
    _, r = rn.rms_norm_rows(x, w, epsilon=1e-5)
    err = max(compare(f"rms_norm_bwd(3072) {nm}", got, want)
              for nm, got, want in zip(("dx", "dw", "db"),
                                       rn.rms_norm_bwd(x, w, r, g),
                                       rn.rms_norm_bwd_plain(x, w, r, g)))
    bms, by = bound_ms(3 * n * hidden * 2 + hidden * 2 + n * 4
                       + 2 * hidden * 2, 11 * n * hidden, peaks)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        yl = torch.nn.functional.rms_norm(xl, (hidden,), wl, 1e-5)
    results["rms_norm_bwd[h=3072]"] = rec = dict(
        shape=[n, hidden], max_abs_err=err,
        ms=graph_ms(lambda: rn.rms_norm_bwd(x, w, r, g), calls=10),
        plain_ms=graph_ms(lambda: rn.rms_norm_bwd_plain(x, w, r, g),
                          calls=10),
        library_ms=graph_ms(lambda: torch.autograd.grad(
            yl, (xl, wl), g, retain_graph=True), calls=10, stream=side),
        bound_ms=bms, bound_by=by)
    emit("kernel", name="rms_norm_bwd", case="phi3 train", **rec)

    # RoPE at head dim 96: the prefill bucket's q, k (8, 128, 32, 96) at
    # arange positions, then the training step's adjoint (4, 1536, 32, 96)
    cos, sin = _rope_tables(96, CFG_PHI3["max_position_embeddings"],
                            CFG_PHI3["rope_theta"], "cuda")
    for rname, (bb, ss), inverse in (("fused_rope", (8, 128), False),
                                     ("fused_rope_bwd", (TRAIN_BATCH,
                                                         TRAIN_SEQ), True)):
        q, k = randn(bb, ss, 32, 96), randn(bb, ss, 32, 96)
        pos = torch.arange(ss, device="cuda", dtype=torch.int32).expand(
            bb, ss).contiguous()
        err = max(compare(f"{rname}(d=96)", got, want) for got, want in zip(
            fo.fused_rope_at(q, k, cos, sin, pos, inverse),
            fo.fused_rope_plain(q, k, cos, sin, pos, inverse)))
        got, none = fo.fused_rope_at(q, None, cos, sin, pos, inverse)
        err = max(err, compare(f"{rname}(d=96, k=None)", got,
                               fo.fused_rope_plain(q, None, cos, sin, pos,
                                                   inverse)[0]))
        if none is not None:
            raise PhaseFailed(f"{rname}: k=None gave a k")
        pairs = q.numel()  # d / 2 pairs a row of q and of k
        bms, by = bound_ms(2 * 2 * q.numel() * 2 + pos.numel() * 4
                           + 2 * ss * 96 * 4, 6 * pairs, peaks)
        results[f"{rname}[d=96]"] = rec = dict(
            shape=list(q.shape), max_abs_err=err,
            ms=graph_ms(lambda: fo.fused_rope_at(q, k, cos, sin, pos, inverse),
                        calls=10),
            plain_ms=graph_ms(lambda: fo.fused_rope_plain(q, k, cos, sin,
                                                          pos, inverse),
                              calls=10),
            library_ms=None, bound_ms=bms, bound_by=by)
        emit("kernel", name=rname, case="phi3", **rec)
    torch.cuda.synchronize()
    return results


PHI3_SERVE_KERNELS = ("rms_norm", "fused_rope", "flash_attention",
                      "paged_attention")


def phi3_serve_phase(name, smi):
    """The 32-layer model at Phi-3-mini's widths behind the engine on e2's
    traffic (``serving_workload``: 8 slots, max_len 512, page 128,
    buckets (32, 128), 24 requests of 8-119 prompt tokens from
    RandomState(7), 64 new tokens each, greedy, segments of 32), the
    engine's default ``decode_megakernel=1``: the megakernel declines head
    dim 96, so the decode layers run unfused (JAX's probe declines this
    model too: its q/k/v/o weights pass its VMEM budget). Launch counts
    are zeroed just before the run and read just after it. First the gate:
    a 2-layer model of the same widths, bf16 on the card against f32 on
    the CPU, a bucket-128 prefill of 2 prompts and 4 decode steps through
    the paged cache, logits within MODEL_REL_L2. Returns the counts."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.ops.cuda import launch_counts

    t0 = time.monotonic()
    small = LlamaConfig(**{**CFG_PHI3, "num_hidden_layers": 2})
    card, cpu = card_and_cpu(small, (20, 21))
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, small.vocab_size, (2, 128))
    steps = rng.randint(0, small.vocab_size, (4, 2))
    got = prefill_decode(card, prompts, steps)
    want = prefill_decode(cpu, prompts, steps)
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    del card, cpu
    torch.cuda.empty_cache()
    gate_s = time.monotonic() - t0
    if not finite or max(rel) > MODEL_REL_L2:
        raise PhaseFailed(f"phi3-serve: 2-layer logits finite={finite}, "
                          f"rel L2 {rel}")

    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaForCausalLM

    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig(**CFG_PHI3)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=seed(0, "cuda"))
    n_params = sum(p.numel() for p in model.parameters())
    vocab = cfg.vocab_size
    eng, reqs = serving_workload(model)
    torch.cuda.synchronize()
    launch_counts.clear()
    outs, stats = eng.run(reqs, max_new_tokens=SERVE_NEW_TOKENS,
                          segment=SERVE_SEGMENT)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    decode_steps = stats["segments"] * SERVE_SEGMENT
    ok = all(len(o) == SERVE_NEW_TOKENS and o.min() >= 0 and o.max() < vocab
             for o in outs)
    finite = all(bool(torch.isfinite(t).all()) for t in eng._ks + eng._vs)
    emit("phi3-serve", layers=cfg.num_hidden_layers, params=n_params,
         head_dim=cfg.head_dim, megakernel=stats["megakernel"],
         requests=len(outs), new_tokens=SERVE_NEW_TOKENS,
         finished=sum(len(o) == SERVE_NEW_TOKENS for o in outs),
         tokens_per_sec=stats["tokens_per_sec"], wall_s=stats["wall_s"],
         useful_tokens=stats["useful_tokens"], segments=stats["segments"],
         decode_steps=decode_steps, mean_occupancy=stats["mean_occupancy"],
         launches=counts,
         paged_attention_per_decode_step=counts.get("paged_attention", 0)
         / decode_steps,
         kernel_launches_per_decode_step=sum(counts.values()) / decode_steps,
         kv_finite=finite, max_memory_allocated=torch.cuda.max_memory_allocated(),
         gate_rel_l2=rel, gate_tolerance=MODEL_REL_L2,
         gate_seconds=gate_s, card=name, nvidia_smi=smi)
    if (not ok or not finite or stats["megakernel"]
            or stats["useful_tokens"] != len(reqs) * SERVE_NEW_TOKENS):
        raise PhaseFailed(f"phi3-serve: outputs ok={ok}, kv finite={finite},"
                          f" megakernel {stats['megakernel']}, tokens "
                          f"{stats['useful_tokens']}")
    missing = [k for k in PHI3_SERVE_KERNELS if counts.get(k, 0) <= 0]
    if missing or counts.get("fused_decode_layer", 0):
        raise PhaseFailed(f"phi3-serve: launches {counts}")
    del eng, model
    torch.cuda.empty_cache()
    return counts


def phi3_train_phase(name, smi, peaks):
    """Phi-3-mini's widths at PHI3_TRAIN_LAYERS layers (a depth cut) through
    ``train_phase``: batch 4 x seq 1536 ids (RandomState(0)), AdamW(1e-4,
    multi_precision, decay 0.01), LlamaPretrainingCriterion, TrainStep,
    a warm-up step and 5 timed steps; then the gradients of a 2-layer
    copy against f32 on the CPU (``grad_phase``). Returns the warm-up
    step's launch counts."""
    counts = train_phase(name, smi, peaks,
                         {**CFG_PHI3, "num_hidden_layers": PHI3_TRAIN_LAYERS},
                         "phi3-train")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    grad_phase(CFG_PHI3, "phi3-grad")
    return counts


# ---- f32: the JAX package's default dtype, through the four serving kernels

# the f32 kernels against their f32 plain versions (allow_tf32 off): both
# sum in f32 in other orders (~1e-6 relative); one bf16 rounding would be
# ~4e-3 off
F32_RTOL = F32_ATOL = 1e-4
# f32-serve's logits, the card (f32 kernels, f32 cuBLAS) against the CPU
# (plain versions): f32 rounding over 12 layers, ~1e-6; a bf16 rounding
# anywhere on the path gives ~1e-2
F32_MODEL_REL_L2 = 1e-3
F32_SERVE_RUNS = 3
# f32-grad, a 2-layer model at the 438M's widths in f32 on the card against
# f32 on the CPU: the loss (and the labels= loss) to 1e-5 relative, each
# gradient to 1e-4 relative L2. f32 sums in other orders give ~1e-6; one
# bf16 rounding on the path gives ~1e-3 and a TF32 one ~3e-4
F32_LOSS_REL, F32_GRAD_REL_L2 = 1e-5, 1e-4
F32_KERNELS = ("rms_norm[f32]", "fused_rope[f32]", "flash_attention[f32]",
               "paged_attention[f32]")
# the flash forward in f32 beyond e2's prefill: (case, b, s, heads, kv
# heads, d), causal, sq == sk
F32_FLASH_CASES = [
    ("training shape", 4, 1536, 12, 12, 128),
    ("phi3 prefill bucket", 8, 128, 32, 32, 96),
    ("qwen3-next full attention", 2, 2048, 16, 2, 256),
]


def f32_compare(name, got, want):
    """``compare`` at the f32 gate, both sides f32."""
    if got.dtype != torch.float32 or want.dtype != torch.float32:
        raise PhaseFailed(f"{name}: {got.dtype} against {want.dtype}")
    return compare(name, got, want, atol=F32_ATOL, rtol=F32_RTOL)


def f32_flash_row(fa, peaks, gen, case, b, s, h, kvh, d, calls=3):
    """The f32 flash forward at one causal shape against its plain
    version (out and lse), timed beside its bound (bytes, or flops at the
    f32 FMA rate), the plain version and F.scaled_dot_product_attention on
    the same f32 inputs (TF32 off)."""
    q = torch.randn((b, s, h, d), generator=gen, device="cuda")
    k = torch.randn((b, s, kvh, d), generator=gen, device="cuda")
    v = torch.randn((b, s, kvh, d), generator=gen, device="cuda")
    tag = f"flash_attention[f32]({case})"
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, True)
    err = max(f32_compare(tag, out, pout), f32_compare(tag + " lse", lse,
                                                       plse))
    del pout, plse
    flops = 4 * d * b * h * s * (s + 1) // 2
    bms, by = bound_ms(4 * q.numel() * 4 + lse.numel() * 4, flops, peaks,
                       flop_rate=peaks[2])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec = dict(case=case, shape=[b, s, h, d], kv_heads=kvh, causal=True,
               max_abs_err=err,
               ms=graph_ms(lambda: fa.flash_attention_fwd(q, k, v, True),
                           calls=calls, replays=3),
               plain_ms=graph_ms(lambda: fa.flash_attention_fwd_plain(
                   q, k, v, True), calls=2, replays=2),
               library_ms=graph_ms(
                   lambda: torch.nn.functional.scaled_dot_product_attention(
                       qt, kt, vt, is_causal=True, enable_gqa=kvh != h),
                   calls=calls, replays=3),
               bound_ms=bms, bound_by=by)
    rec.update(rates(flops, rec["ms"], bms))
    emit("f32-kernel", name="flash_attention[f32]", **rec)
    return rec


def f32_kernel_phase(peaks):
    """The four serving kernels in f32 at e2's shapes against their f32
    plain versions within F32_ATOL + F32_RTOL |plain| (lse too), each
    timed beside its bound, the plain version and a library call where
    one computes the same function: RMSNorm at (8, 1536) and (1024, 1536)
    (all four affine variants gated), RoPE on the bucket-128 prefill's q,
    k (8, 128, 12, 128) and a decode step's, the flash forward at (8, 128,
    12, 128) causal (plus F32_FLASH_CASES, and the segment kernel with a
    segment missing from the keys: those rows exactly 0, lse -1e30), paged
    decode in e2's pool. Returns the e2 rows by kernel name."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    f32 = torch.float32
    gen = torch.Generator(device="cuda").manual_seed(10)

    def randn(*shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    hidden, heads, hd = 1536, 12, 128
    results = {}
    w = 1.0 + 0.1 * randn(hidden)
    bias = 0.1 * randn(hidden)
    for n in (8, 1024):
        x = randn(n, hidden)
        err = 0.0
        for wt, bt in ((w, None), (w, bias), (None, bias), (None, None)):
            y, r = rn.rms_norm_rows(x, wt, bt, epsilon=1e-6)
            py, pr = rn.rms_norm_plain(x, wt, bt, epsilon=1e-6)
            err = max(err, f32_compare(f"rms_norm[f32]({n})", y, py))
            if (r - pr).abs().max().item() > 1e-5 * pr.abs().max().item():
                raise PhaseFailed(f"rms_norm[f32]({n}): per-row r disagrees")
        bms, by = bound_ms(2 * n * hidden * 4 + hidden * 4 + n * 4,
                           4 * n * hidden, peaks, flop_rate=peaks[2])
        rec = dict(
            shape=[n, hidden], max_abs_err=err,
            ms=graph_ms(lambda: rn.rms_norm_rows(x, w, epsilon=1e-6)),
            plain_ms=graph_ms(lambda: rn.rms_norm_plain(x, w, epsilon=1e-6)),
            library_ms=graph_ms(lambda: torch.nn.functional.rms_norm(
                x, (hidden,), w, 1e-6)),
            bound_ms=bms, bound_by=by)
        emit("f32-kernel", name="rms_norm[f32]", **rec)
        if n == 8:
            results["rms_norm[f32]"] = rec

    cos, sin = _rope_tables(hd, CFG_438M["max_position_embeddings"], 10000.0,
                            "cuda")
    g_, s_ = 8, 128
    q, k, v = (randn(g_, s_, heads, hd) for _ in range(3))
    pos = torch.arange(s_, device="cuda", dtype=torch.int32).expand(
        g_, s_).contiguous()
    err = 0.0
    for inverse in (False, True):
        for got, want in zip(fo.fused_rope_at(q, k, cos, sin, pos, inverse),
                             fo.fused_rope_plain(q, k, cos, sin, pos,
                                                 inverse)):
            err = max(err, f32_compare("fused_rope[f32]", got, want))
    dpos = torch.randint(0, 183, (8, 1), generator=gen, device="cuda",
                         dtype=torch.int32)
    dq, dk = randn(8, 1, heads, hd), randn(8, 1, heads, hd)
    for got, want in zip(fo.fused_rope_at(dq, dk, cos, sin, dpos),
                         fo.fused_rope_plain(dq, dk, cos, sin, dpos)):
        err = max(err, f32_compare("fused_rope[f32](decode)", got, want))
    bms, by = bound_ms(2 * 2 * q.numel() * 4 + pos.numel() * 4
                       + 2 * s_ * hd * 4, 6 * q.numel(), peaks,
                       flop_rate=peaks[2])
    results["fused_rope[f32]"] = rec = dict(
        shape=list(q.shape), max_abs_err=err,
        ms=graph_ms(lambda: fo.fused_rope_at(q, k, cos, sin, pos)),
        plain_ms=graph_ms(lambda: fo.fused_rope_plain(q, k, cos, sin, pos)),
        library_ms=None, bound_ms=bms, bound_by=by)
    emit("f32-kernel", name="fused_rope[f32]", **rec)

    results["flash_attention[f32]"] = f32_flash_row(
        fa, peaks, gen, "e2 prefill bucket", g_, s_, heads, heads, hd,
        calls=20)
    for case in F32_FLASH_CASES:
        f32_flash_row(fa, peaks, gen, *case)
    # segments: a (q_ids, k_ids) pair whose segment 3 has no key
    rng = np.random.RandomState(5)
    qi = np.sort(rng.randint(0, 5, (g_, s_)), 1)
    ki = np.sort(rng.randint(0, 5, (g_, s_)), 1)
    ki[ki == 3] = 4
    q_seg, k_seg = (torch.tensor(a, dtype=torch.int32, device="cuda")
                    for a in (qi, ki))
    out, lse = fa.flash_attention_fwd(q, k, v, True, q_seg, k_seg)
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, True, q_seg, k_seg)
    none = (q_seg == 3)[:, None, :].expand_as(lse)
    seg_err = max(f32_compare("flash_attention[seg][f32]", out, pout),
                  f32_compare("flash_attention[seg][f32] lse", lse, plse))
    if not (bool(none.any()) and bool((lse[none] == -1e30).all())
            and bool((out.transpose(1, 2)[none] == 0).all())):
        raise PhaseFailed("flash_attention[seg][f32]: rows with no key are "
                          "not 0 with lse -1e30")
    emit("f32-kernel", name="flash_attention[seg][f32]",
         shape=[g_, s_, heads, hd], max_abs_err=seg_err,
         rows_with_no_key=int(none[:, 0].sum()))

    pool = e2_pool(randn, heads, heads, hd)
    results["paged_attention[f32]"] = rec = paged_row(da, peaks, pool,
                                                      f32=True)
    emit("f32-kernel", name="paged_attention[f32]", **rec)
    torch.cuda.synchronize()
    return results


# the f32 backward kernels: (case, b, s, heads, kv heads, d, causal); the
# first is the f32-train path's shape, the kernels line's row
F32_BWD_CASES = [
    ("training shape", 4, 1536, 12, 12, 128, True),
    ("gqa", 2, 512, 12, 4, 128, True),
    ("bert shape", 32, 128, 12, 12, 64, False),
    ("phi3 training", 4, 1536, 32, 32, 96, True),
    ("qwen3-next full attention", 2, 2048, 16, 2, 256, True),
    ("padded 80", 4, 1536, 32, 32, 80, True),
]


def f32_bwd_rows(fa, peaks, gen, case, b, s, h, kvh, d, causal, seg=None):
    """f32 dK/dV and dQ at one shape (sq == sk) against their plain
    version from the f32 forward kernel's out and lse, within the f32
    gate; each timed (a CUDA graph of 3 calls) beside its bound (bytes, or
    flops at the f32 FMA rate over the visible pairs, counted from the ids
    with segments), the plain backward and ``autograd.grad`` through
    ``F.scaled_dot_product_attention`` in f32 (with a dense boolean mask
    for segments). ``seg`` is one (b, s) id array shared by both sides.
    Returns {kernel name: row}."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    tag = f"[f32]({case})"
    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, seg, seg)
    delta = fa._delta(out, do)
    got_dk, got_dv = fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                 causal, seg, seg)
    got_dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, seg,
                                       seg)
    want_dq, want_dk, want_dv = fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal, seg, seg)
    errs = {"flash_attention_bwd_dkdv": max(
        f32_compare("dk" + tag, got_dk, want_dk),
        f32_compare("dv" + tag, got_dv, want_dv)),
        "flash_attention_bwd_dq": f32_compare("dq" + tag, got_dq, want_dq)}
    del want_dq, want_dk, want_dv, got_dq, got_dk, got_dv
    torch.cuda.empty_cache()
    mask = None
    if seg is None:
        pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    else:
        one, keep = seg_pairs(fa, seg, seg, s, s, causal)
        pairs, mask = one * h, keep
    io = (q.numel() + 2 * k.numel() + do.numel()) * 4 + 2 * lse.numel() * 4
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ql, kl, vl = (t.detach().requires_grad_() for t in (qt, kt, vt))
        ol = torch.nn.functional.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=kvh != h)
    dol = do.transpose(1, 2)
    lib = graph_ms(lambda: torch.autograd.grad(
        ol, (ql, kl, vl), dol, retain_graph=True), calls=3, replays=3,
        stream=side)
    del ol, ql, kl, vl
    plain = graph_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, causal, seg, seg), calls=2, replays=2)
    kernels = {
        "flash_attention_bwd_dkdv": (
            lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                causal, seg, seg),
            8 * d * pairs, io + 2 * k.numel() * 4),
        "flash_attention_bwd_dq": (
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              causal, seg, seg),
            6 * d * pairs, io + q.numel() * 4)}
    route = ("native" if d in fa.HEAD_DIMS
             else f"padded to {fa.native_head_dim(d)}")
    rows = {}
    for kname, (fn, flops, nb) in kernels.items():
        name = kname + ("" if seg is None else "[seg]") + "[f32]"
        bms, by = bound_ms(nb, flops, peaks, flop_rate=peaks[2])
        rec = dict(case=case, shape=[b, s, h, d], kv_heads=kvh,
                   causal=causal, route=route, pairs=pairs,
                   max_abs_err=errs[kname],
                   ms=graph_ms(fn, calls=3, replays=3), plain_ms=plain,
                   library_ms=lib, bound_ms=bms, bound_by=by)
        rec.update(rates(flops, rec["ms"], bms))
        emit("f32-train-kernel", name=name, **rec)
        rows[name] = rec
    torch.cuda.synchronize()
    return rows


def f32_train_kernel_phase(peaks):
    """The f32 training path's backward kernels against their f32 plain
    versions within F32_ATOL + F32_RTOL |plain|, each timed beside its
    bound, the plain version and a library call: the RMSNorm backward at
    (6144, 1536) and (1024, 1536) (``autograd.grad`` through F.rms_norm in
    f32), the RoPE adjoint on (dq, dk) (4, 1536, 12, 128), dK/dV and dQ at
    F32_BWD_CASES and, with segments, at the varlen shape (1, 6144, 12,
    128) causal with the varlen phase's packed documents. Returns the
    training shape's rows by kernel name."""
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    b, s, heads, hd, hidden = 4, 1536, 12, 128, 1536
    results = {}
    w = 1.0 + 0.1 * randn(hidden)
    for n in (b * s, 1024):
        x, g = randn(n, hidden), randn(n, hidden)
        _, r = rn.rms_norm_rows(x, w, epsilon=1e-6)
        err = max(f32_compare(f"rms_norm_bwd[f32] {nm}({n})", got, want)
                  for nm, got, want in zip(
                      ("dx", "dw", "db"), rn.rms_norm_bwd(x, w, r, g),
                      rn.rms_norm_bwd_plain(x, w, r, g)))
        nb = 3 * n * hidden * 4 + hidden * 4 + n * 4 + 2 * hidden * 4
        bms, by = bound_ms(nb, 11 * n * hidden, peaks, flop_rate=peaks[2])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
            yl = torch.nn.functional.rms_norm(xl, (hidden,), wl, 1e-6)
        rec = dict(
            shape=[n, hidden], max_abs_err=err,
            ms=graph_ms(lambda: rn.rms_norm_bwd(x, w, r, g), calls=10),
            plain_ms=graph_ms(lambda: rn.rms_norm_bwd_plain(x, w, r, g),
                              calls=10),
            library_ms=graph_ms(lambda: torch.autograd.grad(
                yl, (xl, wl), g, retain_graph=True), calls=10, stream=side),
            bound_ms=bms, bound_by=by)
        emit("f32-train-kernel", name="rms_norm_bwd[f32]", **rec)
        if n == b * s:
            results["rms_norm_bwd[f32]"] = rec

    cos, sin = _rope_tables(hd, CFG_438M["max_position_embeddings"], 10000.0,
                            "cuda")
    dq, dk = randn(b, s, heads, hd), randn(b, s, heads, hd)
    pos = torch.arange(s, device="cuda", dtype=torch.int32).expand(
        b, s).contiguous()
    err = max(f32_compare("fused_rope_bwd[f32]", got, want)
              for got, want in zip(
                  fo.fused_rope_at(dq, dk, cos, sin, pos, inverse=True),
                  fo.fused_rope_plain(dq, dk, cos, sin, pos, inverse=True)))
    bms, by = bound_ms(2 * 2 * dq.numel() * 4 + pos.numel() * 4
                       + 2 * s * hd * 4, 6 * dq.numel(), peaks,
                       flop_rate=peaks[2])
    results["fused_rope_bwd[f32]"] = rec = dict(
        shape=list(dq.shape), max_abs_err=err,
        ms=graph_ms(lambda: fo.fused_rope_at(dq, dk, cos, sin, pos,
                                             inverse=True), calls=10),
        plain_ms=graph_ms(lambda: fo.fused_rope_plain(
            dq, dk, cos, sin, pos, inverse=True), calls=10),
        library_ms=None, bound_ms=bms, bound_by=by)
    emit("f32-train-kernel", name="fused_rope_bwd[f32]", **rec)
    del dq, dk, x, g
    torch.cuda.empty_cache()

    for i, case in enumerate(F32_BWD_CASES):
        rows = f32_bwd_rows(fa, peaks, gen, *case)
        if i == 0:
            results.update(rows)
        torch.cuda.empty_cache()
    ids, lens = packed_ids(1, VARLEN_TOTAL, 11)
    seg = torch.tensor(ids, dtype=torch.int32, device="cuda")
    f32_bwd_rows(fa, peaks, gen, f"varlen, {len(lens)} documents", 1,
                 VARLEN_TOTAL, heads, heads, hd, True, seg)
    torch.cuda.empty_cache()
    emit("f32-train-kernel", seconds=time.monotonic() - t0)
    return results


def f32_train_phase(name, smi, peaks):
    """The 438M LLaMA in f32 (the JAX model's default) trained on the card:
    first ``grad_phase`` in f32 (a 2-layer copy's loss and gradients
    against f32 on the CPU, F32_LOSS_REL and F32_GRAD_REL_L2, only [f32]
    launches), then ``train_phase`` in f32 at batch 4 x seq 1536 (full
    width and depth), whose step must launch the seven [f32] training
    kernels at their counts and no bf16 one. Returns the step's launch
    counts."""
    grad_phase(phase="f32-grad", dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts = train_phase(name, smi, peaks, phase="f32-train",
                         dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return counts


def f32_serve_arm(model, name, smi, arm, decode_megakernel):
    """One e2 run (``serving_workload``) on ``model``; launch counts
    zeroed just before the run and read just after it. Gated: all 24 requests finish with 64
    tokens, the KV pools finite, the decode layers unfused, the four
    serving kernels launched in the model's dtype and none in the other.
    Returns (outputs, record, engine, prompts)."""
    from paddle_tpu_torch.ops.cuda import launch_counts

    tag = "[f32]" if model.dtype == torch.float32 else ""
    vocab = model.config.vocab_size
    eng, prompts = serving_workload(model, decode_megakernel)
    torch.cuda.synchronize()
    launch_counts.clear()
    outs, stats = eng.run(prompts, max_new_tokens=SERVE_NEW_TOKENS,
                          segment=SERVE_SEGMENT)
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    steps = stats["segments"] * SERVE_SEGMENT
    finished = sum(bool(len(o) == SERVE_NEW_TOKENS and o.min() >= 0
                        and o.max() < vocab) for o in outs)
    finite = all(bool(torch.isfinite(t).all()) for t in eng._ks + eng._vs)
    rec = dict(arm=arm, dtype=str(model.dtype), megakernel=stats["megakernel"],
               requests=len(outs), finished=finished,
               tokens_per_sec=stats["tokens_per_sec"], wall_s=stats["wall_s"],
               useful_tokens=stats["useful_tokens"], decode_steps=steps,
               launches=counts,
               kernel_launches_per_decode_step=sum(counts.values()) / steps,
               kv_finite=finite, card=name, nvidia_smi=smi)
    emit("f32-serve", **rec)
    wrong = [k for k in counts if k.endswith("[f32]") != bool(tag)]
    missing = [k + tag for k in SERVE_UNFUSED_KERNELS
               if counts.get(k + tag, 0) <= 0]
    if (finished != len(prompts) or not finite or stats["megakernel"]
            or missing or wrong):
        raise PhaseFailed(f"f32-serve ({arm}): finished {finished}, kv "
                          f"finite {finite}, megakernel "
                          f"{stats['megakernel']}, launches {counts}")
    return outs, rec, eng, prompts


def f32_serve_phase(name, smi):
    """The 438M LLaMA in f32 (the JAX model's default) behind the engine on
    e2's traffic with its default decode_megakernel=1 (the megakernel
    takes bf16 only, so the decode layers run unfused, as JAX's probe
    declines this model in f32), F32_SERVE_RUNS runs, each beside a run of
    the bf16 unfused arm (decode_megakernel=0, the same weights rounded to
    bf16) in turns. First the
    gate: the f32 model's logits on the card (a bucket-128 prefill of 2
    prompts and 4 decode steps) within F32_MODEL_REL_L2 of the same
    weights on the CPU. Reports tokens/s, launches per decode step, peak
    memory, the device's idle share (one more run of each under
    torch.profiler) and how far the f32 and bf16 greedy streams agree.
    Returns the first f32 run's launch counts."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.monotonic()
    cfg = LlamaConfig(**CFG_438M)
    card, cpu = card_and_cpu(cfg, (30, 31), dtype=torch.float32)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (2, 128))
    steps = rng.randint(0, cfg.vocab_size, (4, 2))
    got = prefill_decode(card, prompts, steps)
    want = prefill_decode(cpu, prompts, steps)
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
             for a, b in zip(got, want)]
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    del cpu
    emit("f32-serve", gate_rel_l2=rel, gate_tolerance=F32_MODEL_REL_L2,
         gate_argmax_agree=agree, gate_seconds=time.monotonic() - t0)
    if not finite or max(rel) > F32_MODEL_REL_L2:
        raise PhaseFailed(f"f32-serve: 438M f32 logits finite={finite}, rel "
                          f"L2 {rel}")

    bf16 = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                            generator=seed(32, "cuda"))
    bf16.load_state_dict(card.state_dict())  # the f32 weights, rounded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, engines = {"f32": [], "bf16": []}, {}
    for _ in range(F32_SERVE_RUNS):
        for arm, model, mk in (("f32", card, 1), ("bf16", bf16, 0)):
            outs, rec, eng, prompts = f32_serve_arm(model, name, smi, arm,
                                                    mk)
            runs[arm].append((outs, rec))
            engines.setdefault(arm, (eng, prompts))
    peak = torch.cuda.max_memory_allocated()
    f32_outs = runs["f32"][0][0]
    summary = {}
    for arm, (eng, prompts) in engines.items():
        recs = [r for _, r in runs[arm]]
        first = recs[0]
        prof = device_profile(lambda: eng.run(
            prompts, max_new_tokens=SERVE_NEW_TOKENS,
            segment=SERVE_SEGMENT), steps=1)
        summary[arm] = dict(
            tokens_per_sec=[r["tokens_per_sec"] for r in recs],
            kernel_launches_per_decode_step=first[
                "kernel_launches_per_decode_step"],
            device_idle_share=prof["device_idle_share"],
            device_busy_ms_per_decode_step=prof["device_busy_ms_per_call"]
            / first["decode_steps"],
            wall_ms_per_decode_step=prof["wall_ms_per_call"]
            / first["decode_steps"],
            top_kernels=prof["top_kernels"][:5])
    repeat = all(all((a == b).all() for a, b in zip(f32_outs, outs))
                 for outs, _ in runs["f32"][1:])
    agree_tokens = [float((a == b).mean())
                    for a, b in zip(f32_outs, runs["bf16"][0][0])]
    counts = runs["f32"][0][1]["launches"]
    emit("f32-serve", summary=summary, max_memory_allocated=peak,
         f32_launches=counts, f32_runs_token_identical=bool(repeat),
         f32_bf16_token_agreement=float(np.mean(agree_tokens)),
         f32_bf16_streams_identical=sum(a == 1.0 for a in agree_tokens),
         seconds=time.monotonic() - t0, card=name, nvidia_smi=smi)
    del card, bf16, runs, engines
    torch.cuda.empty_cache()
    return counts


KERNELS = [  # name, source, the Pallas kernel it replaces, the path
    ("rms_norm", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/ops/pallas/rms_norm.py:59", "serving"),
    ("fused_rope", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:47", "serving"),
    ("flash_attention", "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:86", "serving"),
    ("paged_attention", "paddle_tpu_torch/csrc/decode_attention.cu",
     "paddle_tpu/ops/pallas/decode_attention.py:58", "serving"),
    ("rms_norm_bwd", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/ops/pallas/rms_norm.py:100", "train"),
    ("fused_rope_bwd", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:47", "train"),
    ("flash_attention_bwd_dkdv", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:181", "train"),
    ("flash_attention_bwd_dq", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:245", "train"),
    ("fused_decode_layer", "paddle_tpu_torch/csrc/decode_megakernel.cu",
     "paddle_tpu/ops/pallas/decode_megakernel.py:189", "serving_fused"),
    ("bias_dropout_residual_ln",
     "paddle_tpu_torch/csrc/bias_dropout_residual_ln.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:112", "incubate"),
    # the masked=True instantiations of the three flash kernels
    ("flash_attention[seg]", "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:86", "varlen"),
    ("flash_attention_bwd_dkdv[seg]",
     "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:181", "varlen"),
    ("flash_attention_bwd_dq[seg]",
     "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:245", "varlen"),
    # the Phi-3 paths' kernels at their widths (head dim 96, hidden 3072),
    # the launches counted under the kernel's own name (last field)
    ("flash_attention[d=96]", "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:86", "phi3-serve",
     "flash_attention"),
    ("paged_attention[d=96]", "paddle_tpu_torch/csrc/decode_attention.cu",
     "paddle_tpu/ops/pallas/decode_attention.py:58", "phi3-serve",
     "paged_attention"),
    ("rms_norm[h=3072]", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/ops/pallas/rms_norm.py:59", "phi3-serve", "rms_norm"),
    ("fused_rope[d=96]", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:47", "phi3-serve", "fused_rope"),
    ("flash_attention_bwd_dkdv[d=96]",
     "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:181", "phi3-train",
     "flash_attention_bwd_dkdv"),
    ("flash_attention_bwd_dq[d=96]",
     "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:245", "phi3-train",
     "flash_attention_bwd_dq"),
    ("rms_norm_bwd[h=3072]", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/ops/pallas/rms_norm.py:100", "phi3-train", "rms_norm_bwd"),
    ("fused_rope_bwd[d=96]", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:47", "phi3-train",
     "fused_rope_bwd"),
    # the f32 instantiations of the four serving kernels (f32-serve)
    ("rms_norm[f32]", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/ops/pallas/rms_norm.py:59", "f32-serve"),
    ("fused_rope[f32]", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:47", "f32-serve"),
    ("flash_attention[f32]", "paddle_tpu_torch/csrc/flash_attention_f32.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:86", "f32-serve"),
    ("paged_attention[f32]", "paddle_tpu_torch/csrc/decode_attention.cu",
     "paddle_tpu/ops/pallas/decode_attention.py:58", "f32-serve"),
    # the f32 backward kernels and the RoPE adjoint in f32 (f32-train)
    ("rms_norm_bwd[f32]", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/ops/pallas/rms_norm.py:100", "f32-train"),
    ("fused_rope_bwd[f32]", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:47", "f32-train"),
    ("flash_attention_bwd_dkdv[f32]",
     "paddle_tpu_torch/csrc/flash_attention_bwd_f32.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:181", "f32-train"),
    ("flash_attention_bwd_dq[f32]",
     "paddle_tpu_torch/csrc/flash_attention_bwd_f32.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:245", "f32-train"),
]


def main():
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from paddle_tpu_torch.ops.cuda import _build

    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    peak_key, peaks = peaks_for(name)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc[-1], card=name, nvidia_smi=smi,
         peaks={"table": peak_key, "bytes_per_s": peaks[0],
                "bf16_flops": peaks[1]})

    t0 = time.monotonic()
    _build.library()
    log = _build.library_file.with_suffix(".log")
    usage = ([ln.strip() for ln in log.read_text().splitlines()
              if "registers" in ln or "spill" in ln
              or "Compiling entry" in ln]
             if log.exists() else [])
    emit("build", seconds=time.monotonic() - t0,
         nvcc_seconds=_build.build_seconds, ptxas=usage)
    torch.cuda.synchronize()

    results = kernel_phase(peaks)
    results.update(megakernel_phase(peaks))
    results.update(train_kernel_phase(peaks))
    results.update(bdrln_phase(peaks))
    bert_flash_phase(peaks)
    flash_edge_phase()
    flash_segments_phase(peaks)
    seg_kernels, varlen_counts = varlen_phase(peaks)
    results.update(seg_kernels)
    model = model_phase()
    torch.cuda.synchronize()
    counts = serving_phase(model, name, smi)
    counts["varlen"] = varlen_counts
    del model
    torch.cuda.empty_cache()
    grad_phase()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts["train"] = train_phase(name, smi, peaks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts["incubate"] = incubate_phase()
    bert_grad_phase()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts["bert-train"] = bert_train_phase(name, smi, peaks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    results.update(head_dims_phase(peaks))
    flash_edge_phase(widths=(96, 256))
    counts["phi3-serve"] = phi3_serve_phase(name, smi)
    torch.cuda.synchronize()
    counts["phi3-train"] = phi3_train_phase(name, smi, peaks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    results.update(f32_kernel_phase(peaks))
    counts["f32-serve"] = f32_serve_phase(name, smi)
    torch.cuda.synchronize()
    t_f32 = time.monotonic()
    results.update(f32_train_kernel_phase(peaks))
    counts["f32-train"] = f32_train_phase(name, smi, peaks)
    emit("f32-train", phases_seconds=time.monotonic() - t_f32)

    line = []
    for kname, source, replaces, path, *counter in KERNELS:
        r = results[kname]
        launches = counts[path].get(counter[0] if counter else kname, 0)
        if launches <= 0:
            raise PhaseFailed(f"{kname} was not launched on the {path} path")
        line.append({"name": kname, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    emit("total", seconds=time.monotonic() - t_start)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
