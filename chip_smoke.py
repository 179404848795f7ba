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
            alone and neither, also at widths 100 and 4096, and the wide
            kernel (a block a row) at Mistral-Large-2's hidden 12288 on a
            decode step's 8 rows and a prefill's 1024 (also with its
            inputs out of L2); RoPE both
            ways on the prefill's q, k (8, 128, 12, 128) and a decode
            step's (8, 1, 12, 128), the decode step timed apart), the training
            path's backward kernels and the forward kernels at the
            training shape, (4, 1536) tokens of the 438M model (the
            RMSNorm forward also timed with a bias; the backward's two
            launches, its rows and the sum of their partials, also timed
            apart by torch.profiler), plus a GQA case for flash dK/dV and
            dQ. Max abs error within the stated tolerance, device time
            per call (a CUDA graph of many calls, so host launch cost is
            excluded), the plain
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
            forward, dK/dV and dQ, within the same gate. The decode
            megakernel (csrc/decode_megakernel.cuh) at the e2 decode shape
            at MK_CASES' seven widths: the 438M layer on 12 and on 4 kv
            heads (bf16 h_mid at the one-rounding gate), in f32 (the f32
            gate below), and in bf16 Phi-3-mini's widths (32 heads of 96),
            Phi-2's (32 of 80), 16 heads of 256 on 2 kv heads and a group
            of 16 (32 heads of 128 on 2 kv heads), h_mid by
            ``h_mid_gate``; each timed warm (one layer, graph) and
            rotating over layers whose weights exceed 4x the L2, the
            bound set against the rotating time. Paged decode (one
            kernel, each row's tokens split across blocks by
            ``split_plan``) at groups 12 (q (8, 96, D) on 8 kv heads,
            Mistral-Large-2), 16 (128 on 8) and 32 (32 on 1), at D = 128
            and 64, bf16 and f32, in e2's pool layout and lengths. Every
            paged row also holds the kernel to its own bits: two calls,
            and a CUDA graph replay against an eager call, bit for bit.
            Then paged-edge: paged decode at lengths 0, 1, every multiple
            of 32 +-1 up to the walk's cap of 512 (each split boundary of
            any plan), the cap and past it (clamped), with dump-page
            tails, at e2's heads, group 12, D = 96, D = 256 on 2 kv
            heads and D = 100 (the element path) in bf16 and e2's heads
            and D = 36 in f32, gated and bit for bit the same way.
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
5a. adam-kernel  the multi-tensor Adam kernel (csrc/multi_tensor_adam.cu)
            against its plain version through the optimizer (the same
            groups, clips and state; ``plain_optimizer``), 3 steps on
            seeded gradients, on five parameter lists: the 438M's under
            AdamW(multi_precision) (bf16, f32 masters and moments), the
            1.28B's under bench.py (b2)'s AdamW (acc_dtype bf16: bf16
            moment1), the 438M's in f32 (no master), in f32 with
            acc_dtype bf16, and odd sizes in bf16 under Adam without
            multi_precision (coupled decay, two groups, a global-norm
            clip that bites in each); f32 values within 1e-6 relative,
            bf16 stores within one bf16 ulp, one launch a step; then the
            launch alone: a CUDA graph replay against the eager launch
            bit for bit, its time (a graph), the plain version's, its
            bound (bytes an element: 28 with f32 moments and masters) and
            ``torch._fused_adamw_`` over the same elements in f32.
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
            greedy, segments of 32, the engine warmed by ``warmup()`` (the
            decode segment's CUDA graph captured) and two requests; in two
            arms on the same model and prompts, unfused
            (``decode_megakernel=0``) and fused (the default), both on the
            default engine: pipelined, each decode segment one graph
            replay. Launch counts are zeroed just before each arm's run
            and read just after it (a replay credits the launches its
            capture recorded): the unfused arm must launch the four
            forward kernels, the fused arm the megakernel 12 times per
            decode step and paged decode never. Both arms' tokens/s and
            how far their greedy streams agree are printed, not gated.
7b. serving-captured  the default engine against the eager serial
            reference (the serial scheduler, each decode step's launches
            from Python), in turns, twice each, on e2's
            traffic: e2 fused and unfused here, and in the phases below
            phi3-serve fused, mistral-large-serve and f32-serve fused.
            Each run's tokens/s, wall ms and launches a decode step;
            gated: every greedy stream identical to the eager run's.
7a. kv-e9   bench.py section (e9) and the admission path on the 438M,
            on the engine's default (pipelined) scheduler:
            (a) the gate: a 2-layer model at the 438M's widths behind an
            engine, a 300-token prompt in chunks of 128 at bases 0 and
            128 and a padded final chunk at 256, then a prompt sharing its
            first 200 tokens resumed at base 200 after a copy-on-write
            page copy; each dispatch's logits against a cache-free f32
            CPU forward within MODEL_REL_L2 (bf16) and F32_MODEL_REL_L2
            (f32, TF32 off). (b) e9's dynamic pool: 48 prompts of 6, 10,
            18 or 40 tokens from np.random.RandomState(31), 16 new each,
            max_len 512, page 128, buckets (16, 64), segments of 4, on 4
            slots owning 16 pages statically and on 16 slots sharing them;
            gated: every request ok, peak concurrency at least 2x the
            static arm's (bench's kv_admit_gain), every page back in the
            pool or the prefix cache, pools finite. (c) e9's prefix sweep:
            24 prompts of a 384-token system prompt and 12 tokens of their
            own, 4 slots, max_len 1024, a seeding request, then the batch
            timed with the cache off (chunked prefill) and on (resumes);
            gated as bench: hit rate > 0, tokens saved >= 23 x 384,
            speedup >= 1. (d) 16 long, shared and short prompts
            (kv_long_traffic) with 128 new tokens on 8 slots of 1536 tokens
            over 32 pages, segments of 32, fused: every request ok at full
            length; preemptions, copy-on-write copies, prefix tokens saved
            and chunk dispatches all > 0; the RMSNorm, RoPE, flash and
            megakernel launched, paged decode not; the same traffic
            unfused (paged decode launched, the megakernel not, the same
            counters and dispatches); every stream of both arms equal to
            a roomy fused engine's without the prefix cache up to where
            they part, and there both picks within 2 x MODEL_REL_L2 x the
            logits' std of a cache-free forward's best (a bf16 tie); then the wall ms of a chunk, a resume, a prefill and a page
            copy at the 438M, and the chunk's gathered dense-mask
            attention beside the flash forward on the same keys. (e) RoPE
            over a chunk at per-row positions to 1535, paged decode at
            lengths to 1536 and the megakernel at depths to 1535 (12 table
            columns and a scratch column), each against its plain version
            and timed.
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
9a. llama-large-train  bench.py section (b2) as written: the 1.28B LLaMA
            (CFG_LLAMA_LARGE: hidden 2048, 24 layers, 16 heads, use_
            recompute, tied embeddings) in bf16, AdamW(lr 1e-4,
            multi_precision, acc_dtype="bfloat16"), TrainStep(model,
            lambda loss: loss, opt) stepped as step(ids, None, None, ids),
            batch 2 x seq 2048 ids from np.random.RandomState(0): first a
            2-layer copy's loss and gradients with and without recompute,
            bit for bit; then a warm-up step with its launches counted
            and 4 steps timed by CUDA events: step ms, tokens/s, MFU,
            peak memory, losses (finite, falling, the first within 1.0
            of ln 32000); gated on every training kernel's exact count a
            step (flash forward and RoPE 2 L, RMSNorm forward 4 L + 1
            with recompute's second forward, the backward kernels L or
            2 L + 1, the update once) and nothing else.
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
            only, the update's included), and one step's launches: flash
            forward, dK/dV and dQ 12 each, the update once; RMSNorm and
            RoPE none.
13. head-dims  the kernels at the widths off 64 and 128, each against
            its plain version within the kernel gate and timed beside its
            bound, the plain version and F.scaled_dot_product_attention:
            flash forward, dK/dV and dQ at Phi-3-mini's (4, 1536, 32, 96)
            and (8, 128, 32, 96) causal, at (2, 2048, 16, 256) causal on
            2 kv heads (Qwen3-Next's full-attention layers), at (4, 1536,
            32, 80) causal through the padded route (Phi-2's widths,
            printed beside the native 96) and at (2, 256, 4, 32); paged
            decode at q (8, 32, 96) and q (8, 16, 256) on 2 kv heads in
            e2's pool layout; RMSNorm at width 3072 (the backward's two
            launches timed apart) and RoPE at head dim 96 (with k=None
            too; the decode step's (8, 1, 32, 96) timed apart). Then the
            flash-edge cases again at head dims 96 and 256.
14. phi3-serve  a LLaMA at Phi-3-mini's widths (CFG_PHI3: 32 layers,
            hidden 3072, 32 heads of 96) behind the engine on e2's
            traffic in two arms, the default decode_megakernel=1 (fused:
            the megakernel at head dim 96, once a layer a decode step)
            and decode_megakernel=0 (unfused: the four serving
            kernels): all 24 requests finished, tokens/s, launches per
            decode step; gated first on a 2-layer model's logits (prefill
            and 4 decode steps) against f32 on the CPU within
            MODEL_REL_L2.
15. phi3-train  the same widths at 4 layers (a depth cut): the train
            phase's step, batch 4 x seq 1536, 1 warm-up and 5 timed
            steps (step ms, MFU, peak memory, losses finite and
            falling); then phi3-grad, the grad phase at those widths.
16. mistral-large-serve  a LLaMA at Mistral-Large-Instruct-2407's
            widths (CFG_MISTRAL_LARGE: hidden 12288, 96 heads of 128 on 8
            kv heads, a GQA group of 12), cut to 4 of its 88 layers
            (~6.3 B parameters), bf16, on e2's traffic with the default
            decode_megakernel=1, which the probe declines (hidden 12288):
            paged decode at group 12 once a layer a decode step, the
            flash forward at group 12 in the prefills; all 24 requests
            finished, tokens/s, launches per decode step, peak memory;
            gated first on a 1-layer model's logits against f32 on the
            CPU within MODEL_REL_L2; every forward (a decode step's, and
            a prefill's: one flash launch a layer) launches the RMSNorm
            kernel once a norm, 2 a layer and the final one.
17. f32-kernel  the f32 instantiations of the four serving kernels (the
            JAX model's default dtype) against their f32 plain versions
            within 1e-4 + 1e-4 |plain| (lse too), TF32 off, each timed
            beside its bound (bytes, or flops at the f32 FMA rate of 67
            TFLOP/s; the flash forward, in 3xTF32, three TF32 products a
            flop at 495 TFLOP/s), the plain version and a library call:
            RMSNorm at (8, 1536) and (1024, 1536) and the wide kernel at
            (8, 3072) and (8, 12288), RoPE on (8, 128, 12,
            128) both ways and at decode positions (the decode step's (8,
            1, 12, 128) timed apart), the flash forward at
            e2's prefill (8, 128, 12, 128) causal, at (4, 1536, 12, 128), at
            Phi-3's (8, 128, 32, 96) and at (2, 2048, 16, 256) on 2 kv
            heads (F.scaled_dot_product_attention in f32 beside it), with
            segments (rows with no key exactly 0, lse -1e30), paged decode
            in e2's pool.
18. f32-serve  the 438M in f32 behind the engine on e2's traffic in
            three arms, in turns, twice: f32 fused (the default
            decode_megakernel=1: fused_decode_layer[f32]), f32 unfused
            (decode_megakernel=0: the four [f32] serving kernels) and bf16
            unfused on the same weights rounded; gated on the f32 logits
            (prefill and 4 decode steps, unfused and fused) within 1e-3
            relative L2 of the CPU, the fused steps' pools within the f32
            kernel gate of the unfused ones', all 24 requests finished,
            launches in the model's dtype only; tokens/s, launches and
            device idle per decode step, peak memory, and how far the
            greedy streams agree.
19. f32-train-kernel  the f32 training path's backward kernels against
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
            causal with its 7 packed documents; at each shape the f32
            forward's out and lse too, at the same gate.
20. f32-grad  the grad phase in f32: a 2-layer model at the 438M widths
            on (1, 256) ids, f32 on the card against f32 on the CPU: the
            loss within 1e-5 relative, every gradient within 1e-4
            relative L2, no bf16 launch.
21. f32-train  the train phase on the 438M in f32 (the JAX model's
            default dtype), full width and depth, batch 4 x seq 1536:
            step ms, tokens/s, MFU against the bf16 peak and the f32 FMA
            peak, peak memory, losses (finite, falling, the first within
            1.0 of ln 32000), and one step's launches: the seven [f32]
            training kernels at 25/25/12/12/12/12/12, the update once and
            nothing else; then the three f32 phases' seconds.
22. kernels one JSON line listing every ported kernel, with the unfused
            serving arm's launches for the serving kernels, the fused
            arm's for the megakernel, the LLaMA training step's for the
            backward kernels, the incubate phase's for the bdrln kernel,
            the varlen phase's for the three [seg] rows, the Phi-3
            paths' for the eight [d=96] / [h=3072] rows (phi3-serve's
            unfused arm) and fused_decode_layer[d=96] (its fused arm),
            mistral-large-serve's for paged_attention[g=12] and
            rms_norm[h=12288] (the wide kernel), f32-serve's
            unfused f32 arm for the four [f32] serving rows and its fused
            arm for fused_decode_layer[f32], f32-train's for the four
            [f32] backward rows, and kv-e9's long-prompt run for
            fused_rope[pos=1535] and fused_decode_layer[len=1535] (its
            unfused arm's for paged_attention[len=1536]),
            llama-large-train's for multi_tensor_adam (timed at the
            1.28B's parameters) and f32-train's for
            multi_tensor_adam[f32] (timed at the 438M's in f32); before
            it, the whole script's time.

Then the card's name and power limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero, and so
does a machine without a GPU.
"""
from __future__ import annotations

import copy
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Published dense peaks (NVIDIA data sheets, SXM parts at 700 W):
# (memory bytes/s, bf16 tensor-core flop/s, f32 flop/s outside the
# tensor cores, TF32 tensor-core flop/s)
PEAKS = {"H100": (3.35e12, 989e12, 67e12, 495e12),
         "H200": (4.8e12, 989e12, 67e12, 495e12)}
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
        at = atol if isinstance(atol, float) else "per element"
        raise PhaseFailed(f"{name}: {int(bad.sum())} elements beyond "
                          f"atol {at} + rtol {rtol}; max abs err "
                          f"{err.max().item():.3g}")
    return err.max().item()


def bound_ms(nbytes, flops, peaks, flop_rate=None):
    """The least time for the work: bytes over the memory rate against
    operations over ``flop_rate`` (default the bf16 tensor-core peak)."""
    t_bytes, t_ops = nbytes / peaks[0], flops / (flop_rate or peaks[1])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def launch_split(fn, calls=10):
    """Device time of each kernel that ``fn`` launches, in ms a call, by
    kernel name: ``calls`` eager calls after a warm-up under torch.profiler
    (a wrapper of two launches, timed apart)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = float(getattr(e, "self_device_time_total", 0.0))
            split[e.key[:60]] = us / 1e3 / calls
    if not split:
        raise PhaseFailed("torch.profiler recorded no device time")
    return split


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


def rope_decode_row(fo, peaks, q, k, cos, sin, pos, f32=False):
    """RoPE at a decode step's (8, 1, H, D) q and k, per-slot positions:
    timed beside its bound (bytes; the flops at the f32 FMA rate for
    f32) and the plain version. The gate is the caller's."""
    bms, by = bound_ms(2 * 2 * q.numel() * q.element_size()
                       + pos.numel() * 4 + 2 * pos.numel() * q.shape[-1] * 4,
                       6 * q.numel(), peaks,
                       flop_rate=peaks[2] if f32 else None)
    return dict(shape=list(q.shape),
                ms=graph_ms(lambda: fo.fused_rope_at(q, k, cos, sin, pos)),
                plain_ms=graph_ms(lambda: fo.fused_rope_plain(q, k, cos, sin,
                                                              pos)),
                library_ms=None, bound_ms=bms, bound_by=by)


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
    # the wide kernel (a block a row) at Mistral-Large-2's hidden 12288:
    # mistral-large-serve's decode step (8 rows) and a prefill's 1024,
    # the latter also with its inputs out of L2
    wide = CFG_MISTRAL_LARGE["hidden_size"]
    ww = (1.0 + 0.1 * randn(wide, dtype=torch.float32)).to(bf16)
    for n in (8, 1024):
        x = randn(n, wide)
        err = rms_norm_variants(rn, x, ww, 0.1 * randn(wide),
                                f"rms_norm({n}, {wide})")
        bms, by = bound_ms(2 * n * wide * 2 + wide * 2 + n * 4, 4 * n * wide,
                           peaks)
        rec = dict(
            case="mistral-large", shape=[n, wide], max_abs_err=err,
            ms=graph_ms(lambda: rn.rms_norm_rows(x, ww, epsilon=1e-5)),
            plain_ms=graph_ms(lambda: rn.rms_norm_plain(x, ww, epsilon=1e-5)),
            library_ms=graph_ms(lambda: torch.nn.functional.rms_norm(
                x, (wide,), ww, 1e-5)),
            bound_ms=bms, bound_by=by)
        if n > 8:
            rec.update(
                cold_ms=cold_ms(lambda xx: rn.rms_norm_rows(xx, ww,
                                                            epsilon=1e-5),
                                (x,)),
                cold_library_ms=cold_ms(
                    lambda xx: torch.nn.functional.rms_norm(xx, (wide,), ww,
                                                            1e-5), (x,)))
        emit("kernel", name="rms_norm", **rec)
        if n == 8:  # mistral-large-serve's decode step
            results["rms_norm[h=12288]"] = rec
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
    dpos = torch.randint(0, 183, (8, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    dq, dk = randn(8, 1, heads, hd), randn(8, 1, heads, hd)
    err = 0.0
    for inverse in (False, True):  # both directions, prefill and decode
        for a, b, p_, tag in ((q, k, pos, "rope"), (dq, dk, dpos,
                                                     "rope(decode)")):
            for got, want in zip(
                    fo.fused_rope_at(a, b, cos, sin, p_, inverse),
                    fo.fused_rope_plain(a, b, cos, sin, p_, inverse)):
                err = max(err, compare(tag, got, want))
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
    emit("kernel", name="fused_rope", case="decode",
         **rope_decode_row(fo, peaks, dq, dk, cos, sin, dpos))
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
# depths spread over the serving runs' range (prompts of 8-119 tokens plus
# up to 64 new ones), for timing the megakernel where the engine runs it
MK_SERVING_LENGTHS = [20, 42, 64, 86, 108, 130, 152, 175]


def megakernel_layer(cfg, gen, dtype=torch.bfloat16):
    """A decoder layer at ``cfg``'s widths in ``dtype``, drawn by the
    model's initialiser (weights N(0, 0.02), norm scales 1)."""
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer

    return LlamaDecoderLayer(LlamaConfig(**cfg), generator=gen, device="cuda",
                             dtype=dtype)


def h_mid_gate(name, got, want, x, o):
    """The decode megakernel's bf16 h_mid = bf16(x + bf16(o))
    against the plain version's, o (B, hidden) being the plain version's
    bf16(o). It rounds twice: where kernel and plain version sum o in
    other orders and land on the two sides of a rounding boundary of o,
    the kernel's bf16(o) is a bf16 neighbour of the plain one, and h_mid
    can move by up to an ulp of o, more than an ulp of h_mid where |o| >
    |h_mid|. An element passes the one-rounding gate (``compare``) or
    equals bf16(x + o') for o' one of the two bf16 neighbours of the
    plain bf16(o); nothing else. Returns (max abs err, the elements only
    the neighbour rule takes)."""
    got, want = got[:, 0], want[:, 0]
    if not torch.isfinite(got.float()).all():
        raise PhaseFailed(f"{name}: kernel output not finite")
    err = (got.float() - want.float()).abs()
    one = err <= ATOL + RTOL * want.float().abs()
    bits = o.contiguous().view(torch.int16)
    near = torch.zeros_like(one)
    for step in (-1, 1):
        o_ = (bits + step).view(torch.bfloat16).float()
        near |= got == (x[:, 0].float() + o_).to(torch.bfloat16)
    bad = ~(one | near)
    if bad.any():
        raise PhaseFailed(f"{name}: {int(bad.sum())} elements beyond atol "
                          f"{ATOL} + rtol {RTOL} and not x + a bf16 "
                          f"neighbour of o; max abs err "
                          f"{err.max().item():.3g}")
    return err.max().item(), int((near & ~one).sum())


def megakernel_setup(cfg, gen, randn, dtype=torch.bfloat16,
                     lengths=MK_LENGTHS, per_seq=4):
    """The inputs of the decode megakernel at the e2 decode shape, in a
    layer at ``cfg``'s widths in ``dtype``: 8 rows over the engine's pool
    layout (max_len 512, page 128: 32 real pages and the dump page; tables
    of 4 visible columns and a trailing scratch column, tails on the dump
    page; or ``per_seq`` visible columns), pre-append depths ``lengths``.
    x is layer 0's input, an embedding row (N(0, 0.02)); weights N(0,
    0.02); norm scales random powers of two (0.5, 1, 2), exact in bf16,
    so that a scale adds no rounding of its own.
    Returns (layer, x, k_pages, v_pages, args), args the wrapper's keyword
    arguments but the pools."""
    layer = megakernel_layer(cfg, gen, dtype)
    attn = layer.self_attn
    lcfg = attn.config
    with torch.no_grad():
        for ln in (layer.input_layernorm, layer.post_attention_layernorm):
            ln.weight.copy_(2.0 ** torch.randint(
                -1, 2, ln.weight.shape, generator=gen, device="cuda"))
    b, page = 8, 128
    hidden, heads = lcfg.hidden_size, lcfg.num_attention_heads
    hd, kvh = lcfg.head_dim, lcfg.num_key_value_heads
    n_pages = b * per_seq + 1
    dump = n_pages - 1
    perm = np.random.RandomState(0).permutation(b * per_seq)
    tables = np.full((b, per_seq + 1), dump, np.int32)
    used = 0
    for i, n in enumerate(lengths):
        np_ = -(-(n + 1) // page)  # the pages after the append
        tables[i, :np_] = perm[used:used + np_]
        used += np_
    tab = torch.tensor(tables, device="cuda")
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    x = randn(b, 1, hidden, std=0.02).to(dtype)
    kp = randn(n_pages, page, kvh, hd).to(dtype)
    vp = randn(n_pages, page, kvh, hd).to(dtype)
    eps = lcfg.rms_norm_eps
    args = dict(ln1_weight=layer.input_layernorm.weight, ln1_eps=eps,
                wq=attn.q_proj.weight, wk=attn.k_proj.weight,
                wv=attn.v_proj.weight, wo=attn.o_proj.weight,
                rope_cos=attn.rope_cos, rope_sin=attn.rope_sin,
                ln2_weight=layer.post_attention_layernorm.weight,
                ln2_eps=eps, tables=tab, lengths=lens, heads=heads,
                attn_pages=per_seq, dump_page=dump)
    return layer, x, kp, vp, args


MK_WEIGHTS = ("ln1_weight", "wq", "wk", "wv", "wo", "ln2_weight")


def megakernel_times(mk, x, kp, vp, args, replays=5):
    """The megakernel's device time a call: warm (``graph_ms`` on one
    layer, whose weights stay in L2 where they fit) and rotating: one
    step's walk over n distinct layers in turn, each with its own weights
    and pools, n = max(4, ceil(4 x L2 / the layer's q/k/v/o bytes)), so
    that every call finds its weights out of L2, as the engine's decode
    step does. Returns (warm ms, rotating ms, n)."""
    kk, kv_ = kp.clone(), vp.clone()
    warm = graph_ms(lambda: mk.fused_decode_layer(x, k_pages=kk, v_pages=kv_,
                                                  **args))
    w_bytes = sum(args[k].numel() * args[k].element_size()
                  for k in ("wq", "wk", "wv", "wo"))
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    n = max(4, -(-4 * l2 // w_bytes))
    layers = [(dict(args, **{k: args[k].clone() for k in MK_WEIGHTS}),
               kp.clone(), vp.clone()) for _ in range(n)]
    turn = itertools.count()

    def step():
        a, k, v = layers[next(turn) % n]
        return mk.fused_decode_layer(x, k_pages=k, v_pages=v, **a)

    rotating = graph_ms(step, calls=n, replays=replays)
    del layers
    torch.cuda.empty_cache()
    return warm, rotating, n


def megakernel_case(peaks, cfg, gen, randn, dtype=torch.bfloat16, case=None,
                    one_rounding=False, lengths=MK_LENGTHS, per_seq=4):
    """The decode megakernel against its plain version at
    ``megakernel_setup``'s inputs. h_mid and both pools (the dump page
    left out) are held against the plain version; y2 against the plain
    norm of the kernel's own h_mid. y2 renormalises h_mid, so held against
    the plain y2 a difference of h_mid would count again; the plain y2's
    difference is reported. In f32 nothing is rounded, and h_mid and y2
    are held against the plain version's at the f32 gate. In bf16 h_mid
    takes ``h_mid_gate``, and with ``one_rounding`` (the 438M cases) the
    one-rounding gate alone: no element by the neighbour rule. Times the
    kernel warm and rotating over layers (``megakernel_times``; the bound
    is set against the rotating time), its plain version and the port's
    own unfused layer half (rms_norm kernel, GEMMs, RoPE kernel, cache
    write, paged decode kernel, o_proj, residual, rms_norm kernel) on the
    same inputs. ``lengths`` and ``per_seq`` as ``megakernel_setup``'s."""
    from paddle_tpu_torch.models.generation import _make_paged_cache
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk

    layer, x, kp, vp, args = megakernel_setup(cfg, gen, randn, dtype,
                                              lengths, per_seq)
    attn = layer.self_attn
    f32 = dtype == torch.float32
    b, hidden = x.shape[0], x.shape[2]
    n_pages, page, kvh, hd = kp.shape
    heads, per_seq, dump = args["heads"], args["attn_pages"], \
        args["dump_page"]
    tab, lens = args["tables"], args["lengths"]
    eps = args["ln1_eps"]
    kk, kv_ = kp.clone(), vp.clone()
    pk, pv = kp.clone(), vp.clone()
    with torch.no_grad():
        got = mk.fused_decode_layer(x, k_pages=kk, v_pages=kv_, **args)
        want = mk.fused_decode_layer_plain(x, k_pages=pk, v_pages=pv, **args)
    tag = f"fused_decode_layer({case or f'kvh={kvh}'})"
    o_args = {k: v for k, v in args.items()
              if k not in ("ln2_weight", "ln2_eps", "dump_page")}
    with torch.no_grad():
        y2_own = mk.decode_norm_plain(got[0], args["ln2_weight"], eps)
        gate = f32_compare if f32 else compare
        nb = 0
        if f32:
            h = gate(f"{tag} h_mid", got[0], want[0])
        else:
            o = mk.decode_attention_o_plain(x, k_pages=kp.clone(),
                                            v_pages=vp.clone(), **o_args)
            h, nb = h_mid_gate(f"{tag} h_mid", got[0], want[0], x, o)
            if one_rounding and nb:
                raise PhaseFailed(f"{tag} h_mid: {nb} elements beyond the "
                                  f"one-rounding gate")
        err = max(h, gate(f"{tag} y2", got[1], want[1] if f32 else y2_own),
                  gate(f"{tag} k_pages", kk[:dump], pk[:dump]),
                  gate(f"{tag} v_pages", kv_[:dump], pv[:dump]))
    torch.cuda.synchronize()

    def unfused():
        cache = _make_paged_cache(kp, vp, tab, page, lens, per_seq, dump)
        h = x + attn(layer.input_layernorm(x), cache=cache)
        return h, layer.post_attention_layernorm(h)

    with torch.no_grad():
        uh, uy = unfused()
    size = x.element_size()
    w_bytes = sum(args[k].numel() * size for k in ("wq", "wk", "wv", "wo"))
    toks = sum(min(n, per_seq * page) for n in lengths)  # pool rows read
    nbytes = (w_bytes + 2 * hidden * size + 3 * b * hidden * size
              + 2 * (toks + b) * kvh * hd * size + 2 * b * hd * 4
              + tab.numel() * 4 + b * 4)
    flops = (2 * b * hidden * (heads + 2 * kvh) * hd
             + 2 * b * heads * hd * hidden
             + 4 * (toks + b) * heads * hd)
    bms, by = bound_ms(nbytes, flops, peaks,
                       flop_rate=peaks[2] if f32 else None)
    with torch.no_grad():
        warm, rotating, n_layers = megakernel_times(mk, x, kp, vp, args)
        rec = dict(
            case=f"e2 decode, {case or f'kv heads {kvh}'}",
            dtype=str(dtype), shape=[b, hidden], heads=heads, kv_heads=kvh,
            head_dim=hd, lengths=lengths, max_abs_err=err,
            h_mid_gate="f32" if f32 else (
                "one rounding" if one_rounding else "h_mid_gate"),
            y2_vs_plain_max_abs=float((got[1].float()
                                       - want[1].float()).abs().max()),
            h_mid_elements_differing=int((got[0] != want[0]).sum()),
            h_mid_elements_by_neighbour_rule=nb,
            unfused_vs_fused_h_mid_max_abs=float(
                (uh.float() - got[0].float()).abs().max()),
            ms=rotating, warm_ms=warm, rotating_layers=n_layers,
            plain_ms=graph_ms(lambda: mk.fused_decode_layer_plain(
                x, k_pages=pk, v_pages=pv, **args), calls=5),
            library_ms=None, unfused_ms=graph_ms(unfused),
            eager_ms=eager_ms(lambda: mk.fused_decode_layer(
                x, k_pages=kk, v_pages=kv_, **args)),
            eager_unfused_ms=eager_ms(unfused),
            bound_ms=bms, bound_by=by, bound_share=bms / rotating,
            bound_bytes=nbytes, bound_flops=flops)
    emit("kernel", name="fused_decode_layer" + ("[f32]" if f32 else ""),
         **rec)
    del layer, kk, kv_, pk, pv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rec


# The megakernel phase's cases: (case, widths over CFG_438M, dtype, the
# one-rounding gate for the bf16 h_mid). Widths are a LLaMA's, head dim
# hidden / heads.
MK_CASES = [
    ("438M, kv heads 12", {}, torch.bfloat16, True),
    ("438M, kv heads 4", {"num_key_value_heads": 4}, torch.bfloat16, True),
    ("438M f32", {}, torch.float32, False),
    ("phi3-mini widths, d 96", CFG_PHI3, torch.bfloat16, False),
    ("phi2 widths, d 80", dict(num_key_value_heads=None, hidden_size=2560,
                               num_attention_heads=32), torch.bfloat16,
     False),
    ("d 256 on 2 kv heads", dict(hidden_size=4096, num_attention_heads=16,
                                 num_key_value_heads=2), torch.bfloat16,
     False),
    ("group 16", dict(hidden_size=4096, num_attention_heads=32,
                      num_key_value_heads=2), torch.bfloat16, False),
]


def mk_cfg(widths):
    return widths if widths is CFG_PHI3 else {**CFG_438M, **widths}


def megakernel_phase(peaks):
    """The decode megakernel at MK_CASES: the 438M serving decode (12 kv
    heads) and a GQA case (4 kv heads, 3 query heads each), which the 438M
    model does not exercise, both at the one-rounding gate; the 438M layer
    in f32; Phi-3-mini's widths (32 heads of 96), Phi-2's (32 heads of
    80), head dim 256 (16 heads on 2 kv heads) and a group of 16 (32 heads
    of 128 on 2 kv heads). Returns the rows of the kernels line."""
    from paddle_tpu_torch import seed

    gen = seed(4, "cuda")

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    recs = {case: megakernel_case(peaks, mk_cfg(widths), gen, randn, dtype,
                                  case, one_rounding)
            for case, widths, dtype, one_rounding in MK_CASES}
    return {"fused_decode_layer": recs["438M, kv heads 12"],
            "fused_decode_layer[f32]": recs["438M f32"],
            "fused_decode_layer[d=96]": recs["phi3-mini widths, d 96"]}


def card_and_cpu(cfg, seed_, dtype=torch.bfloat16):
    """The model of ``cfg`` in ``dtype`` on the card (random N(0, 0.02)
    weights from ``seed(seed_)``) and a copy of it in f32 on the CPU (the
    same weights; no second draw). The copy's RoPE tables (buffers that
    are no part of the weights) are built anew on the CPU, so that the
    reference owes nothing to tables computed on the card."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.models.llama import _rope_tables

    card = LlamaForCausalLM(cfg, device="cuda", dtype=dtype,
                            generator=seed(seed_, "cuda"))
    cpu = copy.deepcopy(card).to(device="cpu", dtype=torch.float32)
    for m in cpu.modules():
        if hasattr(m, "rope_cos"):
            c = m.config
            m.rope_cos, m.rope_sin = _rope_tables(
                c.head_dim, c.max_position_embeddings, c.rope_theta, "cpu")
    return card, cpu


def prefill_decode(model, prompts, steps, fused=False):
    """Last-position logits (f32, on the CPU) of a bucket prefill of
    ``prompts`` (B, S) into paged caches (page 128), then of each decode
    step's tokens in ``steps`` (n, B); ``fused`` gives the caches per-slot
    (B,) depths and decodes under megakernel_scope(True). Returns the
    logits and the caches."""
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
    return outs, caches


def model_phase():
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.ops.cuda import launch_counts

    cfg = LlamaConfig(**CFG_438M)
    card, cpu = card_and_cpu(cfg, 0)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (2, 128))
    steps = rng.randint(0, cfg.vocab_size, (4, 2))

    def run(model, fused=False):
        return prefill_decode(model, prompts, steps, fused)[0]

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


def eager_engine():
    """The eager serial reference engine class: the serial scheduler with
    each decode step's launches issued from Python (the engine's private
    ``_capture_decode`` off), the path the captured, pipelined default is
    measured and checked against."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    class EagerSerialEngine(ContinuousBatchingEngine):
        _capture_decode = False

        def __init__(self, model, **kw):
            super().__init__(model, pipeline=False, **kw)

    return EagerSerialEngine


def serving_workload(model, decode_megakernel=1, eager=False):
    """The e2 serving run on ``model``: the engine (8 slots, max_len 512,
    page 128, buckets (32, 128); ``decode_megakernel`` 1 takes the fused
    decode layers, 0 the unfused ones; the default pipelined engine that
    replays a captured segment, or with ``eager`` the eager serial
    reference), warmed by ``warmup()`` and on two requests, and the 24
    prompts of 8-119 tokens from np.random.RandomState(7). Returns
    (engine, prompts); run them with ``engine.run(prompts,
    max_new_tokens=SERVE_NEW_TOKENS, segment=SERVE_SEGMENT)``."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    vocab = model.config.vocab_size
    cls = eager_engine() if eager else ContinuousBatchingEngine
    eng = cls(model, max_slots=8, max_len=512, page_size=128,
              prompt_buckets=(32, 128), decode_megakernel=decode_megakernel)
    eng.warmup(segment=SERVE_SEGMENT)
    rng = np.random.RandomState(7)
    warm = [rng.randint(0, vocab, (n,)).astype(np.int32) for n in (12, 60)]
    eng.run(warm, max_new_tokens=2, segment=SERVE_SEGMENT)
    lens = rng.randint(8, 120, 24)
    return eng, [rng.randint(0, vocab, (int(n),)).astype(np.int32)
                 for n in lens]


SERVE_UNFUSED_KERNELS = ("rms_norm", "fused_rope", "flash_attention",
                         "paged_attention")


def serving_arm(model, decode_megakernel, name, smi, phase="serving",
                fused=None, eager=False):
    """One run of e2's traffic (``serving_workload``) on ``model`` with
    the engine's ``decode_megakernel`` (1: the fused decode layers where
    the probe takes the model, 0: unfused); ``fused`` is the decision the
    engine must make (default: ``decode_megakernel``); ``eager`` runs the
    eager serial reference engine. Launch counts are zeroed just before
    the run and read just after it (a graph replay credits the launches
    its capture recorded). Gated: every request finishes with
    SERVE_NEW_TOKENS tokens, the pools stay finite, and only kernels of
    the model's dtype launch (an f32 launch counted as ``<kernel>[f32]``):
    fused, the megakernel once a layer a decode step and paged decode
    never; unfused, the four serving kernels and no megakernel. Returns
    (engine, prompts, outputs, record)."""
    from paddle_tpu_torch.ops.cuda import launch_counts

    fused = bool(decode_megakernel) if fused is None else fused
    tag = "[f32]" if model.dtype == torch.float32 else ""
    arm = "fused" if fused else "unfused"
    vocab = model.config.vocab_size
    eng, prompts = serving_workload(model, decode_megakernel, eager)
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
               engine="eager serial" if eager else "captured pipelined",
               pipelined=stats["pipelined"],
               requests=len(outs), finished=finished,
               new_tokens=SERVE_NEW_TOKENS,
               tokens_per_sec=stats["tokens_per_sec"], wall_s=stats["wall_s"],
               wall_ms_per_decode_step=1e3 * stats["wall_s"] / steps,
               host_gap_ms=stats["host_gap_ms"],
               useful_tokens=stats["useful_tokens"],
               segments=stats["segments"], decode_steps=steps,
               mean_occupancy=stats["mean_occupancy"], launches=counts,
               launches_per_decode_step={k: v / steps
                                         for k, v in counts.items()},
               kernel_launches_per_decode_step=sum(counts.values()) / steps,
               kv_finite=finite, card=name, nvidia_smi=smi)
    emit(phase, **rec)
    layers = model.config.num_hidden_layers
    wrong = [k for k in counts if k.endswith("[f32]") != bool(tag)]
    if fused:
        bad = (counts.get("fused_decode_layer" + tag, 0) != layers * steps
               or counts.get("paged_attention" + tag, 0))
    else:
        bad = (any(counts.get(k + tag, 0) <= 0 for k in SERVE_UNFUSED_KERNELS)
               or counts.get("fused_decode_layer" + tag, 0))
    if (finished != len(prompts) or not finite or wrong or bad
            or stats["megakernel"] != fused
            or stats["useful_tokens"] != len(prompts) * SERVE_NEW_TOKENS):
        raise PhaseFailed(f"{phase} ({arm}): finished {finished} of "
                          f"{len(prompts)}, kv finite {finite}, megakernel "
                          f"{stats['megakernel']}, launches {counts}")
    return eng, prompts, outs, rec


def serving_phase(model, name, smi):
    """The e2 run in two arms on the same model and prompts: unfused, then
    fused. Where two greedy streams part, the top-2 logit gap of a full
    forward over the prompt and the common prefix says how near a tie the
    choice was (printed beside the logits' scale, not gated). Returns each
    arm's launch counts."""
    _, prompts, u_outs, u = serving_arm(model, 0, name, smi)
    _, _, f_outs, f = serving_arm(model, 1, name, smi)
    captured_phase("e2 fused", model, 1, name, smi)
    captured_phase("e2 unfused", model, 0, name, smi)
    parts = [next((i for i, (a, b) in enumerate(zip(u_, f_)) if a != b), None)
             for u_, f_ in zip(u_outs, f_outs)]
    gaps, scales = [], []
    with torch.no_grad():
        for prompt, u_, p in zip(prompts, u_outs, parts):
            if p is None:
                continue
            seq = np.concatenate([prompt, u_[:p]]).astype(np.int64)
            logits = model(torch.tensor(seq[None], device="cuda"))[0, -1]
            top2 = torch.topk(logits.float(), 2).values
            gaps.append(float(top2[0] - top2[1]))
            scales.append(float(logits.float().std()))
    emit("serving_arms", unfused_tokens_per_sec=u["tokens_per_sec"],
         fused_tokens_per_sec=f["tokens_per_sec"],
         streams_agree=sum(p is None for p in parts) / len(parts),
         first_index_where_streams_part=parts,
         top2_gap_where_streams_part=gaps, logit_std_there=scales)
    return {"serving": u["launches"], "serving_fused": f["launches"]}


CAPTURED_TURNS = 2


def captured_phase(cell, model, decode_megakernel, name, smi, fused=None):
    """serving-captured: e2's traffic on ``model`` through the default
    engine (pipelined, each decode segment one replay of its captured CUDA
    graph) and the eager serial reference (the serial scheduler, every
    launch from Python), in turns, CAPTURED_TURNS times each, every run
    through ``serving_arm``'s gates. Prints each run's tokens/s, wall ms
    and launches a decode step. Gated: every greedy stream of every run
    identical to the first eager run's."""
    t0 = time.monotonic()
    runs = []
    for _ in range(CAPTURED_TURNS):
        for eager in (False, True):
            _, _, outs, rec = serving_arm(model, decode_megakernel, name,
                                          smi, "serving-captured", fused,
                                          eager)
            runs.append((rec["engine"], outs, rec))
    ref = next(outs for engine, outs, _ in runs if engine == "eager serial")
    agree = [sum(bool((a == b).all()) for a, b in zip(outs, ref)) / len(ref)
             for _, outs, _ in runs]
    summary = [dict(engine=engine,
                    tokens_per_sec=rec["tokens_per_sec"],
                    wall_ms_per_decode_step=rec["wall_ms_per_decode_step"],
                    kernel_launches_per_decode_step=rec[
                        "kernel_launches_per_decode_step"],
                    segments=rec["segments"], host_gap_ms=rec["host_gap_ms"],
                    streams_equal_to_first_eager=a)
               for (engine, _, rec), a in zip(runs, agree)]
    emit("serving-captured", cell=cell, runs=summary,
         seconds=time.monotonic() - t0, card=name, nvidia_smi=smi)
    if min(agree) < 1.0:
        raise PhaseFailed(f"serving-captured ({cell}): greedy streams "
                          f"differ from the eager serial run's: {agree}")
    return summary


# ----------------------------------------------------------------- kv-e9
# bench.py section (e9) on the port (the dynamic page pool and the prefix
# cache on the 438M), its gate, and the admission path's drills: long
# prompts through chunked prefill, copy-on-write resumes, preemption

KV_E9_LEN, KV_E9_PAGE, KV_E9_REQ, KV_E9_NEW = 512, 128, 48, 16
KV_E9_POOL = 4 * KV_E9_LEN // KV_E9_PAGE  # the static layout holds 4 slots
# (d): 8 slots of 1536 tokens on a pool of a third of 8 x 12 pages
KV_LONG = dict(max_slots=8, max_len=1536, page_size=128,
               prompt_buckets=(32, 128))
KV_LONG_POOL, KV_LONG_NEW, KV_LONG_SEGMENT = 32, 128, 32
# (e): pre-append depths of the megakernel and post-append lengths of
# paged decode over 12 table columns of 128 (max_len 1536), and the bases
# of RoPE's per-row positions in a chunk of 128
LONG_DEPTHS = [1, 639, 700, 767, 768, 1023, 1400, 1535]
LONG_LENGTHS = [n + 1 for n in LONG_DEPTHS]
ROPE_LONG_BASES = [0, 128, 256, 640, 700, 1024, 1300, 1408]


class LogitsRecorder:
    """Stands in for the model inside an engine and keeps, on the CPU,
    the logits of every multi-token forward (prefill, chunk and resume
    dispatches) with the cache length it ran from."""

    def __init__(self, model):
        self.model, self.calls = model, []

    def __call__(self, ids, caches=None):
        base = caches[0].length
        out = self.model(ids, caches=caches)
        if ids.shape[1] > 1:
            base = base if isinstance(base, int) else base.cpu().tolist()
            self.calls.append((base, out.float().cpu()))
        return out


def kv_gate(seed_, dtype, tol):
    """The admission path's logits on the card against a cache-free f32
    forward on the CPU: a 2-layer model at the 438M's widths behind an
    engine (2 slots, max_len 512, page 128, buckets (32, 128)); row 0, a
    300-token prompt, in chunks of 128 at bases 0 and 128 and a final
    padded chunk at 256; row 1, its first 200 tokens and 40 of its own,
    resumed at base 200 (mid-page) after a copy-on-write copy of page 1.
    Each dispatch's logits at its true positions within ``tol``
    relative L2."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine, LlamaConfig

    cfg = LlamaConfig(**dict(CFG_438M, num_hidden_layers=2))
    card, cpu = card_and_cpu(cfg, seed_, dtype)
    rng = np.random.RandomState(5)
    row0 = rng.randint(0, cfg.vocab_size, (300,)).astype(np.int32)
    row1 = np.concatenate([row0[:200], rng.randint(0, cfg.vocab_size, (40,))
                           ]).astype(np.int32)
    eng = ContinuousBatchingEngine(card, max_slots=2, max_len=512,
                                   page_size=128, prompt_buckets=(32, 128))
    rec = LogitsRecorder(card)
    eng.model = rec
    eng.start(segment=1)
    reqs = [eng.submit(row0, 2)]
    eng.step()
    reqs.append(eng.submit(row1, 2))
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    bases = [b for b, _ in rec.calls]
    d = eng.stats()["dispatches"]
    if (bases != [[0], [128], [256], [200]] or d["cow_pages"] != 1
            or d["chunk"] != 2 or d["final_chunk"] != 1 or d["resume"] != 1
            or [r.status for r in reqs] != ["ok", "ok"]):
        raise PhaseFailed(f"kv-e9 gate: dispatches {d} at bases {bases}, "
                          f"statuses {[r.status for r in reqs]}")
    got0 = torch.cat([rec.calls[0][1][0], rec.calls[1][1][0],
                      rec.calls[2][1][0, :44]])
    got1 = rec.calls[3][1][0, :40]
    with torch.no_grad():
        want0 = cpu(torch.tensor(row0[None].astype(np.int64)))[0]
        want1 = cpu(torch.tensor(row1[None].astype(np.int64)))[0, 200:]
    rel = [rel_l2(got0, want0), rel_l2(got1, want1)]
    finite = bool(torch.isfinite(got0).all() and torch.isfinite(got1).all())
    del card, cpu, eng, rec
    torch.cuda.empty_cache()
    if not finite or max(rel) > tol:
        raise PhaseFailed(f"kv-e9 gate ({dtype}): finite {finite}, rel L2 "
                          f"{rel} (tolerance {tol})")
    return dict(dtype=str(dtype), rel_l2_chunks=rel[0],
                rel_l2_resume=rel[1], tolerance=tol, bases=bases)


def kv_dynamic_arm(model, prompts, max_slots, pool=None):
    """bench.py's ``_kv_run``: e9's 48 requests on an engine of
    ``max_slots`` slots (max_len 512, page 128, buckets (16, 64), seed 0,
    segments of 4) over ``pool`` pages; the peak of concurrent requests,
    the fragmentation at it, and the gates' inputs."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, max_slots=max_slots,
                                   max_len=KV_E9_LEN, page_size=KV_E9_PAGE,
                                   prompt_buckets=(16, 64), seed=0,
                                   pool_pages=pool)
    eng.start(segment=4)
    reqs = [eng.submit(p, KV_E9_NEW, rid=i) for i, p in enumerate(prompts)]
    peak, frag = 0, 0.0
    t0 = time.perf_counter()
    while eng.has_work():
        eng.step()
        active = len(eng.active_requests())
        if active >= peak:
            peak, frag = active, eng.kv_stats()["fragmentation_pct"]
    wall = time.perf_counter() - t0
    kv = eng.kv_stats()
    ok = sum(r.status == "ok" and len(r.output()) == KV_E9_NEW for r in reqs)
    finite = all(bool(torch.isfinite(t).all()) for t in eng._ks + eng._vs)
    return dict(max_slots=max_slots, pool_pages=kv["pages_total"],
                peak_admitted=peak, fragmentation_pct=frag, wall_s=wall,
                requests_ok=ok, pages_free=kv["pages_free"],
                prefix_cached_pages=kv["prefix_cached_pages"],
                kv_finite=finite)


def kv_prefix_arm(model, prompts, cache_on):
    """bench.py's ``_px_run``: 4 slots, max_len 1024, page 128, buckets
    (16, 64); a seeding request, then the timed batch of ``prompts`` (2
    new tokens each). Returns (seconds, kv_stats(), dispatches)."""
    from paddle_tpu_torch.models import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, max_slots=4, max_len=2 * KV_E9_LEN,
                                   page_size=KV_E9_PAGE,
                                   prompt_buckets=(16, 64), seed=0,
                                   prefix_cache=cache_on)
    eng.start(segment=4)
    eng.submit(prompts[0], 2, rid=1000)
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    d0 = eng.stats()["dispatches"]
    t0 = time.perf_counter()
    reqs = [eng.submit(p, 2, rid=i) for i, p in enumerate(prompts)]
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if any(r.status != "ok" for r in reqs):
        raise PhaseFailed(f"kv-e9 prefix sweep (cache {cache_on}): "
                          f"{[r.status for r in reqs]}")
    d = {k: v - d0[k] for k, v in eng.stats()["dispatches"].items()}
    return secs, eng.kv_stats(), d


def kv_long_traffic(vocab):
    """(d)'s 16 prompts in submission order, from RandomState(41): 8 share
    a 700-token head (a 640-token prefix, five pages, and 60 more tokens)
    and end in 70-127 tokens of their own, so that a later one diverges
    mid-page inside a cached page; 4 prompts of their own of 1400 and
    700-1400 tokens; 4 of 8-119 tokens. The first is a sharing one."""
    rng = np.random.RandomState(41)
    head = rng.randint(0, vocab, (700,))
    share = [np.concatenate([head, rng.randint(0, vocab, (int(u),))])
             for u in rng.randint(70, 128, 8)]
    own = [rng.randint(0, vocab, (int(n),))
           for n in [1400] + list(rng.randint(700, 1401, 3))]
    short = [rng.randint(0, vocab, (int(n),)) for n in rng.randint(8, 120, 4)]
    rest = (share[1:], own, short)
    order = [share[0]] + [group[i] for i in range(len(share) - 1)
                          for group in rest if i < len(group)]
    return [p.astype(np.int32) for p in order]


def kv_long_run(model, prompts, decode_megakernel, prefix_cache, pool):
    """(d)'s run: the first prompt admitted and one step taken, then the
    rest submitted, stepped to the end; launch counts and the process
    counters zeroed just before and read just after. Returns (engine,
    requests, launches, counter deltas, seconds)."""
    from paddle_tpu_torch.core import counters
    from paddle_tpu_torch.models import ContinuousBatchingEngine
    from paddle_tpu_torch.ops.cuda import launch_counts

    eng = ContinuousBatchingEngine(model, pool_pages=pool,
                                   prefix_cache=prefix_cache,
                                   decode_megakernel=decode_megakernel,
                                   **KV_LONG)
    before = counters()
    torch.cuda.synchronize()
    launch_counts.clear()
    t0 = time.perf_counter()
    eng.start(segment=KV_LONG_SEGMENT)
    reqs = [eng.submit(prompts[0], KV_LONG_NEW, rid=0)]
    eng.step()
    reqs += [eng.submit(p, KV_LONG_NEW, rid=i + 1)
             for i, p in enumerate(prompts[1:])]
    while eng.has_work():
        eng.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(launch_counts)
    after = counters()
    delta = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("serving.kv_preempted", "serving.kv_pool_exhausted",
                       "serving.kv_cow_copies")}
    return eng, reqs, launches, delta, secs


def kv_partings(model, prompts, reqs, ref_reqs):
    """Where each greedy stream of ``reqs`` first parts from the
    reference's, a cache-free forward over the prompt and the common
    prefix scores both picks by their shortfall from the row's best
    logit. A parting is a bf16 tie when both shortfalls are within 2 x
    MODEL_REL_L2 of the logits' std: two routes, each held to
    MODEL_REL_L2 of the logits, may stray that far apart; a wrong page
    or base makes a pick no better than a random token, ~3 std short."""
    parts, short, tols, past = [], [], [], []
    with torch.no_grad():
        for i, (p, r, w) in enumerate(zip(prompts, reqs, ref_reqs)):
            got, want = r.output(), w.output()
            at = next((j for j, (a, b) in enumerate(zip(got, want))
                       if a != b), None)
            parts.append(at)
            if at is None:
                continue
            seq = np.concatenate([p, want[:at]]).astype(np.int64)
            logits = model(torch.tensor(seq[None], device="cuda"))[0, -1]
            logits = logits.float()
            best = logits.max()
            gap = [float(best - logits[int(t[at])]) for t in (got, want)]
            tol = 2 * MODEL_REL_L2 * float(logits.std())
            short.append(gap)
            tols.append(tol)
            if max(gap) > tol:
                past.append(i)
    return dict(streams_agree=sum(a is None for a in parts) / len(parts),
                first_index_where_streams_part=parts,
                shortfall_from_best=short, tolerance=tols,
                past_tolerance=past)


def kv_dispatch_times(eng, peaks):
    """Where an admission's time goes at the 438M, on (d)'s engine after
    its run (every slot idle, so the writes land on dump and scratch
    pages): wall ms of a chunk forward of 1 and 8 rows of 128 tokens at
    base 640, of a resume forward of 1 row (bucket 128) at base 700, and
    of a copy-on-write copy of one page across the 12 layers; then the
    chunk's attention alone, the gathered dense-mask composition (q (8,
    128, 12, 128) over 12 pages) beside the flash forward on the same
    contiguous keys at the same offset (every row at base 1408, where
    the two compute the same function)."""
    from paddle_tpu_torch.models.generation import _make_paged_cache
    from paddle_tpu_torch.models.llama import cached_attention
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    rng = np.random.RandomState(3)
    vocab = eng.model.config.vocab_size
    ids8 = rng.randint(0, vocab, (8, 128))
    rows8 = np.arange(8)
    out = {}
    with torch.no_grad():
        out["chunk_8x128_ms"] = eager_ms(
            lambda: eng._forward(ids8, rows8, np.full((8,), 640, np.int32)),
            calls=5)
        out["chunk_1x128_ms"] = eager_ms(
            lambda: eng._forward(ids8[:1], rows8[:1],
                                 np.full((1,), 640, np.int32)), calls=5)
        out["resume_1x128_ms"] = eager_ms(
            lambda: eng._forward(ids8[:1], rows8[:1],
                                 np.full((1,), 700, np.int32)), calls=5)
        out["prefill_1x128_ms"] = eager_ms(
            lambda: eng._forward(ids8[:1], rows8[:1], 0), calls=5)
        out["cow_copy_1_page_ms"] = eager_ms(
            lambda: eng._dispatch_cow([(0, 1)]), calls=5)
        cfg = eng.model.config
        gen = torch.Generator(device="cuda").manual_seed(9)
        shape = (8, 128, cfg.num_attention_heads, cfg.head_dim)
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(3))
        per_seq = eng._cols
        tables = torch.tensor(np.random.RandomState(4).randint(
            0, eng._pool_pages, (8, per_seq)), device="cuda")
        kp, vp = eng._ks[0], eng._vs[0]
        base = per_seq * eng.page_size - 128
        lengths = torch.full((8,), base, dtype=torch.int32, device="cuda")

        def composed():
            cache = _make_paged_cache(kp, vp, tables, eng.page_size, lengths,
                                      attn_pages=per_seq)
            return cached_attention(q, k, v, cache, lengths, 128)

        got = composed()
        k_all = kp[tables.long()].reshape(8, -1, *kp.shape[2:])
        v_all = vp[tables.long()].reshape(8, -1, *vp.shape[2:])
        flash = fa.flash_attention_fwd(q, k_all, v_all, causal=True)[0]
        out.update(
            composition_ms=graph_ms(composed, calls=5),
            flash_same_keys_ms=graph_ms(
                lambda: fa.flash_attention_fwd(q, k_all, v_all,
                                               causal=True), calls=5),
            composition_vs_flash_max_abs=float(
                (got.float() - flash.float()).abs().max()))
    flops = 4 * 8 * shape[2] * shape[3] * 128 * (base + 64.5)
    out["composition_bound_ms"] = bound_ms(
        4 * q.numel() * 2 + 2 * 8 * per_seq * eng.page_size
        * kp.shape[2] * kp.shape[3] * 2, flops, peaks)[0]
    return out


def kv_long_kernels(peaks):
    """(e): RoPE at a chunk's (8, 128, 12, 128) with per-row positions
    from ROPE_LONG_BASES (up to 1535), both directions; paged decode at
    LONG_LENGTHS (up to 1536) over 12 table columns and a scratch column;
    the decode megakernel at pre-append depths LONG_DEPTHS (up to 1535)
    on the same layout; each against its plain version within the bf16
    gate and timed as the kernel phase times it. Returns the rows of the
    kernels line."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import fused_ops as fo

    gen = seed(7, "cuda")

    def randn(*shape, std=1.0, dtype=None):
        t = torch.randn(shape, generator=gen, device="cuda") * std
        return t if dtype is None else t.to(dtype)

    bf16 = torch.bfloat16
    heads, hd = CFG_438M["num_attention_heads"], 128
    cos, sin = _rope_tables(hd, CFG_438M["max_position_embeddings"],
                            10000.0, "cuda")
    q, k = randn(8, 128, heads, hd, dtype=bf16), randn(8, 128, heads, hd,
                                                       dtype=bf16)
    pos = (torch.tensor(ROPE_LONG_BASES, dtype=torch.int32,
                        device="cuda")[:, None]
           + torch.arange(128, dtype=torch.int32, device="cuda")[None])
    err = 0.0
    for inverse in (False, True):
        for got, want in zip(fo.fused_rope_at(q, k, cos, sin, pos, inverse),
                             fo.fused_rope_plain(q, k, cos, sin, pos,
                                                 inverse)):
            err = max(err, compare("rope(per-row positions)", got, want))
    # the cos/sin rows of the distinct positions (the bases' rows overlap)
    nb = (2 * 2 * q.numel() * 2 + pos.numel() * 4
          + 2 * int(pos.unique().numel()) * hd * 4)
    bms, by = bound_ms(nb, 6 * q.numel(), peaks)
    rope = dict(case="chunk at per-row positions", shape=list(q.shape),
                bases=ROPE_LONG_BASES, max_position=int(pos.max()),
                max_abs_err=err,
                ms=graph_ms(lambda: fo.fused_rope_at(q, k, cos, sin, pos)),
                plain_ms=graph_ms(lambda: fo.fused_rope_plain(q, k, cos, sin,
                                                              pos)),
                library_ms=None, bound_ms=bms, bound_by=by)
    emit("kernel", name="fused_rope", **rope)
    paged = paged_row(da, peaks, e2_pool(lambda *s: randn(*s, dtype=bf16),
                                         heads, heads, hd, per_seq=12,
                                         lens=LONG_LENGTHS))
    emit("kernel", name="paged_attention", case="depths to 1536", **paged)
    torch.cuda.synchronize()

    def mk_randn(*shape, std=1.0):
        return randn(*shape, std=std)

    mk = megakernel_case(peaks, CFG_438M, gen, mk_randn, bf16,
                         "438M, depths to 1535", one_rounding=True,
                         lengths=LONG_DEPTHS, per_seq=12)
    return {"fused_rope[pos=1535]": rope, "paged_attention[len=1536]": paged,
            "fused_decode_layer[len=1535]": mk}


def kv_e9_phase(model, name, smi, peaks):
    """bench.py (e9) and the admission path on the card: (a) the gate,
    (b) e9's dynamic pool against the static layout, (c) e9's prefix
    sweep, (d) long prompts, copy-on-write and preemption on the 438M,
    with its dispatches timed, (e) the kernels at the new shapes. Returns
    (rows of the kernels line, launch counts of (d)'s fused run and of its
    unfused reference)."""
    t0 = time.monotonic()
    vocab = model.config.vocab_size
    # (a)
    gate = [kv_gate(40, torch.bfloat16, MODEL_REL_L2),
            kv_gate(40, torch.float32, F32_MODEL_REL_L2)]
    emit("kv-e9", part="gate", runs=gate)
    # (b)
    rng = np.random.RandomState(31)
    prompts = [rng.randint(0, vocab, (int(rng.choice([6, 10, 18, 40])),))
               .astype(np.int32) for _ in range(KV_E9_REQ)]
    per_seq = KV_E9_LEN // KV_E9_PAGE
    static = kv_dynamic_arm(model, prompts, KV_E9_POOL // per_seq)
    dynamic = kv_dynamic_arm(model, prompts, 4 * KV_E9_POOL // per_seq,
                             KV_E9_POOL)
    gain = dynamic["peak_admitted"] / static["peak_admitted"]
    emit("kv-e9", part="dynamic pool", static=static, dynamic=dynamic,
         kv_admit_gain=gain, gate=2.0)
    for arm in (static, dynamic):
        if (arm["requests_ok"] != KV_E9_REQ or not arm["kv_finite"]
                or arm["pages_free"] + arm["prefix_cached_pages"]
                != arm["pool_pages"]):
            raise PhaseFailed(f"kv-e9 dynamic pool: {arm}")
    if gain < 2.0:
        raise PhaseFailed(f"kv-e9: kv_admit_gain {gain} < 2")
    # (c)
    sys_p = rng.randint(0, vocab, (3 * KV_E9_PAGE,)).astype(np.int32)
    px = [np.concatenate([sys_p, rng.randint(0, vocab, (12,))
                          .astype(np.int32)])
          for _ in range(KV_E9_REQ // 2)]
    cold_s, _, cold_d = kv_prefix_arm(model, px, False)
    warm_s, px_kv, warm_d = kv_prefix_arm(model, px, True)
    speedup = cold_s / warm_s
    emit("kv-e9", part="prefix sweep", cold_s=cold_s, cached_s=warm_s,
         prefix_prefill_speedup=speedup,
         prefix_hit_rate=px_kv["prefix_hit_rate"],
         prefix_tokens_saved=px_kv["prefix_tokens_saved"],
         cold_dispatches=cold_d, cached_dispatches=warm_d)
    if (px_kv["prefix_hit_rate"] <= 0 or speedup < 1.0
            or px_kv["prefix_tokens_saved"] < (len(px) - 1) * len(sys_p)):
        raise PhaseFailed(f"kv-e9 prefix sweep: speedup {speedup}, {px_kv}")
    # (d)
    long_prompts = kv_long_traffic(vocab)
    eng, reqs, launches, delta, secs = kv_long_run(
        model, long_prompts, 1, True, KV_LONG_POOL)
    stats = eng.stats()
    unf, unf_reqs, unf_launches, unf_delta, unf_secs = kv_long_run(
        model, long_prompts, 0, True, KV_LONG_POOL)
    ref, ref_reqs, _, _, ref_secs = kv_long_run(
        model, long_prompts, 1, False, None)
    ties = {arm: kv_partings(model, long_prompts, rs, ref_reqs)
            for arm, rs in (("fused", reqs), ("unfused", unf_reqs))}
    emit("kv-e9", part="long prompts", prompt_lengths=[p.size for p in
                                                       long_prompts],
         pool_pages=KV_LONG_POOL, seconds=secs, counters=delta,
         dispatches=stats["dispatches"], segments=stats["segments"],
         kv=stats["kv"], launches=launches,
         statuses=[r.status for r in reqs],
         tokens_per_sec=stats["tokens_per_sec"],
         unfused=dict(seconds=unf_secs, counters=unf_delta,
                      dispatches=unf.stats()["dispatches"],
                      launches=unf_launches),
         reference=dict(pool_pages=ref._pool_pages, prefix_cache=False,
                        megakernel=True, seconds=ref_secs),
         partings=ties, card=name, nvidia_smi=smi)
    full = [r.status == "ok" and len(r.output()) == KV_LONG_NEW
            for r in reqs + unf_reqs + ref_reqs]
    d = stats["dispatches"]
    bad = [k for k in ("rms_norm", "fused_rope", "flash_attention",
                       "fused_decode_layer") if launches.get(k, 0) <= 0]
    untied = {arm: t["past_tolerance"] for arm, t in ties.items()
              if t["past_tolerance"]}
    if (not all(full) or delta["serving.kv_preempted"] <= 0
            or d["cow_pages"] <= 0 or d["chunk"] <= 0
            or stats["kv"]["prefix_tokens_saved"] <= 0 or bad
            or launches.get("paged_attention", 0)
            or unf_delta != delta or unf.stats()["dispatches"] != d
            or unf_launches.get("paged_attention", 0) <= 0
            or unf_launches.get("fused_decode_layer", 0) or untied
            or not all(bool(torch.isfinite(t).all())
                       for t in eng._ks + eng._vs + unf._ks + unf._vs)):
        raise PhaseFailed(f"kv-e9 long prompts: ok {sum(full)} of "
                          f"{len(full)}, counters {delta} / unfused "
                          f"{unf_delta}, dispatches {d}, launches "
                          f"{launches} / unfused {unf_launches}, streams "
                          f"parting past a bf16 tie {untied}")
    emit("kv-e9", part="dispatch times", card=name, nvidia_smi=smi,
         **kv_dispatch_times(eng, peaks))
    del eng, unf, ref
    torch.cuda.empty_cache()
    # (e)
    rows = kv_long_kernels(peaks)
    emit("kv-e9", part="done", seconds=time.monotonic() - t0)
    return rows, {"kv-e9": launches, "kv-e9-unfused": unf_launches}


FLASH_NAMES = ("flash_attention", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")


def e2_pool(randn, heads, kvh, hd, seed=0, per_seq=4, lens=None):
    """Paged decode inputs in the serving engine's pool layout (8 slots,
    max_len 512, page 128: 4 columns + 1 scratch column, 32 real pages +
    the dump page), scattered tables with dump-page tails, lengths of
    np.random.RandomState(seed).randint(9, 184); or ``per_seq`` columns
    (max_len 128 * per_seq) at the lengths ``lens``. Returns (q, k_pages,
    v_pages, tables, lengths, lengths as numpy, pages per sequence)."""
    b, page = 8, 128
    n_pages = b * per_seq + 1
    dump = n_pages - 1
    rng = np.random.RandomState(seed)
    lens = (rng.randint(9, 184, b) if lens is None
            else np.asarray(lens)).astype(np.int32)
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


def paged_bits(da, args, per_seq, tag):
    """Paged decode gives the same bits twice and from a CUDA graph: two
    eager calls, then a graph of the call captured on a side stream (its
    split scratch made there by a call before capture), replayed twice;
    raises unless all three outputs are equal. Returns True."""
    first = da.paged_attention(*args, pages_per_seq=per_seq)
    again = da.paged_attention(*args, pages_per_seq=per_seq)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.paged_attention(*args, pages_per_seq=per_seq)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        replayed = da.paged_attention(*args, pages_per_seq=per_seq)
    g.replay()
    g.replay()
    torch.cuda.synchronize()
    if not (torch.equal(first, again) and torch.equal(first, replayed)):
        raise PhaseFailed(f"{tag}: two calls, or a graph replay and an "
                          f"eager call, differ")
    return True


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
    bits = paged_bits(da, args, per_seq, f"paged_attention(d={hd})")
    toks = int(np.minimum(lens, per_seq * page).sum())
    size = q.element_size()
    nb = (2 * q.numel() * size + 2 * toks * kvh * hd * size
          + tab.numel() * 4 + b * 4)
    bms, by = bound_ms(nb, 4 * toks * heads * hd, peaks,
                       flop_rate=peaks[2] if f32 else None)
    return dict(
        shape=[b, heads, hd], kv_heads=kvh, lengths=lens.tolist(),
        max_abs_err=err, bit_identical=bits,
        ms=graph_ms(lambda: da.paged_attention(*args,
                                               pages_per_seq=per_seq)),
        plain_ms=graph_ms(lambda: da.paged_attention_plain(
            *args, pages_per_seq=per_seq)),
        library_ms=None,
        eager_ms=eager_ms(lambda: da.paged_attention(
            *args, pages_per_seq=per_seq)),
        bound_ms=bms, bound_by=by)


# paged decode past 8 query heads per kv head: (heads, kv heads) of
# Mistral-Large-2 (group 12), Llama-3.1-405B (group 16) and multi-query
# attention (group 32)
PAGED_GROUP_CASES = [(96, 8), (128, 8), (32, 1)]


def paged_group_phase(peaks):
    """Paged decode at the groups of PAGED_GROUP_CASES, where the kernel
    cuts a group into chunks of at most 8 query heads, a block each: at D
    = 128 and 64, in bf16 and f32, in e2's pool layout and lengths, each
    against its plain version and timed (``paged_row``). Returns the
    kernels line's row: Mistral-Large-2's q (8, 96, 128) on 8 kv heads in
    bf16."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(13)
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        f32 = dtype == torch.float32
        for heads, kvh in PAGED_GROUP_CASES:
            for hd in (128, 64):
                rec = paged_row(da, peaks, e2_pool(randn, heads, kvh, hd),
                                f32=f32)
                emit("kernel", name="paged_attention" + ("[f32]" if f32
                                                         else ""),
                     case=f"group {heads // kvh}, d {hd}", **rec)
                if (heads, kvh, hd, f32) == (96, 8, 128, False):
                    results["paged_attention[g=12]"] = rec
    torch.cuda.synchronize()
    return results


# lengths of the paged-edge case: 0, 1, every multiple of the kernel's
# 32-token tile +-1 up to the walk's cap (512: 4 columns of 128), so every
# split boundary of any plan, and one past the cap (clamped)
PAGED_EDGE_LENGTHS = ([0, 1] + [32 * k + o for k in range(1, 17)
                                for o in (-1, 0, 1)] + [600])
# (heads, kv heads, D, dtype): e2's, Mistral-Large-2's group 12, Phi-3's
# 96, 256 on 2 kv heads and 100 (rows off 16 bytes: the element path) in
# bf16; e2's and 36 in f32
PAGED_EDGE_CASES = [(12, 12, 128, torch.bfloat16), (96, 8, 128, torch.bfloat16),
                    (32, 32, 96, torch.bfloat16), (16, 2, 256, torch.bfloat16),
                    (8, 2, 100, torch.bfloat16), (12, 12, 128, torch.float32),
                    (8, 2, 36, torch.float32)]


def paged_edge_phase():
    """Paged decode at PAGED_EDGE_LENGTHS in e2's pool layout (page 128,
    4 columns + a scratch column, scattered pages, dump-page tails), at
    PAGED_EDGE_CASES: each against its plain version within its dtype's
    gate, the row of length 0 exactly 0, and ``paged_bits``. Prints the
    split plan of each case."""
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(14)
    page, per_seq = 128, 4
    lens = np.asarray(PAGED_EDGE_LENGTHS, np.int32)
    b = len(lens)
    n_pages = b * per_seq + 1
    rng = np.random.RandomState(14)
    tables = np.full((b, per_seq + 1), n_pages - 1, np.int32)
    perm, used = rng.permutation(n_pages - 1), 0
    for i, n in enumerate(lens):
        k = min(-(-int(n) // page), per_seq)
        tables[i, :k] = perm[used:used + k]
        used += k
    tab = torch.tensor(tables, device="cuda")
    ln = torch.tensor(lens, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for heads, kvh, hd, dtype in PAGED_EDGE_CASES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        f32 = dtype == torch.float32
        q = randn(b, heads, hd)
        kp, vp = randn(n_pages, page, kvh, hd), randn(n_pages, page, kvh, hd)
        args = (q, kp, vp, tab, ln)
        tag = f"paged_attention{'[f32]' if f32 else ''}(edge, {heads} on " \
              f"{kvh}, d={hd})"
        got = da.paged_attention(*args, pages_per_seq=per_seq)
        err = (f32_compare if f32 else compare)(
            tag, got, da.paged_attention_plain(*args, pages_per_seq=per_seq))
        if not bool((got[0] == 0).all()):
            raise PhaseFailed(f"{tag}: the row of length 0 is not 0")
        emit("paged-edge", name="paged_attention" + ("[f32]" if f32 else ""),
             shape=[b, heads, hd], kv_heads=kvh, max_abs_err=err,
             plan=dict(zip(("chunks", "per", "ts", "nsplit"), da.split_plan(
                 b, kvh, heads // kvh, per_seq * page, sms))),
             bit_identical=paged_bits(da, args, per_seq, tag))
    torch.cuda.synchronize()


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
        launches_ms=launch_split(lambda: rn.rms_norm_bwd(x, w, r, g)),
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
    card, cpu = card_and_cpu(cfg, 2, dtype)
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
                 "flash_attention_bwd_dq", "multi_tensor_adam")


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
                          else 1 if k == "multi_tensor_adam" else layers)
                for k in TRAIN_KERNELS}
        if counts != want or others:
            raise PhaseFailed(f"{phase}: launches {counts} (want {want}), "
                              f"others {others}")
    return counts


# ---- the optimizer's update: the multi-tensor Adam kernel
# (csrc/multi_tensor_adam.cu), and bench.py section (b2)

# kernel against plain: f32 work values to 1e-6 relative (the same IEEE
# operations in the same order; powf may differ by an ulp), bf16 work
# values (Adam without multi_precision, as JAX runs it in bf16) and bf16
# moment1 stores within one bf16 ulp
ADAM_F32_TOL, ADAM_BF16_TOL = (1e-9, 1e-6), (1e-6, 2.0 ** -8)
ADAM_STEPS = 3
# bench.py (b2) (bench.py:240-262): the 1.28B LLaMA with recompute, tied
# embeddings, the fused lm-head CE and AdamW(acc_dtype="bfloat16")
CFG_LLAMA_LARGE = dict(vocab_size=32000, hidden_size=2048,
                       intermediate_size=5504, num_hidden_layers=24,
                       num_attention_heads=16, max_position_embeddings=2048,
                       use_recompute=True, tie_word_embeddings=True)
LARGE_BATCH, LARGE_SEQ, LARGE_STEPS = 2, 2048, 4
# odd sizes for the Adam case: off the 8-element vector and the chunk
ADAM_ODD_SHAPES = [(1,), (7,), (33, 129), (16387,), (3 * 16384 + 5,),
                   (4099, 3), (2048, 64), (513,)]


def plain_optimizer(cls):
    """``cls`` (Adam or AdamW) with its update through the plain version on
    every device: the same parameter groups, clips, state and launch
    groups, no kernel."""
    from paddle_tpu_torch.ops.cuda.multi_tensor_adam import (
        multi_tensor_adam_plain,
    )

    class Plain(cls):
        def _update(self, indices, grads, slots, state):
            for members, group in self._launch_groups(indices, slots):
                multi_tensor_adam_plain(
                    group, [grads[k] for k in members], state,
                    beta1=self._beta1, beta2=self._beta2,
                    epsilon=self._epsilon, coupled=self._coupled)

    Plain.__name__ = "Plain" + cls.__name__
    return Plain


def llama_shapes(cfg):
    """The parameter shapes of ``LlamaForCausalLM`` at ``cfg`` (a dict)."""
    h, i, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    heads = cfg["num_attention_heads"]
    kv = (cfg.get("num_key_value_heads") or heads) * (h // heads)
    layer = [(h, h), (h, kv), (h, kv), (h, h), (h, i), (h, i), (i, h), (h,),
             (h,)]
    return ([(v, h)] + layer * cfg["num_hidden_layers"] + [(h,)]
            + ([] if cfg.get("tie_word_embeddings") else [(h, v)]))


def adam_cases():
    """(case, shapes, parameter dtype, optimizer class name, optimizer
    keywords, groups): the 438M's parameters under b-438M's AdamW; the
    1.28B's under bench.py (b2)'s; the 438M's in f32 (no master); in f32
    with acc_dtype bf16; odd sizes in bf16 under Adam without
    multi_precision (bf16 work values), coupled decay, two groups (the
    second at half the rate and its own decay) and a global-norm clip that
    bites."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    mp = dict(learning_rate=1e-4, multi_precision=True)
    return [
        ("llama-438m", llama_shapes(CFG_438M), torch.bfloat16, "AdamW", mp,
         None),
        ("llama-1.28b", llama_shapes(CFG_LLAMA_LARGE), torch.bfloat16,
         "AdamW", dict(mp, acc_dtype="bfloat16"), None),
        ("f32", llama_shapes(CFG_438M), torch.float32, "AdamW", mp, None),
        ("acc-bf16", llama_shapes(CFG_438M), torch.float32, "AdamW",
         dict(learning_rate=1e-4, acc_dtype="bfloat16"), None),
        ("adam-groups", ADAM_ODD_SHAPES, torch.bfloat16, "Adam",
         dict(learning_rate=1e-3, weight_decay=0.01,
              grad_clip=ClipGradByGlobalNorm(1e-2)),
         [dict(), dict(learning_rate=0.5, weight_decay=0.1)]),
    ]


def adam_grads(shapes, dtype, step):
    """Step ``step``'s gradients, drawn from a seed of their own."""
    gen = torch.Generator(device="cuda").manual_seed(100 + step)
    return [(1e-2 * torch.randn(s, generator=gen, device="cuda")).to(dtype)
            for s in shapes]


def adam_optimizer(cls, params, kw, groups):
    if groups is None:
        return cls(parameters=params, **kw)
    half = len(params) // 2
    return cls(parameters=[dict(g, params=ps) for g, ps in
                           zip(groups, (params[:half], params[half:]))], **kw)


def adam_state(opt, group):
    """Every state tensor of the launch group, in a fixed order."""
    return [t for ts in (group.params, group.masters, group.moment1,
                         group.moment2) for t in ts if t is not None]


def adam_case(peaks, case, shapes, dtype, cls_name, kw, groups):
    """The update kernel against its plain version (``plain_optimizer``)
    on the same parameters and gradients, ADAM_STEPS steps through the
    optimizer; then the launch alone: a graph replay against the eager
    call bit for bit, its time (a CUDA graph), the plain version's, and
    ``torch._fused_adamw_``'s over the same elements in f32."""
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.ops.cuda import launch_counts
    from paddle_tpu_torch.ops.cuda import multi_tensor_adam as mta

    cls = getattr(topt, cls_name)
    gen = torch.Generator(device="cuda").manual_seed(7)
    init = [(0.02 * torch.randn(s, generator=gen, device="cuda")).to(dtype)
            for s in shapes]
    sides = []
    for c in (cls, plain_optimizer(cls)):
        ps = [torch.nn.Parameter(p.clone()) for p in init]
        sides.append((ps, adam_optimizer(c, ps, kw, groups)))
    del init
    launch_counts.clear()
    for step in range(1, ADAM_STEPS + 1):
        gs = adam_grads(shapes, dtype, step)
        for ps, opt in sides:
            for p, g in zip(ps, gs):
                p.grad = g
            opt.step()
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    (kps, kopt), (pps, popt) = sides
    (kgroups,), (pgroups,) = kopt._groups.values(), popt._groups.values()
    if len(kgroups) != 1:
        raise PhaseFailed(f"adam-kernel {case}: {len(kgroups)} launch groups")
    (_, group), (_, pgroup) = kgroups[0], pgroups[0]
    f32 = group.work_dtype == torch.float32
    atol, rtol = ADAM_F32_TOL if f32 else ADAM_BF16_TOL
    err = 0.0
    for a, b in zip(adam_state(kopt, group), adam_state(popt, pgroup)):
        tol = (atol, rtol) if a.dtype == group.work_dtype else ADAM_BF16_TOL
        err = max(err, compare(f"adam-kernel {case}", a, b, *tol))
    tag = "[f32]" if dtype == torch.float32 else ""
    if counts != {"multi_tensor_adam" + tag: ADAM_STEPS}:
        raise PhaseFailed(f"adam-kernel {case}: launches {counts}")
    n_slots = max(group.slots) + 1
    state = kopt._state_bufs[group.device][:2 + n_slots]
    clip_scales = state[2:].tolist()
    if groups is not None and not (n_slots == len(groups)
                                   and max(clip_scales) < 1):
        raise PhaseFailed(f"adam-kernel {case}: the clip does not bite in "
                          f"each group: scales {clip_scales}")
    pstate = popt._state_bufs[group.device][:2 + n_slots]
    gs = adam_grads(shapes, dtype, ADAM_STEPS + 1)
    args = dict(beta1=kopt._beta1, beta2=kopt._beta2, epsilon=kopt._epsilon,
                coupled=kopt._coupled)
    numel = sum(p.numel() for p in kps)
    calls, replays = (2, 2) if numel > 5e8 else (5, 4)
    plain_ms = graph_ms(lambda: mta.multi_tensor_adam_plain(
        pgroup, gs, pstate, **args), calls=calls, replays=replays)
    del sides, pps, popt, pgroups, pgroup
    torch.cuda.empty_cache()
    # a graph replay of the launch gives the eager launch's bits
    mta.multi_tensor_adam(group, gs, state, **args)  # the pointer column
    snap = [t.clone() for t in adam_state(kopt, group)]
    mta.multi_tensor_adam(group, gs, state, **args)
    eager = [t.clone() for t in adam_state(kopt, group)]
    for t, s in zip(adam_state(kopt, group), snap):
        t.copy_(s)
    del snap
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        mta.multi_tensor_adam(group, gs, state, **args)
    g.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(adam_state(kopt, group),
                                                  eager))
    del eager, g
    if not same:
        raise PhaseFailed(f"adam-kernel {case}: a graph replay differs "
                          f"from the eager launch")
    ms = graph_ms(lambda: mta.multi_tensor_adam(group, gs, state, **args),
                  calls=calls, replays=replays)
    del kps, kopt
    torch.cuda.empty_cache()
    # the library yardstick: one fused AdamW over the same elements in f32
    lib = [[torch.zeros(s, device="cuda") for s in shapes] for _ in range(4)]
    steps_t = [torch.ones((), device="cuda") for _ in shapes]
    library_ms = graph_ms(lambda: torch._fused_adamw_(
        lib[0], lib[1], lib[2], lib[3], [], steps_t, lr=1e-4, beta1=0.9,
        beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
        maximize=False), calls=calls, replays=replays)
    del lib, steps_t
    torch.cuda.empty_cache()
    p_b = 4 if dtype == torch.float32 else 2
    m_b = 2 if group.m1_dtype == torch.bfloat16 else 4
    w_b = 4 if f32 else 2
    per = (p_b + (8 + p_b if group.has_master else 2 * p_b) + 2 * m_b
           + 2 * w_b)
    bms, by = bound_ms(per * numel, 18 * numel, peaks, flop_rate=peaks[2])
    row = dict(case=case, tensors=len(shapes), numel=numel,
               dtype=str(dtype), master=group.has_master,
               moment1=str(group.m1_dtype), work=str(group.work_dtype),
               bytes_per_element=per, max_abs_err=err, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bms,
               bound_by=by, bound_share=bms / ms, graph_bits=same,
               clip_scales=clip_scales, launches=counts)
    emit("adam-kernel", **row)
    return row


def adam_kernel_phase(peaks):
    """Phase adam-kernel: ``adam_case`` for each of ``adam_cases()``.
    Returns the kernels line's rows: the 1.28B's (bf16 masters, bf16
    moment1) and the 438M's in f32."""
    t0 = time.monotonic()
    rows = {case[0]: adam_case(peaks, *case) for case in adam_cases()}
    emit("adam-kernel", seconds=time.monotonic() - t0)
    return {"multi_tensor_adam": rows["llama-1.28b"],
            "multi_tensor_adam[f32]": rows["f32"]}


def recompute_gate(cfg, ids):
    """2 layers at ``cfg``'s widths, bf16 on the card: the labels loss and
    every gradient with ``use_recompute=True`` equal the run without it
    bit for bit."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    runs, weights = [], None
    for rec in (True, False):
        c = LlamaConfig(**{**cfg, "num_hidden_layers": 2,
                           "use_recompute": rec})
        model = LlamaForCausalLM(c, device="cuda", dtype=torch.bfloat16,
                                 generator=seed(3, "cuda"))
        if weights is None:
            weights = model.state_dict()
        else:
            model.load_state_dict(weights)
        loss = model(ids, None, None, ids)
        loss.backward()
        runs.append((loss.detach(), {k: p.grad for k, p in
                                     model.named_parameters()}))
        del model
    (la, ga), (lb, gb) = runs
    torch.cuda.synchronize()
    differ = [k for k in ga if not torch.equal(ga[k], gb[k])]
    same = bool(torch.equal(la, lb)) and not differ
    emit("llama-large-train", recompute_gate_layers=2, loss=float(la),
         loss_without=float(lb), bits_equal=same, grads_differ=differ)
    if not same:
        raise PhaseFailed(f"llama-large-train: recompute changes the loss "
                          f"({float(la)} vs {float(lb)}) or {differ}")


def llama_large_workload():
    """bench.py section (b2)'s training step on the card: the 1.28B LLaMA
    (CFG_LLAMA_LARGE) in bf16 (random weights from seed 0),
    AdamW(learning_rate=1e-4, multi_precision=True, acc_dtype="bfloat16"),
    ``TrainStep(model, lambda loss: loss, opt)``, and batch LARGE_BATCH x
    LARGE_SEQ ids from np.random.RandomState(0). Returns (model,
    optimizer, step, ids); a step is ``step(ids, None, None, ids)``."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig(**CFG_LLAMA_LARGE)
    model = LlamaForCausalLM(cfg, device="cuda", dtype=torch.bfloat16,
                             generator=seed(0, "cuda"))
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True, acc_dtype="bfloat16")
    step = TrainStep(model, lambda loss: loss, opt)
    ids = torch.tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (LARGE_BATCH, LARGE_SEQ)), device="cuda")
    return model, opt, step, ids


def llama_large_train_phase(name, smi, peaks):
    """bench.py section (b2) as written: the 1.28B LLaMA (CFG_LLAMA_LARGE:
    recompute, tied embeddings) in bf16, AdamW(learning_rate=1e-4,
    multi_precision=True, acc_dtype="bfloat16"), ``TrainStep(model, lambda
    loss: loss, opt)`` with the labels passed positionally (the fused
    lm-head CE), batch 2 x seq 2048 ids from np.random.RandomState(0); a
    warm-up step, whose launches are counted, and LARGE_STEPS steps timed
    by CUDA events. Gated: finite losses, the first within 1.0 of ln
    32000, falling; each training kernel at its exact count a step, with
    recompute's second forward (flash forward and RoPE 2 L, RMSNorm
    forward 4 L + 1), and the update once; first, ``recompute_gate``."""
    from paddle_tpu_torch.ops.cuda import launch_counts

    t0 = time.monotonic()
    ids = torch.tensor(np.random.RandomState(0).randint(
        0, CFG_LLAMA_LARGE["vocab_size"], (LARGE_BATCH, LARGE_SEQ)),
        device="cuda")
    recompute_gate(CFG_LLAMA_LARGE, ids)
    del ids
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, opt, step, ids = llama_large_workload()
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    launch_counts.clear()
    losses = [float(step(ids, None, None, ids))]
    torch.cuda.synchronize()
    counts = dict(launch_counts)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(LARGE_STEPS + 1)]
    timed = []
    events[0].record()
    for i in range(LARGE_STEPS):
        timed.append(step(ids, None, None, ids))
        events[i + 1].record()
    torch.cuda.synchronize()
    losses += [float(x) for x in timed]
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(LARGE_STEPS)]
    steady = float(np.median(step_ms))
    tokens_per_sec = LARGE_BATCH * LARGE_SEQ / (steady / 1e3)
    layers = cfg.num_hidden_layers
    flops_per_token = (6 * n_params
                       + 12 * layers * cfg.hidden_size * LARGE_SEQ)
    mfu = tokens_per_sec * flops_per_token / peaks[1]
    want = {"rms_norm": 4 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
            "fused_rope": 2 * layers, "fused_rope_bwd": layers,
            "flash_attention": 2 * layers,
            "flash_attention_bwd_dkdv": layers,
            "flash_attention_bwd_dq": layers, "multi_tensor_adam": 1}
    emit("llama-large-train", params=n_params, batch=LARGE_BATCH,
         seq=LARGE_SEQ, steps=LARGE_STEPS, step_ms=step_ms,
         step_ms_median=steady, tokens_per_sec=tokens_per_sec,
         flops_per_token=flops_per_token, mfu=mfu,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         losses=losses, launches_per_step=counts, card=name, nvidia_smi=smi,
         seconds=time.monotonic() - t0)
    first, last = losses[0], losses[-1]
    if not all(np.isfinite(losses)):
        raise PhaseFailed(f"llama-large-train: a loss is not finite: "
                          f"{losses}")
    if abs(first - np.log(cfg.vocab_size)) > 1.0:
        raise PhaseFailed(f"llama-large-train: first loss {first:.4f} is "
                          f"more than 1.0 from ln {cfg.vocab_size}")
    if not last < first:
        raise PhaseFailed(f"llama-large-train: loss did not fall: {losses}")
    if counts != want:
        raise PhaseFailed(f"llama-large-train: launches a step {counts}, "
                          f"want {want}")
    del model, opt, step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
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
                "flash_attention_bwd_dq")  # L a step each; the update once
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
    to the composition route and AdamW updates the f32 weights through
    its plain version (no kernel of the port runs, which the launch counts
    confirm)."""
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
                     plain_optimizer(AdamW)(
                         learning_rate=1e-4, parameters=model.parameters(),
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
    want["multi_tensor_adam"] = 1
    got = {k: counts.get(k, 0) for k in (*want, *BERT_ABSENT)}
    if got != {**want, **{k: 0 for k in BERT_ABSENT}}:
        raise PhaseFailed(f"bert-train: launches per step {got}, want "
                          f"{want} and none of {BERT_ABSENT}")
    return counts


# ---- head dims off 64 and 128, and a LLaMA at Phi-3-mini's widths

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
        launches_ms=launch_split(lambda: rn.rms_norm_bwd(x, w, r, g)),
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
    # the decode step's q, k (8, 1, 32, 96) at per-slot positions
    q, k = randn(8, 1, 32, 96), randn(8, 1, 32, 96)
    pos = torch.randint(0, 183, (8, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    err = max(compare("fused_rope(d=96, decode)", got, want)
              for inverse in (False, True)
              for got, want in zip(
                  fo.fused_rope_at(q, k, cos, sin, pos, inverse),
                  fo.fused_rope_plain(q, k, cos, sin, pos, inverse)))
    emit("kernel", name="fused_rope", case="phi3 decode", max_abs_err=err,
         **rope_decode_row(fo, peaks, q, k, cos, sin, pos))
    torch.cuda.synchronize()
    return results


def llama_serve_phase(phase, cfg, gate_layers, seeds, name, smi, arms,
                      captured=None):
    """A LLaMA at ``cfg``'s published widths in bf16 (random N(0, 0.02)
    weights from ``seed(seeds[0])``) behind the engine on e2's traffic
    (``serving_workload``: 8 slots, max_len 512, page 128, buckets (32,
    128), 24 requests of 8-119 prompt tokens from RandomState(7), 64 new
    tokens each, greedy, segments of 32), one ``serving_arm`` run for each
    (decode_megakernel, fused) of ``arms``, in order. First the gate: a
    ``gate_layers``-layer model of the same widths (from
    ``seed(seeds[1])``), bf16 on the card against f32 on the CPU, a
    bucket-128 prefill of 2 prompts and 4 decode steps through the paged
    cache, logits within MODEL_REL_L2. ``captured`` (decode_megakernel,
    fused, cell) runs ``captured_phase`` on the model after the arms.
    Returns each arm's ``serving_arm`` record, by its arm name ("fused",
    "unfused")."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.monotonic()
    small = LlamaConfig(**{**cfg, "num_hidden_layers": gate_layers})
    card, cpu = card_and_cpu(small, seeds[1])
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, small.vocab_size, (2, 128))
    steps = rng.randint(0, small.vocab_size, (4, 2))
    got, _ = prefill_decode(card, prompts, steps)
    want, _ = prefill_decode(cpu, prompts, steps)
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(got, want)]
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    del card, cpu
    torch.cuda.empty_cache()
    gate_s = time.monotonic() - t0
    emit(phase, gate_layers=gate_layers, gate_rel_l2=rel,
         gate_tolerance=MODEL_REL_L2, gate_seconds=gate_s)
    if not finite or max(rel) > MODEL_REL_L2:
        raise PhaseFailed(f"{phase}: {gate_layers}-layer logits finite="
                          f"{finite}, rel L2 {rel}")

    torch.cuda.reset_peak_memory_stats()
    model = LlamaForCausalLM(LlamaConfig(**cfg), device="cuda",
                             dtype=torch.bfloat16, generator=seed(seeds[0],
                                                                  "cuda"))
    recs = {}
    for decode_megakernel, fused in arms:
        _, _, _, rec = serving_arm(model, decode_megakernel, name, smi,
                                   phase, fused)
        recs[rec["arm"]] = rec
    if captured is not None:
        decode_megakernel, fused, cell = captured
        captured_phase(cell, model, decode_megakernel, name, smi, fused)
    lcfg = model.config
    emit(phase, layers=lcfg.num_hidden_layers,
         params=sum(p.numel() for p in model.parameters()),
         heads=lcfg.num_attention_heads, kv_heads=lcfg.num_key_value_heads,
         head_dim=lcfg.head_dim,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         seconds=time.monotonic() - t0, card=name, nvidia_smi=smi)
    del model
    torch.cuda.empty_cache()
    return recs


def phi3_serve_phase(name, smi):
    """The 32-layer model at Phi-3-mini's widths (head dim 96) through
    ``llama_serve_phase`` (2-layer gate), in two arms: the engine's
    default decode_megakernel=1, which fuses (the megakernel takes head
    dim 96; JAX's probe declines this model, whose q/k/v/o
    weights pass its VMEM budget), then decode_megakernel=0, which keeps
    paged decode at 96 on the path. Returns (unfused, fused) counts."""
    recs = llama_serve_phase("phi3-serve", CFG_PHI3, 2, (0, 20), name,
                             smi, ((1, True), (0, False)),
                             captured=(1, True, "phi3-serve fused"))
    return recs["unfused"]["launches"], recs["fused"]["launches"]


# Mistral-Large-Instruct-2407's published widths (its config.json): 88
# layers of 96 heads of 128 on 8 kv heads, a GQA group of 12
CFG_MISTRAL_LARGE = dict(vocab_size=32768, hidden_size=12288,
                         intermediate_size=28672, num_hidden_layers=88,
                         num_attention_heads=96, num_key_value_heads=8,
                         max_position_embeddings=131072, rms_norm_eps=1e-5,
                         rope_theta=1e6, tie_word_embeddings=False)
# mistral-large-serve's depth cut: 4 of the 88 layers (about 6.3 B
# parameters, 12.7 GB in bf16)
MISTRAL_LARGE_LAYERS = 4


def mistral_large_serve_phase(name, smi):
    """MISTRAL_LARGE_LAYERS layers at Mistral-Large-2's widths through
    ``llama_serve_phase`` (1-layer gate, ~8.8 GB of f32 on the CPU) with
    the engine's default decode_megakernel=1: both packages' probes
    decline the layer (hidden 12288 > MAX_HIDDEN here; its 0.6 GB of
    q/k/v/o pass JAX's VMEM budget), so decode runs unfused, through paged
    decode at a group of 12, once a layer a decode step; the prefill
    takes the flash forward at group 12. Returns the run's counts."""
    cfg = {**CFG_MISTRAL_LARGE, "num_hidden_layers": MISTRAL_LARGE_LAYERS}
    rec = llama_serve_phase("mistral-large-serve", cfg, 1, (50, 51),
                            name, smi, ((1, False),),
                            captured=(1, False, "mistral-large-serve"))[
                                "unfused"]
    counts, steps = rec["launches"], rec["decode_steps"]
    layers = MISTRAL_LARGE_LAYERS
    if counts.get("paged_attention", 0) != layers * steps:
        raise PhaseFailed(f"mistral-large-serve: paged_attention launched "
                          f"{counts.get('paged_attention', 0)} times, want "
                          f"{layers} x {steps} decode steps")
    # every forward, a decode step's or a prefill's (one flash launch a
    # layer), launches the wide RMSNorm once a norm: 2 a layer and the
    # final one
    prefills, rest = divmod(counts.get("flash_attention", 0), layers)
    norms = (2 * layers + 1) * (steps + prefills)
    if rest or counts.get("rms_norm", 0) != norms:
        raise PhaseFailed(f"mistral-large-serve: rms_norm launched "
                          f"{counts.get('rms_norm', 0)} times, want "
                          f"{2 * layers + 1} norms x ({steps} decode steps + "
                          f"{prefills} prefills); flash_attention "
                          f"{counts.get('flash_attention', 0)}")
    emit("mistral-large-serve", rms_norm_per_decode_step=(
        counts["rms_norm"] / (steps + prefills)), prefills=prefills)
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
F32_SERVE_RUNS = 2
# f32-grad, a 2-layer model at the 438M's widths in f32 on the card against
# f32 on the CPU: the loss (and the labels= loss) to 1e-5 relative, each
# gradient to 1e-4 relative L2. f32 sums in other orders give ~1e-6; one
# bf16 rounding on the path gives ~1e-3 and a TF32 one ~3e-4
F32_LOSS_REL, F32_GRAD_REL_L2 = 1e-5, 1e-4
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
    version (out and lse), timed beside its bound, the plain version and
    F.scaled_dot_product_attention on the same f32 inputs (TF32 off). The
    kernel takes its products in 3xTF32, so its bound is the larger of the
    bytes over the memory rate and three TF32 products a flop over the
    TF32 tensor-core peak; ``fma_bound_ms`` keeps the flops over the f32
    FMA rate, the first design's bound."""
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
    nb = 4 * q.numel() * 4 + lse.numel() * 4
    bms, by = bound_ms(nb, 3 * flops, peaks, flop_rate=peaks[3])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec = dict(case=case, shape=[b, s, h, d], kv_heads=kvh, causal=True,
               max_abs_err=err,
               fma_bound_ms=bound_ms(nb, flops, peaks, flop_rate=peaks[2])[0],
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
    # the wide kernel in f32 (past 2048): a decode step's rows at Phi-3's
    # and Mistral-Large-2's hidden (on no f32 path yet)
    for d in (CFG_PHI3["hidden_size"], CFG_MISTRAL_LARGE["hidden_size"]):
        x, wd, bd = randn(8, d), 1.0 + 0.1 * randn(d), 0.1 * randn(d)
        err = 0.0
        for wt, bt in ((wd, None), (wd, bd), (None, bd), (None, None)):
            y, r = rn.rms_norm_rows(x, wt, bt, epsilon=1e-5)
            py, pr = rn.rms_norm_plain(x, wt, bt, epsilon=1e-5)
            err = max(err, f32_compare(f"rms_norm[f32](8, {d})", y, py))
            if (r - pr).abs().max().item() > 1e-5 * pr.abs().max().item():
                raise PhaseFailed(f"rms_norm[f32](8, {d}): per-row r "
                                  "disagrees")
        bms, by = bound_ms(2 * 8 * d * 4 + d * 4 + 8 * 4, 4 * 8 * d, peaks,
                           flop_rate=peaks[2])
        emit("f32-kernel", name="rms_norm[f32]", case="wide", shape=[8, d],
             max_abs_err=err,
             ms=graph_ms(lambda: rn.rms_norm_rows(x, wd, epsilon=1e-5)),
             plain_ms=graph_ms(lambda: rn.rms_norm_plain(x, wd,
                                                         epsilon=1e-5)),
             library_ms=graph_ms(lambda: torch.nn.functional.rms_norm(
                 x, (d,), wd, 1e-5)),
             bound_ms=bms, bound_by=by)

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
    for inverse in (False, True):
        for got, want in zip(
                fo.fused_rope_at(dq, dk, cos, sin, dpos, inverse),
                fo.fused_rope_plain(dq, dk, cos, sin, dpos, inverse)):
            err = max(err, f32_compare("fused_rope[f32](decode)", got,
                                       want))
    emit("f32-kernel", name="fused_rope[f32]", case="decode",
         **rope_decode_row(fo, peaks, dq, dk, cos, sin, dpos, f32=True))
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
    gate (the forward's out and lse too, against its plain version); each
    timed (a CUDA graph of 3 calls) beside its bound (the kernels take
    their products in 3xTF32: the larger of the bytes over the memory
    rate and three TF32 products a flop over the TF32 tensor-core peak,
    the flops over the visible pairs, counted from the ids with segments;
    ``fma_bound_ms`` keeps the flops over the f32 FMA rate, the first
    design's bound), the plain backward and ``autograd.grad`` through
    ``F.scaled_dot_product_attention`` in f32 (with a dense boolean mask
    for segments). ``seg`` is one (b, s) id array shared by both sides.
    Returns {kernel name: row}."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    tag = f"[f32]({case})"
    q, do = randn(b, s, h, d), randn(b, s, h, d)
    k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, seg, seg)
    # the forward kernel (3xTF32) at this shape too, at the same gate
    pout, plse = fa.flash_attention_fwd_plain(q, k, v, causal, seg, seg)
    fwd_err = max(f32_compare("out" + tag, out, pout),
                  f32_compare("lse" + tag, lse, plse))
    del pout, plse
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
        bms, by = bound_ms(nb, 3 * flops, peaks, flop_rate=peaks[3])
        rec = dict(case=case, shape=[b, s, h, d], kv_heads=kvh,
                   causal=causal, route=route, pairs=pairs,
                   max_abs_err=errs[kname], fwd_max_abs_err=fwd_err,
                   ms=graph_ms(fn, calls=3, replays=3), plain_ms=plain,
                   library_ms=lib, bound_ms=bms, bound_by=by,
                   fma_bound_ms=bound_ms(nb, flops, peaks,
                                         flop_rate=peaks[2])[0])
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


def f32_serve_phase(name, smi):
    """The 438M LLaMA in f32 (the JAX model's default) behind the engine on
    e2's traffic in two arms, its default decode_megakernel=1, which now
    fuses (``fused_decode_layer[f32]``; JAX's probe declines this model in
    f32, as in bf16, by its VMEM budget), and decode_megakernel=0 (paged
    decode in f32), each F32_SERVE_RUNS times, in turns with a run of the
    bf16 unfused arm (decode_megakernel=0, the same weights rounded to
    bf16), through ``serving_arm``'s gates. First the gate: the f32
    model's logits on the card (a bucket-128 prefill of 2 prompts and 4
    decode steps, unfused and then fused) within F32_MODEL_REL_L2 of the
    same weights on the CPU, and the fused steps' pools within the f32
    kernel gate of the unfused steps'. Reports tokens/s, launches per
    decode step, peak memory, the device's idle share (one more run of
    each f32 arm under torch.profiler) and how far the greedy streams
    agree.
    Returns the first runs' launch counts of the f32 arms, (unfused,
    fused)."""
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    t0 = time.monotonic()
    cfg = LlamaConfig(**CFG_438M)
    card, cpu = card_and_cpu(cfg, 30, dtype=torch.float32)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab_size, (2, 128))
    steps = rng.randint(0, cfg.vocab_size, (4, 2))
    want, _ = prefill_decode(cpu, prompts, steps)
    gate = {}
    for arm, fused in (("unfused", False), ("fused", True)):
        got, caches = prefill_decode(card, prompts, steps, fused)
        gate[arm] = dict(
            rel=[float((a - b).norm() / b.norm()) for a, b in zip(got, want)],
            agree=[float((a.argmax(-1) == b.argmax(-1)).float().mean())
                   for a, b in zip(got, want)],
            finite=all(bool(torch.isfinite(a).all()) for a in got),
            pools=[(c.k_pages, c.v_pages) for c in caches])
    del cpu
    pool_err = max(f32_compare(f"f32-serve pools, layer {i}", f, u)
                   for i, (fp, up) in enumerate(zip(gate["fused"]["pools"],
                                                    gate["unfused"]["pools"]))
                   for f, u in zip(fp, up))
    emit("f32-serve", **{f"gate_{arm}_rel_l2": g["rel"]
                         for arm, g in gate.items()},
         **{f"gate_{arm}_argmax_agree": g["agree"]
            for arm, g in gate.items()},
         gate_tolerance=F32_MODEL_REL_L2,
         fused_vs_unfused_pools_max_abs=pool_err,
         gate_seconds=time.monotonic() - t0)
    for arm, g in gate.items():
        if not g["finite"] or max(g["rel"]) > F32_MODEL_REL_L2:
            raise PhaseFailed(f"f32-serve: 438M f32 logits ({arm} decode) "
                              f"finite={g['finite']}, rel L2 {g['rel']}")
    del gate

    bf16 = LlamaForCausalLM(cfg, dtype=torch.bfloat16,
                            generator=seed(32, "cuda"))
    bf16.load_state_dict(card.state_dict())  # the f32 weights, rounded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    arms = (("f32 fused", card, 1), ("f32 unfused", card, 0),
            ("bf16 unfused", bf16, 0))
    runs = {arm: [] for arm, _, _ in arms}
    engines = {}
    for _ in range(F32_SERVE_RUNS):
        for arm, model, mk in arms:
            eng, prompts, outs, rec = serving_arm(model, mk, name, smi,
                                                  "f32-serve")
            runs[arm].append((outs, rec))
            engines.setdefault(arm, (eng, prompts))
    peak = torch.cuda.max_memory_allocated()
    summary = {}
    for arm, (eng, prompts) in engines.items():
        recs = [r for _, r in runs[arm]]
        first = recs[0]
        summary[arm] = dict(
            tokens_per_sec=[r["tokens_per_sec"] for r in recs],
            kernel_launches_per_decode_step=first[
                "kernel_launches_per_decode_step"])
        if arm.startswith("f32"):  # a profiled run takes ~40 s
            prof = device_profile(lambda: eng.run(
                prompts, max_new_tokens=SERVE_NEW_TOKENS,
                segment=SERVE_SEGMENT), steps=1)
            steps = first["decode_steps"]
            summary[arm].update(
                device_idle_share=prof["device_idle_share"],
                device_busy_ms_per_decode_step=prof[
                    "device_busy_ms_per_call"] / steps,
                wall_ms_per_decode_step=prof["wall_ms_per_call"] / steps,
                top_kernels=prof["top_kernels"][:5])
    f32_outs = runs["f32 fused"][0][0]
    repeat = all(all((a == b).all() for a, b in zip(f32_outs, outs))
                 for outs, _ in runs["f32 fused"][1:])

    def agreement(arm):
        return float(np.mean([(a == b).mean() for a, b in
                              zip(f32_outs, runs[arm][0][0])]))

    emit("f32-serve", summary=summary, max_memory_allocated=peak,
         f32_fused_runs_token_identical=bool(repeat),
         f32_fused_vs_unfused_token_agreement=agreement("f32 unfused"),
         f32_fused_vs_bf16_token_agreement=agreement("bf16 unfused"),
         seconds=time.monotonic() - t0, card=name, nvidia_smi=smi)
    counts = (runs["f32 unfused"][0][1]["launches"],
              runs["f32 fused"][0][1]["launches"])
    del runs, engines
    torch.cuda.empty_cache()
    captured_phase("f32-serve fused", card, 1, name, smi)
    del card, bf16
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
    ("fused_decode_layer", "paddle_tpu_torch/csrc/decode_megakernel.cuh",
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
    # paged decode past 8 query heads per kv head, and the decode
    # megakernel's f32 and head dim 96 on their paths
    ("paged_attention[g=12]", "paddle_tpu_torch/csrc/decode_attention.cu",
     "paddle_tpu/ops/pallas/decode_attention.py:58", "mistral-large-serve",
     "paged_attention"),
    # the RMSNorm forward past a warp's row: the wide kernel at hidden 12288
    ("rms_norm[h=12288]", "paddle_tpu_torch/csrc/rms_norm_wide.cu",
     "paddle_tpu/ops/pallas/rms_norm.py:59", "mistral-large-serve",
     "rms_norm"),
    ("fused_decode_layer[f32]",
     "paddle_tpu_torch/csrc/decode_megakernel.cuh",
     "paddle_tpu/ops/pallas/decode_megakernel.py:189", "f32-serve-fused"),
    ("fused_decode_layer[d=96]",
     "paddle_tpu_torch/csrc/decode_megakernel.cuh",
     "paddle_tpu/ops/pallas/decode_megakernel.py:189", "phi3-serve-fused",
     "fused_decode_layer"),
    # the admission path's new shapes (kv-e9): RoPE over a chunk at
    # per-row positions, the megakernel at depths to 1535 from the fused
    # long-prompt run, paged decode at lengths to 1536 from its unfused
    # reference
    ("fused_rope[pos=1535]", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:47", "kv-e9", "fused_rope"),
    ("paged_attention[len=1536]", "paddle_tpu_torch/csrc/decode_attention.cu",
     "paddle_tpu/ops/pallas/decode_attention.py:58", "kv-e9-unfused",
     "paged_attention"),
    ("fused_decode_layer[len=1535]",
     "paddle_tpu_torch/csrc/decode_megakernel.cuh",
     "paddle_tpu/ops/pallas/decode_megakernel.py:189", "kv-e9",
     "fused_decode_layer"),
    # the f32 backward kernels and the RoPE adjoint in f32 (f32-train)
    ("rms_norm_bwd[f32]", "paddle_tpu_torch/csrc/rms_norm.cu",
     "paddle_tpu/ops/pallas/rms_norm.py:100", "f32-train"),
    ("fused_rope_bwd[f32]", "paddle_tpu_torch/csrc/rope.cu",
     "paddle_tpu/ops/pallas/fused_ops.py:47", "f32-train"),
    ("flash_attention_bwd_dkdv[f32]",
     "paddle_tpu_torch/csrc/flash_attention_bwd_f32.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:181", "f32-train"),
    ("flash_attention_bwd_dq[f32]",
     "paddle_tpu_torch/csrc/flash_attention_bwd_dq_f32.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:245", "f32-train"),
    # the optimizer's update: no Pallas kernel; JAX's one XLA program for
    # the whole update (_build_update). Launches from bench.py (b2)'s step
    # and f32-train's
    ("multi_tensor_adam", "paddle_tpu_torch/csrc/multi_tensor_adam.cu",
     "paddle_tpu/optimizer/optimizer.py:251", "llama-large-train"),
    ("multi_tensor_adam[f32]", "paddle_tpu_torch/csrc/multi_tensor_adam.cu",
     "paddle_tpu/optimizer/optimizer.py:251", "f32-train"),
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
    results.update(paged_group_phase(peaks))
    paged_edge_phase()
    results.update(train_kernel_phase(peaks))
    results.update(bdrln_phase(peaks))
    bert_flash_phase(peaks)
    flash_edge_phase()
    flash_segments_phase(peaks)
    seg_kernels, varlen_counts = varlen_phase(peaks)
    results.update(seg_kernels)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    results.update(adam_kernel_phase(peaks))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = model_phase()
    torch.cuda.synchronize()
    counts = serving_phase(model, name, smi)
    kv_rows, kv_counts = kv_e9_phase(model, name, smi, peaks)
    results.update(kv_rows)
    counts.update(kv_counts)
    counts["varlen"] = varlen_counts
    del model
    torch.cuda.empty_cache()
    grad_phase()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts["train"] = train_phase(name, smi, peaks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts["llama-large-train"] = llama_large_train_phase(name, smi, peaks)
    counts["incubate"] = incubate_phase()
    bert_grad_phase()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts["bert-train"] = bert_train_phase(name, smi, peaks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    results.update(head_dims_phase(peaks))
    flash_edge_phase(widths=(96, 256))
    counts["phi3-serve"], counts["phi3-serve-fused"] = phi3_serve_phase(
        name, smi)
    torch.cuda.synchronize()
    counts["phi3-train"] = phi3_train_phase(name, smi, peaks)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    counts["mistral-large-serve"] = mistral_large_serve_phase(name, smi)
    torch.cuda.synchronize()
    results.update(f32_kernel_phase(peaks))
    counts["f32-serve"], counts["f32-serve-fused"] = f32_serve_phase(name,
                                                                     smi)
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
