#!/usr/bin/env python3
"""Where the PyTorch port's training step spends its time, on one GPU.

    python3 tools/torch_train_profile.py [--model llama-438m|bert-base|phi3-4l]
                                         [--dtype bf16|f32]

Runs one of chip_smoke.py's training workloads: ``llama-438m`` (the
default; ``train_workload``: the 438M LLaMA in bf16, random weights from
a seed; AdamW(learning_rate=1e-4, multi_precision=True) and TrainStep
over LlamaPretrainingCriterion; batch 4 x seq 1536 ids from
np.random.RandomState(0)) or ``bert-base`` (``bert_train_workload``:
bench.py section (c2), BERT-base in bf16 with dropout 0, the same AdamW,
TrainStep over BertPretrainingCriterion, batch 32 x seq 128 ids and
labels from np.random.RandomState(0)) or ``phi3-4l`` (chip_smoke.py's
phi3-train: ``train_workload`` at Phi-3-mini's widths, ``CFG_PHI3`` cut to
``PHI3_TRAIN_LAYERS`` layers). ``--dtype f32`` builds the LLaMA
workloads in f32 (chip_smoke.py's f32-train: the f32 kernels, TF32 off);
BERT runs in bf16 only. Times it as chip_smoke.py times it
(``timed_steps``: one warm-up step, then the median of five steps timed
with CUDA events), then runs two steps under torch.profiler. Prints one
JSON object: the step time, the device's busy and idle share of the
profiled steps, device time per step grouped into the port's kernels,
GEMMs, CE/softmax, LayerNorm, the optimizer (every kernel launched inside
``optimizer.step``), elementwise and the rest, and the path's kernels'
launches per step (the wrappers' counts, ``[f32]`` launches under the
kernel's name: the RMSNorm backward is two device kernels, the strips'
partial sums and their reduction).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PROFILED = 2
# kernel-name fragment -> the port's kernel; the first match wins (an f32
# twin's name holds its bf16 kernel's). The RoPE kernel's two directions
# are one template, told apart by its last argument as the profiler spells
# it, after the element type.
OURS = (("rms_norm_bwd", "rms_norm_bwd"), ("rms_norm_fwd", "rms_norm"),
        ("flash_bwd_dkdv", "flash_attention_bwd_dkdv"),
        ("flash_bwd_dq", "flash_attention_bwd_dq"),
        ("flash_fwd", "flash_attention"),
        ("bdrln_fwd", "bias_dropout_residual_ln"))
PATH_KERNELS = {label for _, label in OURS} | {"fused_rope",
                                               "fused_rope_bwd"}
OPTIMIZER = "optimizer.step"
ROPE_INVERSE = re.compile(r"rope_kernel<(?:[^<>]*, )?(?:true|\(bool\)1|1)>")


def group_of(name):
    if "rope_kernel" in name:
        return ("fused_rope_bwd" if ROPE_INVERSE.search(name)
                else "fused_rope")
    for key, label in OURS:
        if key in name:
            return label
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "splitkreduce", "xmma",
                              "cutlass")):
        return "gemm"
    if any(k in low for k in ("softmax", "gather", "scatter", "nll")):
        return "ce/softmax"
    if "layer_norm" in low:
        return "layer_norm"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low:
        return "reduce"
    return "other"


def kernels_under(evt):
    """(name, device us) of every kernel launched by ``evt``'s CPU ops."""
    out = [(k.name, float(k.duration)) for k in evt.kernels]
    for child in evt.cpu_children:
        out.extend(kernels_under(child))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model",
                        choices=("llama-438m", "bert-base", "phi3-4l"),
                        default="llama-438m")
    parser.add_argument("--dtype", choices=("bf16", "f32"), default="bf16")
    args = parser.parse_args()
    if args.model == "bert-base" and args.dtype != "bf16":
        parser.error("bert-base runs in bf16 only")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from paddle_tpu_torch.ops.cuda import launch_counts

    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    tag = "[f32]" if args.dtype == "f32" else ""
    workload = {
        "llama-438m": lambda: chip_smoke.train_workload(dtype=dtype),
        "bert-base": chip_smoke.bert_train_workload,
        "phi3-4l": lambda: chip_smoke.train_workload(
            {**chip_smoke.CFG_PHI3,
             "num_hidden_layers": chip_smoke.PHI3_TRAIN_LAYERS},
            dtype)}[args.model]
    _, opt, step, ids, labels = workload()
    batch, seqlen = ids.shape
    step_fn = opt.step

    def traced_step():
        with torch.profiler.record_function(OPTIMIZER):
            step_fn()

    opt.step = traced_step
    step(ids, labels=labels)
    torch.cuda.synchronize()
    step_ms = float(np.median(chip_smoke.timed_steps(step, ids, labels)[1]))

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    launch_counts.clear()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step(ids, labels=labels)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    launches = {k: launch_counts[k + tag] / PROFILED
                for k in sorted(PATH_KERNELS)}
    groups, kernels, busy_us = {}, {}, 0.0
    for e in prof.key_averages():
        # the optimizer's range also shows as a device-side annotation
        if (str(getattr(e, "device_type", "")).endswith("CUDA")
                and e.key != OPTIMIZER):
            us = float(getattr(e, "self_device_time_total", 0.0))
            busy_us += us
            g = group_of(e.key)
            groups[g] = groups.get(g, 0.0) + us
            kernels[e.key[:90]] = (us, e.count)
    # kernels launched inside optimizer.step leave their name groups for
    # the optimizer's own
    for e in prof.events():
        if e.name == OPTIMIZER:
            for name, us in kernels_under(e):
                groups[group_of(name)] -= us
                groups["optimizer"] = groups.get("optimizer", 0.0) + us
    per_step_ms = {k: v / 1e3 / PROFILED
                   for k, v in sorted(groups.items(), key=lambda kv: -kv[1])}
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "model": args.model,
        "dtype": args.dtype,
        "batch": batch, "seq": seqlen,
        "step_ms": step_ms,
        "tokens_per_sec": batch * seqlen / (step_ms / 1e3),
        "profiled_steps": PROFILED,
        "profiled_wall_ms_per_step": 1e3 * prof_wall / PROFILED,
        "device_busy_ms_per_step": busy_us / 1e3 / PROFILED,
        "device_busy_share": busy_us / 1e6 / prof_wall,
        "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
        "device_ms_per_step_by_group": per_step_ms,
        "launches_per_step": launches,
        "top_kernels": [
            {"kernel": k, "ms_per_step": us / 1e3 / PROFILED,
             "launches_per_step": n / PROFILED}
            for k, (us, n) in sorted(kernels.items(),
                                     key=lambda kv: -kv[1][0])[:15]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
