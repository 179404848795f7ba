#!/usr/bin/env python3
"""Where the PyTorch port's serving time goes, on one GPU: fused and
unfused, each on the default engine (pipelined, every decode segment one
replay of a captured CUDA graph) and on the eager serial reference.

    python3 tools/torch_serving_profile.py
        [--model llama-438m|phi3|mistral-large]
        [--arms unfused,fused,unfused-eager,fused-eager] [--root DIR]

Runs chip_smoke.py's serving workload (``serving_workload``: the 438M
LLaMA in bf16, random weights from a seed; 8 slots, max_len 512, page 128,
buckets (32, 128); 24 requests of 8-119 prompt tokens from
np.random.RandomState(7), 64 new tokens each, greedy, segments of 32) in
arms on one model: unfused (``decode_megakernel=0``) and fused (each
decoder layer's attention half one megakernel launch), on the default
engine, and with ``-eager`` on chip_smoke.py's eager serial reference
engine (the serial scheduler, each decode step's launches issued from
Python). Each arm runs the workload twice after the engine's warm-up
(``warmup()`` and a warm run): once plain, for the wall time and
tokens/s, and once under torch.profiler, for the device time by kernel.
Prints one JSON object with, per arm: wall and device time per decode
step (prefill included, spread over the decode steps), the device's idle
share of the profiled run, device time grouped into the port's kernels,
GEMMs and the rest, the kernels the device ran a decode step, and the
host's launch calls a decode step (kernel and graph launches).
``--model phi3`` runs chip_smoke.py's phi3-serve model instead (32 layers
at Phi-3-mini's widths, ``CFG_PHI3``), whose fused arm takes the decode
megakernel at head dim 96; ``--model mistral-large`` its
mistral-large-serve model (``CFG_MISTRAL_LARGE``, 96 heads of 128 on 8 kv
heads, cut to ``MISTRAL_LARGE_LAYERS`` = 4 of 88 layers), which decodes
unfused in both arms (the probe declines hidden 12288), so it runs the
unfused arms alone unless ``--arms`` says otherwise. ``--arms`` picks the
arms (comma-separated). ``--root DIR`` imports ``paddle_tpu_torch`` from
DIR (a parent tree unpacked under a directory that .gitignore lists,
whose engine has ``warmup()``), with this checkout's chip_smoke.py
driving it, so that two trees can be profiled in one call.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

OURS = {"rms_norm_fwd": "rms_norm", "rope_kernel": "fused_rope",
        "flash_fwd_kernel": "flash_attention",
        "paged_decode": "paged_attention",
        "decode_layer_": "fused_decode_layer"}


def group_of(name):
    for key, label in OURS.items():
        if key in name:
            return label
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "splitkreduce", "xmma",
                              "cutlass")):
        return "gemm"
    if "index_put" in low or "indexing" in low or "scatter" in low:
        return "kv_write (index_put)"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "memcpy/memset"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise"
    if "reduce" in low or "argmax" in low:
        return "reduce/argmax"
    return "other"


def profile_arm(cs, model, fused, eager):
    eng, prompts = cs.serving_workload(model, decode_megakernel=int(fused),
                                       eager=eager)
    run = dict(max_new_tokens=cs.SERVE_NEW_TOKENS, segment=cs.SERVE_SEGMENT)
    torch.cuda.synchronize()
    _, stats = eng.run(prompts, **run)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, pstats = eng.run(prompts, **run)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    groups, kernels, busy_us, launches, host_calls = {}, {}, 0.0, 0, 0
    for e in prof.key_averages():
        if e.key.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch")):
            host_calls += e.count
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = float(getattr(e, "self_device_time_total", 0.0))
            busy_us += us
            g = group_of(e.key)
            groups[g] = groups.get(g, 0.0) + us
            kernels[e.key[:90]] = (us, e.count)
            if g != "memcpy/memset":
                launches += e.count
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    steps = stats["segments"] * cs.SERVE_SEGMENT
    psteps = pstats["segments"] * cs.SERVE_SEGMENT
    return {
        "engine": "eager serial" if eager else "captured pipelined",
        "pipelined": stats["pipelined"],
        "megakernel": stats["megakernel"],
        "tokens_per_sec": stats["tokens_per_sec"], "wall_s": stats["wall_s"],
        "decode_steps": steps,
        "wall_ms_per_decode_step": 1e3 * stats["wall_s"] / steps,
        "profiled_wall_s": prof_wall,
        "profiled_tokens_per_sec": pstats["tokens_per_sec"],
        "device_busy_s": busy_us / 1e6,
        "device_ms_per_decode_step": busy_us / 1e3 / psteps,
        "device_idle_share": (1.0 - busy_us / 1e6 / prof_wall
                              if busy_us else None),
        "kernel_launches_per_decode_step": launches / psteps,
        "host_launch_calls_per_decode_step": host_calls / psteps,
        "fused_decode_layer_share": groups.get("fused_decode_layer", 0.0)
        / busy_us if busy_us else None,
        "device_s_by_group": {k: v / 1e6 for k, v in sorted(
            groups.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"kernel": k, "device_s": us / 1e6, "count": n}
                        for k, (us, n) in top],
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", choices=("llama-438m", "phi3",
                                            "mistral-large"),
                        default="llama-438m")
    parser.add_argument("--arms", default=None,
                        help="comma-separated, of unfused, fused, "
                             "unfused-eager and fused-eager")
    parser.add_argument("--root", type=Path, default=ROOT)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    # this checkout's workload, the package of the tree at --root
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(args.root.resolve()))
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = {"llama-438m": cs.CFG_438M, "phi3": cs.CFG_PHI3,
           "mistral-large": {**cs.CFG_MISTRAL_LARGE,
                             "num_hidden_layers": cs.MISTRAL_LARGE_LAYERS},
           }[args.model]
    arms = (args.arms.split(",") if args.arms else
            ["unfused", "unfused-eager"] if args.model == "mistral-large"
            else ["unfused", "unfused-eager", "fused", "fused-eager"])
    model = LlamaForCausalLM(LlamaConfig(**cfg), dtype=torch.bfloat16,
                             generator=seed(0, "cuda"))
    out = {arm: profile_arm(cs, model, arm.startswith("fused"),
                            arm.endswith("-eager"))
           for arm in arms}
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.smi_line(), "model": args.model,
                      "root": str(args.root), "arms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
