#!/usr/bin/env python3
"""Time the decode megakernel, the f32 flash-attention forward and
backward and the bf16 RMSNorm backward of one tree of the port, so that two
trees can be compared in one call.

    python3 tools/torch_kernel_ab.py [--root DIR] [--only megakernel]

Imports ``paddle_tpu_torch`` from DIR (default: this checkout), builds its
kernel library, and times each case with this checkout's chip_smoke.py
(``graph_ms``: a CUDA graph of calls replayed between CUDA events, warm
L2): the f32 flash forward (``flash_attention_fwd``, causal, TF32 off) at
(4, 1536, 12, 128), (8, 128, 12, 128), (8, 128, 32, 96) and (2, 2048, 16,
256) on 2 kv heads, the f32 dK/dV and dQ kernels
(``flash_attention_bwd_dkdv``, ``flash_attention_bwd_dq``) at
chip_smoke.py's ``F32_BWD_CASES`` from the tree's own forward, and the
bf16 RMSNorm backward (``rms_norm_bwd``) at
(6144, 1536) and (6144, 3072), its launches also timed apart
(``launch_split``, torch.profiler). Inputs are standard normal from
seeded generators on the card. The decode megakernel
(``fused_decode_layer``) at chip_smoke.py's ``MK_CASES`` (the 438M on 12
and 4 kv heads, in f32, Phi-3-mini, Phi-2, D = 256 on 2 kv heads, group
16) on ``megakernel_setup``'s inputs (the e2 decode shape, each case from
its own seed), warm and rotating over layers (``megakernel_times``), at
``MK_LENGTHS`` or, with ``--lengths serving``, at ``MK_SERVING_LENGTHS``
(the serving runs' depths); ``--only megakernel`` times these alone. Prints one JSON object with the card's
name and power limit. To compare a parent with a change, unpack the
parent under a directory that .gitignore lists and run parent, change,
change, parent in one call.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
FLASH_CASES = [("training shape", 4, 1536, 12, 12, 128),
               ("e2 prefill bucket", 8, 128, 12, 12, 128),
               ("phi3 prefill bucket", 8, 128, 32, 32, 96),
               ("qwen3-next full attention", 2, 2048, 16, 2, 256)]
RMS_WIDTHS, RMS_ROWS = (1536, 3072), 6144


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--only", choices=("megakernel",))
    ap.add_argument("--lengths", choices=("chip_smoke", "serving"),
                    default="chip_smoke")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    # this checkout's timing helpers, the package of the tree at --root
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(args.root.resolve()))
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_line()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = {"root": str(args.root), "card": smi, "lengths": args.lengths,
           "fused_decode_layer": {}}
    for i, (case, widths, dtype, _) in enumerate(cs.MK_CASES):
        mgen = seed(40 + i, "cuda")

        def mrandn(*shape, std=1.0):
            return torch.randn(shape, generator=mgen, device="cuda") * std

        with torch.no_grad():
            layer, x, kp, vp, margs = cs.megakernel_setup(
                cs.mk_cfg(widths), mgen, mrandn, dtype,
                cs.MK_SERVING_LENGTHS if args.lengths == "serving"
                else cs.MK_LENGTHS)
            warm, rotating, n = cs.megakernel_times(mk, x, kp, vp, margs)
        out["fused_decode_layer"][case] = dict(warm_ms=warm,
                                               rotating_ms=rotating,
                                               rotating_layers=n)
        del layer, x, kp, vp, margs
        torch.cuda.empty_cache()
    if args.only == "megakernel":
        print(json.dumps(out), flush=True)
        return 0
    out.update({"flash_attention[f32]": {},
                "flash_attention_bwd_dkdv[f32]": {},
                "flash_attention_bwd_dq[f32]": {}, "rms_norm_bwd": {}})
    for case, b, s, h, kvh, d in FLASH_CASES:
        q, k, v = randn(b, s, h, d), randn(b, s, kvh, d), randn(b, s, kvh, d)
        out["flash_attention[f32]"][case] = cs.graph_ms(
            lambda: fa.flash_attention_fwd(q, k, v, True),
            calls=20 if s <= 128 else 3, replays=3)
    for case, b, s, h, kvh, d, causal in cs.F32_BWD_CASES:
        q, do = randn(b, s, h, d), randn(b, s, h, d)
        k, v = randn(b, s, kvh, d), randn(b, s, kvh, d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = fa._delta(o, do)
        out["flash_attention_bwd_dkdv[f32]"][case] = cs.graph_ms(
            lambda: fa.flash_attention_bwd_dkdv(q, k, v, do, lse, delta,
                                                causal), calls=3, replays=3)
        out["flash_attention_bwd_dq[f32]"][case] = cs.graph_ms(
            lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                              causal), calls=3, replays=3)
        del q, do, k, v, o, lse, delta
        torch.cuda.empty_cache()
    for hidden in RMS_WIDTHS:
        x = randn(RMS_ROWS, hidden).bfloat16()
        g = randn(RMS_ROWS, hidden).bfloat16()
        w = (1.0 + 0.1 * randn(hidden)).bfloat16()
        _, r = rn.rms_norm_rows(x, w, epsilon=1e-6)
        out["rms_norm_bwd"][f"({RMS_ROWS}, {hidden})"] = dict(
            ms=cs.graph_ms(lambda: rn.rms_norm_bwd(x, w, r, g), calls=10),
            launches_ms=cs.launch_split(lambda: rn.rms_norm_bwd(x, w, r,
                                                                g)))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
