#!/usr/bin/env python3
"""Time the decode megakernel, paged decode, RoPE, the f32 flash-attention
forward and backward and the bf16 RMSNorm backward of one tree of the
port, so that two trees can be compared in one call.

    python3 tools/torch_kernel_ab.py [--root DIR]
        [--only megakernel|paged|rope|rms] [--lengths chip_smoke|serving]

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
(the serving runs' depths). Paged decode (``paged_attention``) at
``PAGED_CASES`` on chip_smoke.py's ``e2_pool`` (8 slots of the serving
pool, lengths 9-183): e2's 12 heads at D = 128 in bf16 and f32, Phi-3's
32 heads of 96, Mistral-Large-2's 96 heads on 8 kv heads, 16 heads of 256
on 2 kv heads, 128 heads on 8 and 32 on 1. RoPE (``fused_rope_at``, both
directions, bf16 and f32) on q and k at ``ROPE_CASES``: the decode step
(8, 1, H, D) at per-slot positions, the prefill bucket (8, 128, H, D) and
the training step (4, 1536, H, D) at arange positions, for the 438M's
12 heads of 128 and Phi-3's 32 of 96. RMSNorm (``--only rms``, also
part of the full run) at ``RMS_FWD_CASES``: the forward
(``rms_norm_rows``, weight, no bias) beside ``F.rms_norm`` on the same
inputs, warm and, at prefill and training rows, cold (``cold_ms``:
inputs and outputs out of L2); the f32 backward (``rms_norm_bwd``) at
``RMS_F32_BWD_ROWS`` beside ``autograd.grad`` through ``F.rms_norm`` in
f32, and the bf16 backward at ``RMS_WIDTHS``, each backward's two
launches also timed apart. ``--only`` times one of these four groups
alone. Prints one JSON object with the card's name and power limit. To compare a parent with a change, unpack the parent under a
directory that .gitignore lists and run parent, change, change, parent in
one call.
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
# the RMSNorm forward: (rows, D, dtype); Mistral-Large-2's hidden 12288 at
# the decode step and a prefill, Phi-3's 3072 and 12288 in f32, and the
# vector kernel's widths (the 438M's 1536, Phi-3's 3072)
RMS_FWD_CASES = [(8, 12288, torch.bfloat16), (1024, 12288, torch.bfloat16),
                 (8, 3072, torch.float32), (8, 12288, torch.float32),
                 (8, 1536, torch.bfloat16), (1024, 1536, torch.bfloat16),
                 (6144, 1536, torch.bfloat16), (8, 3072, torch.bfloat16),
                 (8, 1536, torch.float32), (1024, 1536, torch.float32)]
# the f32 backward at the 438M's width: f32-train's rows and a smaller step
RMS_F32_BWD_ROWS, RMS_F32_BWD_WIDTH = (6144, 1024), 1536
# paged decode: (case, heads, kv heads, D, dtype)
PAGED_CASES = [("e2 d128", 12, 12, 128, torch.bfloat16),
               ("phi3 d96", 32, 32, 96, torch.bfloat16),
               ("mistral-large group 12", 96, 8, 128, torch.bfloat16),
               ("e2 f32", 12, 12, 128, torch.float32),
               ("d256 on 2 kv heads", 16, 2, 256, torch.bfloat16),
               ("group 16", 128, 8, 128, torch.bfloat16),
               ("group 32", 32, 1, 128, torch.bfloat16)]
# RoPE: (case, b, s, heads, D), q and k of the same heads
ROPE_CASES = [("438m decode", 8, 1, 12, 128), ("phi3 decode", 8, 1, 32, 96),
              ("438m prefill", 8, 128, 12, 128),
              ("phi3 prefill", 8, 128, 32, 96),
              ("438m train", 4, 1536, 12, 128),
              ("phi3 train", 4, 1536, 32, 96)]


def paged_times(cs, da):
    """{case: ms} of paged decode at PAGED_CASES on ``e2_pool``."""
    out = {}
    for i, (case, heads, kvh, hd, dtype) in enumerate(PAGED_CASES):
        gen = torch.Generator(device="cuda").manual_seed(60 + i)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, kp, vp, tab, ln, _, per_seq = cs.e2_pool(randn, heads, kvh, hd)
        out[case] = cs.graph_ms(lambda: da.paged_attention(
            q, kp, vp, tab, ln, pages_per_seq=per_seq))
    return out


def rope_times(cs, fo, rope_tables):
    """{dtype: {direction: {case: ms}}} of RoPE at ROPE_CASES."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        tag = "bf16" if dtype == torch.bfloat16 else "f32"
        out[tag] = {"forward": {}, "inverse": {}}
        gen = torch.Generator(device="cuda").manual_seed(70)
        for case, b, s, h, d in ROPE_CASES:
            cos, sin = rope_tables(d, 4096, 10000.0, "cuda")
            q = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, s, h, d, generator=gen, device="cuda").to(dtype)
            if s == 1:  # per-slot decode depths
                pos = torch.randint(0, 183, (b, 1), generator=gen,
                                    device="cuda", dtype=torch.int32)
            else:
                pos = torch.arange(s, device="cuda", dtype=torch.int32
                                   ).expand(b, s).contiguous()
            for inverse in (False, True):
                out[tag]["inverse" if inverse else "forward"][case] = (
                    cs.graph_ms(lambda: fo.fused_rope_at(q, k, cos, sin, pos,
                                                         inverse),
                                calls=20 if s <= 128 else 10))
            del q, k
    return out


def rms_times(cs, rn):
    """{"rms_norm": {case: {...}}, "rms_norm_bwd[f32]": ...,
    "rms_norm_bwd": ...} of RMSNorm at RMS_FWD_CASES, RMS_F32_BWD_ROWS
    and RMS_WIDTHS (ms a call, warm L2; ``cold_ms`` where the rows are
    many; the library call beside each)."""
    fnn = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(80)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = {"rms_norm": {}, "rms_norm_bwd[f32]": {}, "rms_norm_bwd": {}}
    for n, d, dtype in RMS_FWD_CASES:
        x = randn(n, d, dtype=dtype)
        w = (1.0 + 0.1 * randn(d)).to(dtype)
        rec = dict(
            ms=cs.graph_ms(lambda: rn.rms_norm_rows(x, w, epsilon=1e-5)),
            library_ms=cs.graph_ms(lambda: fnn.rms_norm(x, (d,), w, 1e-5)))
        if n >= 1024:
            rec.update(
                cold_ms=cs.cold_ms(lambda xx: rn.rms_norm_rows(
                    xx, w, epsilon=1e-5), (x,)),
                cold_library_ms=cs.cold_ms(lambda xx: fnn.rms_norm(
                    xx, (d,), w, 1e-5), (x,)))
        tag = "f32" if dtype == torch.float32 else "bf16"
        out["rms_norm"][f"({n}, {d}) {tag}"] = rec
        del x
    d = RMS_F32_BWD_WIDTH
    w = 1.0 + 0.1 * randn(d)
    for n in RMS_F32_BWD_ROWS:
        x, g = randn(n, d), randn(n, d)
        _, r = rn.rms_norm_rows(x, w, epsilon=1e-6)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
            yl = fnn.rms_norm(xl, (d,), wl, 1e-6)
        out["rms_norm_bwd[f32]"][f"({n}, {d})"] = dict(
            ms=cs.graph_ms(lambda: rn.rms_norm_bwd(x, w, r, g), calls=10),
            library_ms=cs.graph_ms(lambda: torch.autograd.grad(
                yl, (xl, wl), g, retain_graph=True), calls=10, stream=side),
            launches_ms=cs.launch_split(lambda: rn.rms_norm_bwd(x, w, r, g)))
        del x, g, xl, wl, yl
    for hidden in RMS_WIDTHS:
        x = randn(RMS_ROWS, hidden, dtype=torch.bfloat16)
        g = randn(RMS_ROWS, hidden, dtype=torch.bfloat16)
        w = (1.0 + 0.1 * randn(hidden)).bfloat16()
        _, r = rn.rms_norm_rows(x, w, epsilon=1e-6)
        out["rms_norm_bwd"][f"({RMS_ROWS}, {hidden})"] = dict(
            ms=cs.graph_ms(lambda: rn.rms_norm_bwd(x, w, r, g), calls=10),
            launches_ms=cs.launch_split(lambda: rn.rms_norm_bwd(x, w, r,
                                                                g)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--only", choices=("megakernel", "paged", "rope", "rms"))
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
    from paddle_tpu_torch.models.llama import _rope_tables
    from paddle_tpu_torch.ops.cuda import decode_attention as da
    from paddle_tpu_torch.ops.cuda import decode_megakernel as mk
    from paddle_tpu_torch.ops.cuda import flash_attention as fa
    from paddle_tpu_torch.ops.cuda import fused_ops as fo
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_line()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    out = {"root": str(args.root), "card": smi, "lengths": args.lengths}
    if args.only in (None, "paged"):
        out["paged_attention"] = paged_times(cs, da)
    if args.only in (None, "rope"):
        out["fused_rope"] = rope_times(cs, fo, _rope_tables)
    if args.only in (None, "rms"):
        out.update(rms_times(cs, rn))
    if args.only in ("paged", "rope", "rms"):
        print(json.dumps(out), flush=True)
        return 0
    out["fused_decode_layer"] = {}
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
                "flash_attention_bwd_dq[f32]": {}})
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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
