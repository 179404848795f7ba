#!/usr/bin/env python3
"""Where the paged decode kernel's time goes, phase by phase, on one GPU.

    python3 tools/torch_paged_stages.py

Builds a copy of ``paddle_tpu_torch/csrc/decode_attention.cu`` in which
thread 0 of every block stamps ``%globaltimer`` and ``clock64`` at eight
points: the block's start (0), its row's length read (1), its first K/V
tile staged (2), that tile's scores (3) and softmax (4) done, its tiles
attended (5), its ticket drawn (6) and its end (7); empty splits stamp 0
and 1 only. The copy goes into a library of its
own (the repo's library is not touched), and the port's wrapper
(``paged_attention``) is pointed at it, so the launches carry the
wrapper's split plan and scratch. Runs chip_smoke.py's ``e2_pool`` at
tools/torch_kernel_ab.py's ``PAGED_CASES`` (5 launches after 5 of
warm-up, warm L2). Prints one JSON object a case, in us: the launch's
span (first block start to last block end, by ``%globaltimer``), the
blocks with work and their latest start, and each phase's median and
maximum over those blocks (by ``clock64`` at the card's SM clock), the
merge over the blocks that merged; with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
N_STAMPS, MAX_BLOCKS = 8, 16384

HEADER = f'''
__device__ unsigned long long g_wall[{MAX_BLOCKS} * {N_STAMPS}];
__device__ long long g_clock[{MAX_BLOCKS} * {N_STAMPS}];
#define PTT_STAMP(i, dep) if (threadIdx.x == 0) {{ \\
  unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) : "r"(dep)); \\
  const long long blk_ = blockIdx.x + gridDim.x * (blockIdx.y + \\
      static_cast<long long>(gridDim.y) * blockIdx.z); \\
  if (blk_ < {MAX_BLOCKS}) {{ g_wall[blk_ * {N_STAMPS} + (i)] = t_; \\
    g_clock[blk_ * {N_STAMPS} + (i)] = clock64(); }} }}
'''
FOOTER = f'''
PTT_EXPORT int ptt_paged_stamps(void* wall, void* clk) {{
  cudaMemcpyFromSymbol(wall, g_wall, sizeof(g_wall));
  cudaMemcpyFromSymbol(clk, g_clock, sizeof(g_clock));
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_wall);
  cudaMemset(p, 0, sizeof(g_wall));
  return static_cast<int>(cudaDeviceSynchronize());
}}
'''
# (anchor in the source, text put before it)
POINTS = [
    ("  const int len = max(min(__ldg(p.lengths + b), p.max_tokens), 0);\n",
     "  PTT_STAMP(0, 0);\n"),
    ("  if (len == 0) {  // no visible key", "  PTT_STAMP(1, len);\n"),
    ("    if constexpr (kMma) {\n      tile_scores_mma(",
     "    if (i == 0) PTT_STAMP(2, nr);\n"),
    ("    for (int h = warp; h < cnt; h += kWarps) {  // softmax",
     "    if (i == 0) PTT_STAMP(3, cnt);\n"),
    ("    if constexpr (kMma) {\n      tile_pv_mma(",
     "    if (i == 0) PTT_STAMP(4, nr);\n"),
    ("  const long long item = (static_cast<long long>(b) * p.kv_heads + kh) *",
     "  PTT_STAMP(5, nne);\n"),
    ("  if (!*last) return;\n", "  PTT_STAMP(6, *last);\n"),
]


def stamped_source(src: str) -> str:
    for anchor, text in POINTS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found once: {anchor!r}")
        src = src.replace(anchor, text + anchor)
    # the end: attend's returns (the lone split's, a split that is not
    # last) and the merge's end, all back in the kernel
    for call in ("      attend<T, 8, true>(p, smem, b, kh, c, s, len, sc, m_s, "
                 "l_s, alpha,\n                         &last);\n",
                 "    attend<T, 16 / sizeof(T), false>(p, smem, b, kh, c, s, "
                 "len, sc, m_s,\n                                     l_s, "
                 "alpha, &last);\n",
                 "    attend<T, 1, false>(p, smem, b, kh, c, s, len, sc, m_s, "
                 "l_s, alpha,\n                        &last);\n"):
        if src.count(call) != 1:
            raise RuntimeError(f"call not found once: {call!r}")
        src = src.replace(call, call + "    PTT_STAMP(7, 0);\n")
    src = src.replace('#include "common.cuh"', '#include "common.cuh"\n'
                      + HEADER, 1)
    return src + FOOTER


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import decode_attention as da

    spec = importlib.util.spec_from_file_location(
        "torch_kernel_ab", ROOT / "tools" / "torch_kernel_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    csrc = ROOT / "paddle_tpu_torch/csrc"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="paged-stages-", dir=_build.BUILD_DIR))
    (work / "decode_attention.cu").write_text(
        stamped_source((csrc / "decode_attention.cu").read_text()))
    for f in ("common.cuh", "errors.cu"):
        (work / f).write_text((csrc / f).read_text())
    lib = work / "libpaged_stages.so"
    subprocess.run([_build.nvcc(), *_build._FLAGS, "-shared", "-o", str(lib),
                    str(work / "decode_attention.cu"), str(work / "errors.cu")],
                   check=True, capture_output=True)
    stamped = ctypes.CDLL(str(lib))
    stamped.ptt_error_string.argtypes = [ctypes.c_int]
    stamped.ptt_error_string.restype = ctypes.c_char_p
    stamped.ptt_paged_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _build._lib = stamped  # the wrapper's launches go to the stamped copy
    _build._functions.clear()
    ghz = torch.cuda.get_device_properties(0).clock_rate / 1e6 \
        if hasattr(torch.cuda.get_device_properties(0), "clock_rate") else None
    if not ghz:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True)
        ghz = float(out.stdout.split()[0]) / 1e3
    smi = cs.smi_line()
    wall = torch.zeros(MAX_BLOCKS * N_STAMPS, dtype=torch.int64)
    clk = torch.zeros(MAX_BLOCKS * N_STAMPS, dtype=torch.int64)
    # phase: (from stamp, to stamp, which blocks)
    phases = {"length": (0, 1, "all"), "staged": (1, 2, "work"),
              "scores": (2, 3, "work"), "softmax": (3, 4, "work"),
              "p v": (4, 5, "work"), "ticket": (5, 6, "ticket"),
              "after ticket": (6, 7, "ticket"), "lone output": (5, 7, "lone")}
    for i, (case, heads, kvh, hd, dtype) in enumerate(ab.PAGED_CASES):
        gen = torch.Generator(device="cuda").manual_seed(60 + i)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, kp, vp, tab, ln, _, per_seq = cs.e2_pool(randn, heads, kvh, hd)
        for _ in range(5):
            da.paged_attention(q, kp, vp, tab, ln, pages_per_seq=per_seq)
        runs = []
        for _ in range(5):
            stamped.ptt_paged_stamps(wall.data_ptr(), clk.data_ptr())
            da.paged_attention(q, kp, vp, tab, ln, pages_per_seq=per_seq)
            torch.cuda.synchronize()
            stamped.ptt_paged_stamps(wall.data_ptr(), clk.data_ptr())
            w = wall.view(-1, N_STAMPS)
            c = clk.view(-1, N_STAMPS)
            used = w[:, 0] > 0
            work = used & (w[:, 2] > 0)
            sets = {"all": used, "work": work, "ticket": work & (w[:, 6] > 0),
                    "lone": work & (w[:, 6] == 0)}
            t0 = w[used, 0].min().item()
            runs.append(dict(
                span=(w[used, 7].max().item() - t0) / 1e3,
                blocks=int(used.sum()), work_blocks=int(work.sum()),
                last_start=(w[work, 0].max().item() - t0) / 1e3,
                phase={name: ((c[sets[which], b] - c[sets[which], a])
                              .double() / ghz / 1e3).tolist()
                       for name, (a, b, which) in phases.items()}))
        med = statistics.median
        rec = dict(case=case, card=smi, sm_ghz=ghz,
                   plan=dict(zip(("chunks", "per", "ts", "nsplit"),
                                 da.split_plan(q.shape[0], kvh, heads // kvh,
                                               per_seq * kp.shape[1],
                                               da._build.sm_count(q.device)))),
                   span_us=med(r["span"] for r in runs),
                   blocks=runs[0]["blocks"],
                   work_blocks=runs[0]["work_blocks"],
                   last_work_start_us=med(r["last_start"] for r in runs))
        for name in phases:
            vals = [v for r in runs for v in r["phase"][name]]
            rec[name] = dict(median_us=round(med(vals), 3),
                             max_us=round(max(vals), 3)) if vals else None
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
