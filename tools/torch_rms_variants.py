#!/usr/bin/env python3
"""The RMSNorm kernels' design choices, timed against the port's own in
one process on one GPU.

    python3 tools/torch_rms_variants.py

Builds copies of ``paddle_tpu_torch/csrc/rms_norm.cu`` and
``rms_norm_wide.cu`` apart (nvcc,
sm_90a, into a temporary directory under ``paddle_tpu_torch/_build``),
each a variant of one choice, loads each in turn behind the port's
wrappers (``ops/cuda/rms_norm.py``) and times the same calls with
chip_smoke.py's ``graph_ms`` / ``cold_ms``, each result first held
against the plain version (bf16 within 1e-3 + 2^-7 relative, f32 within
1e-4 + 1e-4, r within 1e-5 relative; dw and db also bit for bit across
two calls):

- ``port``: the source as it is; its f32 backward also with the warps a
  row forced to 2, 4 and 8 (``split``);
- ``cluster``: the wide forward with a row spread over a thread block
  cluster of 2 or 4 blocks (``CLUSTER_KERNEL`` below: each block a share
  of the row's vectors, the blocks' warp sums met through distributed
  shared memory behind a cluster barrier, then the same fixed-order sum
  in every warp);
- ``t256``: the wide forward at 256 threads a block instead of 512 (up to
  8 vectors a thread: f32 (8, 12288) is left out);
- ``bwd_b2``: the f32 backward under ``__launch_bounds__(256, 2)`` (at
  most 128 registers, two blocks an SM).

Forward cases: bf16 (8, 12288), (1, 12288), (1024, 12288) (also cold),
(8, 8192), (8, 16384); f32 (8, 3072), (8, 12288); ``F.rms_norm`` beside
each. Backward cases (f32): (6144, 1536), (1024, 1536), (6144, 3072),
its two launches timed apart (``launch_split``). Prints the build's
registers and spills of the variant kernels and one JSON object with the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

CLUSTER_KERNEL = r'''
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ float load_cluster(const float* p, unsigned rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(ptt::smem_addr(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(a) : "memory");
  return v;
}

template <typename T, int kVecs, int kCluster>
__global__ void __launch_bounds__(kWideThreads)
rms_norm_fwd_cluster_kernel(const T* __restrict__ x, const T* __restrict__ w,
                            const T* __restrict__ bias, T* __restrict__ y,
                            float* __restrict__ r, int d, float eps) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  __shared__ float red[kWideWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned rank = cluster_rank();
  const long long row = blockIdx.x / kCluster;
  const int nvec = d / kN;
  const auto* xr = reinterpret_cast<const uint4*>(x + row * d);
  const auto* wv = reinterpret_cast<const uint4*>(w);
  const auto* bv = reinterpret_cast<const uint4*>(bias);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 xs[kVecs], ws[kVecs], bs[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * kCluster + static_cast<int>(rank)) * kWideThreads +
                  static_cast<int>(threadIdx.x);
    const bool in = c < nvec;
    xs[i] = in ? xr[c] : zero;
    ws[i] = in && w != nullptr ? wv[c] : zero;
    bs[i] = in && bias != nullptr ? bv[c] : zero;
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    float f[kN];
    V::unpack(xs[i], f);
#pragma unroll
    for (int j = 0; j < kN; ++j) ss = fmaf(f[j], f[j], ss);
  }
  ss = ptt::warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  cluster_arrive();
  cluster_wait();
  float t = 0.f;
#pragma unroll
  for (int p = lane; p < kWideWarps * kCluster; p += 32) {
    t += load_cluster(red + p % kWideWarps, p / kWideWarps);
  }
  t = ptt::warp_sum(t);
  cluster_arrive();  // done with the others' red
  const float rs = rsqrtf(t / static_cast<float>(d) + eps);
  if (rank == 0 && threadIdx.x == 0) r[row] = rs;
  auto* yr = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = (i * kCluster + static_cast<int>(rank)) * kWideThreads +
                  static_cast<int>(threadIdx.x);
    if (c < nvec) {
      float f[kN], wf[kN], bf[kN], o[kN];
      V::unpack(xs[i], f);
      V::unpack(ws[i], wf);
      V::unpack(bs[i], bf);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        o[j] = f[j] * rs * (w != nullptr ? wf[j] : 1.f) + bf[j];
      }
      yr[c] = V::pack(o);
    }
  }
  cluster_wait();  // a block's shared memory outlives the others' reads
}

template <typename T, int kVecs, int kCluster>
cudaError_t launch_cluster_v(const T* x, const T* w, const T* b, T* y,
                             float* r, int n, int d, float eps,
                             cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n) * kCluster);
  cfg.blockDim = dim3(kWideThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(
      &cfg, rms_norm_fwd_cluster_kernel<T, kVecs, kCluster>, x, w, b, y, r,
      d, eps);
}

template <typename T, int kCluster>
cudaError_t launch_cluster_c(const T* x, const T* w, const T* b, T* y,
                             float* r, int n, int d, float eps,
                             cudaStream_t st) {
  constexpr int kPass = Vec16<T>::kN * kWideThreads * kCluster;
  const int v = (d + kPass - 1) / kPass;
  if (v <= 1) return launch_cluster_v<T, 1, kCluster>(x, w, b, y, r, n, d, eps, st);
  if (v <= 2) return launch_cluster_v<T, 2, kCluster>(x, w, b, y, r, n, d, eps, st);
  if (v <= 3) return launch_cluster_v<T, 3, kCluster>(x, w, b, y, r, n, d, eps, st);
  if (v <= 4) return launch_cluster_v<T, 4, kCluster>(x, w, b, y, r, n, d, eps, st);
  if (v <= 6) return launch_cluster_v<T, 6, kCluster>(x, w, b, y, r, n, d, eps, st);
  return launch_cluster_v<T, 8, kCluster>(x, w, b, y, r, n, d, eps, st);
}

'''
FWD_CASES = [(8, 12288, torch.bfloat16), (1, 12288, torch.bfloat16),
             (1024, 12288, torch.bfloat16), (8, 8192, torch.bfloat16),
             (8, 16384, torch.bfloat16), (8, 3072, torch.float32),
             (8, 12288, torch.float32)]
BWD_CASES = [(6144, 1536), (1024, 1536), (6144, 3072)]


def sources():
    """{variant: {file name: source text}}: rms_norm.cu with an exported
    ``ptt_rms_variant_split(split)``, rms_norm_wide.cu with
    ``ptt_rms_variant_cluster(cluster)`` (0: the source's own choice)."""
    csrc = ROOT / "paddle_tpu_torch/csrc"
    main_src = (csrc / "rms_norm.cu").read_text()
    wide_src = (csrc / "rms_norm_wide.cu").read_text()

    def sub(text, old, new):
        if old not in text:
            raise SystemExit(f"the RMSNorm sources have changed: {old!r} "
                             "not found")
        return text.replace(old, new, 1)

    main_src = sub(main_src, '#include "common.cuh"\n',
                   '#include "common.cuh"\nstatic int g_split = 0;\n')
    main_src = sub(main_src, "    int split = 1;\n    while (split",
                   "    int split = g_split ? g_split : 1;\n"
                   "    while (g_split == 0 && split")
    main_src += ("\nPTT_EXPORT void ptt_rms_variant_split(int s) "
                 "{ g_split = s; }\n")
    wide_src = sub(wide_src, '#include "common.cuh"\n',
                   '#include "common.cuh"\nstatic int g_cluster = 0;\n')
    wide_src += ("\nPTT_EXPORT void ptt_rms_variant_cluster(int c) "
                 "{ g_cluster = c; }\n")
    end = "}  // namespace\n\n// The wide kernel at the vectors"
    cluster = sub(wide_src, end, CLUSTER_KERNEL + end)
    cluster = sub(cluster, "  if (d > kWideMaxD) return false;\n", (
        "  if (d > kWideMaxD) return false;\n"
        "  if (g_cluster == 2) {\n"
        "    launch_cluster_c<T, 2>(x, w, b, y, r, n, d, eps, st);\n"
        "    return true;\n"
        "  }\n"
        "  if (g_cluster == 4) {\n"
        "    launch_cluster_c<T, 4>(x, w, b, y, r, n, d, eps, st);\n"
        "    return true;\n"
        "  }\n"))
    # twice the vectors a thread: bf16 past 4 too
    t256 = sub(sub(wide_src, "constexpr int kWideThreads = 512;",
                   "constexpr int kWideThreads = 256;"),
               "  } else if constexpr (sizeof(T) == 2) {\n"
               "    PTT_RMS_WIDE(4);\n", "")
    b2 = sub(main_src, "__global__ void __launch_bounds__(kThreads)\n"
             "rms_norm_bwd_f32_rows_kernel",
             "__global__ void __launch_bounds__(kThreads, 2)\n"
             "rms_norm_bwd_f32_rows_kernel")
    return {"port": {"rms_norm.cu": main_src, "rms_norm_wide.cu": wide_src},
            "cluster": {"rms_norm.cu": main_src,
                        "rms_norm_wide.cu": cluster},
            "t256": {"rms_norm.cu": main_src, "rms_norm_wide.cu": t256},
            "bwd_b2": {"rms_norm.cu": b2, "rms_norm_wide.cu": wide_src}}


def build(nvcc, variants, work):
    """Each variant's library, built in parallel; returns {variant: path}
    and the ptxas lines of the variant kernels."""
    csrc = ROOT / "paddle_tpu_torch/csrc"
    shutil.copy(csrc / "common.cuh", work)
    shutil.copy(csrc / "errors.cu", work)
    procs = {}
    for name, files in variants.items():
        (work / name).mkdir()
        shutil.copy(csrc / "common.cuh", work / name)
        for fname, text in files.items():
            (work / name / fname).write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-shared", "-o",
             str(work / f"lib{name}.so"),
             *[str(work / name / f) for f in files], str(work / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    usage = []
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out[-8000:]}")
        lines = out.splitlines()
        for i, ln in enumerate(lines):
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m and re.search(r"wide|cluster|f32_rows", m.group(1)):
                regs = " ".join(x.strip() for x in lines[i + 1:i + 4]
                                if "registers" in x or "spill" in x)
                usage.append(f"{name} {m.group(1)}: {regs}")
    return {name: work / f"lib{name}.so" for name in variants}, usage


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(ROOT))
    from paddle_tpu_torch.ops.cuda import _build
    from paddle_tpu_torch.ops.cuda import rms_norm as rn

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="rms-variants-", dir=_build.BUILD_DIR))
    try:
        libs, usage = build(_build.nvcc(), sources(), work)
        print("\n".join(usage), flush=True)
        out = {"card": cs.smi_line()}
        gen = torch.Generator(device="cuda").manual_seed(90)

        def randn(*shape, dtype=torch.float32):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.ptt_error_string.argtypes = [ctypes.c_int]
            lib.ptt_error_string.restype = ctypes.c_char_p
            lib.ptt_rms_variant_split.argtypes = [ctypes.c_int]
            lib.ptt_rms_variant_cluster.argtypes = [ctypes.c_int]
            _build._lib = lib
            _build._functions.clear()
            out[name] = rec = {}
            if name != "bwd_b2":
                for cluster in ((2, 4) if name == "cluster" else (0,)):
                    lib.ptt_rms_variant_cluster(cluster)
                    for n, d, dtype in FWD_CASES:
                        if name == "t256" and d * dtype.itemsize > 8 * 4096:
                            continue  # past 8 vectors a thread
                        rec[f"fwd ({n}, {d}) {dtype} c{cluster}"] = fwd_case(
                            cs, rn, randn, n, d, dtype, name == "port")
            if name in ("port", "bwd_b2"):
                for split in ((0, 2, 4, 8) if name == "port" else (0,)):
                    lib.ptt_rms_variant_split(split)
                    for n, d in BWD_CASES:
                        rec[f"bwd ({n}, {d}) split {split}"] = bwd_case(
                            cs, rn, randn, n, d)
            lib.ptt_rms_variant_cluster(0)
            lib.ptt_rms_variant_split(0)
        print(json.dumps(out), flush=True)
    finally:
        _build._lib = None
        _build._functions.clear()
        shutil.rmtree(work, ignore_errors=True)
    return 0


def fwd_case(cs, rn, randn, n, d, dtype, library):
    x = randn(n, d, dtype=dtype)
    w, b = (1 + 0.1 * randn(d)).to(dtype), (0.1 * randn(d)).to(dtype)
    y, r = rn.rms_norm_rows(x, w, b, epsilon=1e-5)
    py, pr = rn.rms_norm_plain(x, w, b, epsilon=1e-5)
    atol, rtol = (1e-3, 2.0 ** -7) if dtype == torch.bfloat16 else (1e-4, 1e-4)
    if not (((y.float() - py.float()).abs() <= atol + rtol * py.float().abs())
            .all() and ((r - pr).abs() <= 1e-5 * pr.abs()).all()):
        raise SystemExit(f"forward ({n}, {d}) {dtype}: beyond the gate")
    rec = dict(ms=cs.graph_ms(lambda: rn.rms_norm_rows(x, w, epsilon=1e-5)))
    if n >= 1024:
        rec["cold_ms"] = cs.cold_ms(
            lambda xx: rn.rms_norm_rows(xx, w, epsilon=1e-5), (x,))
    if library:
        rec["library_ms"] = cs.graph_ms(
            lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-5))
    return rec


def bwd_case(cs, rn, randn, n, d):
    x, g, w = randn(n, d), randn(n, d), 1 + 0.1 * randn(d)
    _, r = rn.rms_norm_plain(x, w, epsilon=1e-6)
    got, again = rn.rms_norm_bwd(x, w, r, g), rn.rms_norm_bwd(x, w, r, g)
    for a, want in zip(got, rn.rms_norm_bwd_plain(x, w, r, g)):
        if not ((a - want).abs() <= 1e-4 + 1e-4 * want.abs()).all():
            raise SystemExit(f"backward ({n}, {d}): beyond the gate")
    if not all(torch.equal(a, b) for a, b in zip(got[1:], again[1:])):
        raise SystemExit(f"backward ({n}, {d}): dw, db differ across calls")
    return dict(ms=cs.graph_ms(lambda: rn.rms_norm_bwd(x, w, r, g), calls=10),
                launches_ms=cs.launch_split(
                    lambda: rn.rms_norm_bwd(x, w, r, g)))


if __name__ == "__main__":
    sys.exit(main())
