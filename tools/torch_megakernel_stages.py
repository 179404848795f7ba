#!/usr/bin/env python3
"""Where the decode megakernel's time goes, stage by stage, on one GPU.

    python3 tools/torch_megakernel_stages.py

Builds a copy of ``paddle_tpu_torch/csrc/decode_megakernel.cuh`` with a
``%globaltimer`` stamp by thread 0 of every block just before and just after
each ``grid_sync``, and at the kernel's start and end, into a library of its
own (the repo's library is not touched), and launches it on
chip_smoke.py's ``megakernel_setup`` inputs at ``MK_CASES`` (warm L2, five
launches after five of warm-up, the median of each stamp). A stage's time
is from the last block leaving the barrier before it to the last block
reaching the barrier after it; a barrier's, from the last block reaching it
to the last block leaving it. The stamps go past the barrier word in the
kernel's state buffer, which is allocated larger here. Prints one JSON
object a case, in us, with the card's name and power limit. The timer
ticks in steps of ~0.26 us on the H100.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

STAMP = ("#define PTT_STAMP(i) if (threadIdx.x == 0) { "
         "unsigned long long t_; "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
         "reinterpret_cast<unsigned long long*>(a.bar + 64)"
         "[blockIdx.x * 32 + (i)] = t_; }\n")


def stamped_source(src: str) -> tuple[str, int]:
    """The kernel source with stamps at every grid_sync of the kernel body,
    and the number of stamps."""
    start = src.index("decode_layer_kernel(const __grid_constant__")
    head, body = src[:start], src[start:]
    n = [0]

    def sub(_):
        n[0] += 2
        return (f"  PTT_STAMP({n[0] - 1}); grid_sync(a.bar); "
                f"PTT_STAMP({n[0]});")

    body = re.sub(r"  grid_sync\(a\.bar\);", sub, body)
    body = body.replace("  const Gemm& ga = a.ga;\n",
                        "  const Gemm& ga = a.ga;\n  PTT_STAMP(0);\n", 1)
    end = body.index("template <typename T>\nint launch(")
    last = body.rindex("}\n", 0, end)
    body = body[:last] + f"  PTT_STAMP({n[0] + 1});\n" + body[last:]
    head = head.replace('#include "common.cuh"',
                        '#include "common.cuh"\n' + STAMP, 1)
    return head + body, n[0] + 2


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from paddle_tpu_torch import seed
    from paddle_tpu_torch.ops.cuda import _build

    csrc = ROOT / "paddle_tpu_torch/csrc"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="stages-", dir=_build.BUILD_DIR))
    src, nstamps = stamped_source((csrc / "decode_megakernel.cuh")
                                  .read_text())
    (work / "decode_megakernel.cuh").write_text(src)
    for f in ("common.cuh", "decode_megakernel_bf16.cu",
              "decode_megakernel_f32.cu", "errors.cu"):
        (work / f).write_text((csrc / f).read_text())
    lib = work / "libstages.so"
    subprocess.run([_build.nvcc(), *_build._FLAGS, "-shared", "-o", str(lib),
                    *(str(work / f) for f in ("decode_megakernel_bf16.cu",
                                              "decode_megakernel_f32.cu",
                                              "errors.cu"))],
                   check=True, capture_output=True)
    L = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    L.ptt_fused_decode_layer_scratch.argtypes = (
        [I] * 8 + [ctypes.POINTER(ctypes.c_longlong)])
    names = ["A", "barrier", "A2", "barrier", "B", "barrier", "B2",
             "barrier", "C", "barrier", "D"]
    smi = cs.smi_line()
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (case, widths, dtype, _) in enumerate(cs.MK_CASES):
        gen = seed(40 + i, "cuda")

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device="cuda") * std

        with torch.no_grad():
            _, x, kp, vp, args = cs.megakernel_setup(cs.mk_cfg(widths), gen,
                                                     randn, dtype)
        b, _, hidden = x.shape
        n_pages, page, kvh, d = kp.shape
        heads, cols = args["heads"], args["tables"].shape[1]
        sizes = (ctypes.c_longlong * 2)()
        if L.ptt_fused_decode_layer_scratch(x.element_size(), b, hidden,
                                            heads, kvh, d, page,
                                            args["attn_pages"], sizes):
            raise RuntimeError(f"{case}: shapes refused")
        work_buf = torch.empty(sizes[0], dtype=torch.uint8, device="cuda")
        state = torch.zeros(64 + blocks * 64, dtype=torch.int32,
                            device="cuda")
        fn = getattr(L, "ptt_fused_decode_layer_f32"
                     if dtype == torch.float32 else "ptt_fused_decode_layer")
        fn.argtypes = [P] * 17 + [I] * 10 + [F] * 3 + [P]
        h, y = torch.empty_like(x), torch.empty_like(x)
        ptrs = [x, args["ln1_weight"], args["ln2_weight"], args["wq"],
                args["wk"], args["wv"], args["wo"], args["rope_cos"],
                args["rope_sin"], kp, vp, args["tables"], args["lengths"], h,
                y, work_buf, state]

        def call():
            rc = fn(*(t.data_ptr() for t in ptrs), b, hidden, heads, kvh, d,
                    args["rope_cos"].shape[0], page, n_pages, cols,
                    args["attn_pages"], args["ln1_eps"], args["ln2_eps"],
                    d ** -0.5, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{case}: CUDA error {rc}")

        for _ in range(5):
            call()
        runs = []
        for _ in range(5):
            call()
            torch.cuda.synchronize()
            st = (state[64:].view(torch.int64).view(blocks, 32)[:, :nstamps]
                  .cpu().double())
            runs.append((st - st[:, 0].min()).max(0).values / 1e3)
        t = torch.stack(runs).median(0).values.tolist()
        stages = [round(t[k + 1] - t[k], 2) for k in range(nstamps - 1)]
        print(json.dumps({"case": case, "card": smi,
                          "total_us": round(t[nstamps - 1], 2),
                          "stages_us": list(zip(names, stages))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
