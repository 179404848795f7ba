"""Build the port's CUDA kernels into one shared library and bind it.

Every ``.cu`` file under ``paddle_tpu_torch/csrc`` is compiled by ``nvcc``
for ``sm_90a`` (one process per source, all started together), linked
into one shared library with a plain C interface, and loaded with
``ctypes``. No source includes PyTorch's headers, so a build takes seconds.
The library is named after a digest of the sources and flags and lives in
``paddle_tpu_torch/_build`` (listed in ``.gitignore``); it is built at
first use, so a fresh checkout builds it on its first kernel call.

Each kernel's wrapper takes its entry point from :func:`function`, passes
device pointers and ``torch.cuda.current_stream().cuda_stream`` as
``c_void_p``, hands the returned ``cudaError_t`` to :func:`check`, and adds
one to :data:`launch_counts` under its kernel's name (:func:`count`: a
float32 launch as ``<name>[f32]``, so that a run shows which
instantiation ran).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter
from pathlib import Path

import torch

__all__ = ["launch_counts", "library", "function", "check", "expect",
           "count", "FLOATS", "nvcc", "stream_of", "upcast", "build_seconds", "library_file",
           "CSRC_DIR", "BUILD_DIR"]

_PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = _ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# the floating types of the kernels that take both
FLOATS = (torch.bfloat16, torch.float32)

# kernel name -> launches since the last clear(); wrappers bump it right
# after a launch succeeds and nowhere else
launch_counts: Counter = Counter()

_lib: ctypes.CDLL | None = None
_functions: dict[str, ctypes._CFuncPtr] = {}
build_seconds: float | None = None  # wall time of this process's build
library_file: Path | None = None  # the loaded library; its build log beside it


def nvcc() -> str:
    """Path of the nvcc that builds the library."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, target: Path):
    nvcc_bin = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        procs = []
        for src in sources:
            obj = work / (src.stem + ".o")
            cmd = [nvcc_bin, *_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name} (rc={p.returncode})\n{out}")
            if p.returncode:
                failed.append(src.name)
        log = "\n".join(logs)
        (target.with_suffix(".log")).write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = work / target.name
        link = subprocess.run(
            [nvcc_bin, *_ARCH, "-shared", "-o", str(lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib, target)  # atomic: a concurrent loader sees all or none
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _lib, build_seconds, library_file
    if _lib is None:
        sources = sorted(CSRC_DIR.glob("*.cu"))
        digest = _digest(sources + sorted(CSRC_DIR.glob("*.cuh")))
        target = BUILD_DIR / f"libpaddle_tpu_torch_{digest}.so"
        if not target.exists():
            t0 = time.monotonic()
            _compile(sources, target)
            build_seconds = time.monotonic() - t0
        lib = ctypes.CDLL(str(target))
        library_file = target
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def function(name: str, argtypes: list):
    """Entry point ``name`` of the library with its C signature set."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(code: int, name: str):
    """Raise if a launch returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code:
        msg = library().ptt_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def expect(kernel: str, arg: str, t: torch.Tensor, dtype, ndim: int):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (one
    dtype, or a tuple of the dtypes the kernel is built for) with ``ndim``
    dimensions: what every kernel here takes."""
    if not t.is_cuda:
        raise ValueError(f"{kernel}: {arg} must be a CUDA tensor, got "
                         f"{t.device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{kernel}: {arg} must be "
                        f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {arg} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {arg} must be contiguous")


def count(name: str, dtype: torch.dtype):
    """Add one launch of kernel ``name`` at ``dtype`` to
    :data:`launch_counts`: a bfloat16 launch under ``name``, a float32 one
    under ``name[f32]``."""
    launch_counts[name + ("[f32]" if dtype == torch.float32 else "")] += 1


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current stream for ``t``'s device. The library's
    runtime launches in the thread's current context, so ``t`` must live
    on the current device."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {t.device} but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream


def upcast(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the plain versions' working type: f32, or f64 when it is
    already f64 (so that ``torch.autograd.gradcheck`` can run them)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))
