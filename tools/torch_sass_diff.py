#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's kernels between two trees,
function by function.

    python3 tools/torch_sass_diff.py PARENT_DIR [--out FILE]

Builds every ``paddle_tpu_torch/csrc/*.cu`` of this tree and of the tree at
``PARENT_DIR`` to a cubin for ``sm_90a`` with the library's own flags
(``ops/cuda/_build.py``), disassembles each with ``cuobjdump -sass`` and
pairs the functions by demangled name. A kernel that became a template on
its element type pairs with its former self: ``__nv_bfloat16, `` is taken
out of the template arguments before pairing, so ``k<__nv_bfloat16, 4>``
pairs with ``k<4>``. Bodies are compared without addresses and encodings,
with branch labels renumbered per function (an absolute branch target
stays, so a body that moves within its function differs). Prints one JSON object: the
functions that pair and are equal, the ones that pair and differ, and the
ones found in one tree only; ``--out`` also writes the unified diff of the
differing bodies. Needs ``nvcc`` and ``cuobjdump`` (the card's machine).
"""
from __future__ import annotations

import argparse
import difflib
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _tool(name):
    from paddle_tpu_torch.ops.cuda import _build

    path = Path(_build.nvcc()).with_name(name)
    return str(path) if path.exists() else shutil.which(name)


def sass_functions(csrc: Path, work: Path) -> dict[str, list[str]]:
    """{paired name: normalised SASS lines} of every kernel in ``csrc``."""
    from paddle_tpu_torch.ops.cuda import _build

    flags = _build._ARCH + ["-std=c++17", "-O3"]  # the library's, device side
    procs = []
    for src in sorted(csrc.glob("*.cu")):
        cubin = work / f"{src.stem}.cubin"
        procs.append((cubin, subprocess.Popen(
            [_build.nvcc(), *flags, "-cubin", str(src), "-o", str(cubin)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for cubin, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {cubin.name}:\n{out}")
    funcs = {}
    for cubin, _ in procs:
        # a source with no kernel (errors.cu) has no SASS to list
        text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True).stdout
        funcs.update(_split(text))
    return funcs


def _split(text):
    out, name, body = {}, None, []
    for line in text.splitlines() + ["Function : "]:
        m = re.search(r"Function : (\S*)", line)
        if m:
            if name:
                out[_pair_name(name)] = _normalise(body)
            name, body = m.group(1), []
        elif name:
            body.append(line)
    return out


def _pair_name(mangled):
    """The demangled name, with a bf16 instantiation of a kernel that is a
    template on its element type written as the kernel was before: the
    type argument dropped and its parameters' ``T1`` spelled out."""
    name = subprocess.run([_tool("cu++filt") or "c++filt", mangled],
                          capture_output=True, text=True,
                          check=True).stdout.strip()
    name = name.removeprefix("void ")
    if "<__nv_bfloat16" in name:
        name = name.replace("<__nv_bfloat16>", "").replace(
            "<__nv_bfloat16, ", "<").replace("T1", "__nv_bfloat16")
    return name


def _normalise(body):
    labels, lines = {}, []
    for line in body:
        # addresses /*0010*/ and encodings /* 0x... */
        line = re.sub(r"/\*\s*[0-9a-fx]+\s*\*/", "", line).strip()
        if not line or line.startswith(".headerflags"):
            continue
        line = re.sub(r"\.L_x_\d+",
                      lambda m: labels.setdefault(m.group(0),
                                                  f".L{len(labels)}"), line)
        lines.append(re.sub(r"\s+", " ", line))
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "new").mkdir()
        (tmp / "old").mkdir()
        new = sass_functions(ROOT / "paddle_tpu_torch/csrc", tmp / "new")
        old = sass_functions(args.parent / "paddle_tpu_torch/csrc",
                             tmp / "old")
    same = sorted(n for n in old if n in new and old[n] == new[n])
    differ = sorted(n for n in old if n in new and old[n] != new[n])
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        with args.out.open("w") as f:
            for n in differ:
                f.write(f"== {n}\n")
                f.writelines(l + "\n" for l in difflib.unified_diff(
                    old[n], new[n], "parent", "this tree", lineterm=""))
    print(json.dumps({"same": len(same), "differ": differ,
                      "only_in_parent": sorted(set(old) - set(new)),
                      "only_in_this_tree": sorted(set(new) - set(old)),
                      "same_functions": same}))
    return 1 if differ or set(old) - set(new) else 0


if __name__ == "__main__":
    sys.exit(main())
