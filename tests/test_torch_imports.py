"""The port stands alone: no module of ``paddle_tpu_torch``, nor
``chip_smoke.py`` or the port's profiling scripts, imports JAX or the JAX
package, and no import of the port loads them."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SOURCES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("torch_*.py"))


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_paddle_tpu(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle_tpu"), (
            f"{path.relative_to(ROOT)} imports {name}")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, paddle_tpu_torch.models, paddle_tpu_torch.ops, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.jit; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'paddle_tpu')]; print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
