"""The port imports nothing of the JAX package or of JAX, at any depth.

`test_port_imports_no_jax` (test_torch_sampling.py) imports the entry
modules and inspects `sys.modules`, which cannot see an import inside a
function that no test calls (the grabcut branch of
`pipeline.remove_background` imported the JAX package's matting module
that way).  This file parses every `.py` of `open_diffusiongs_tpu_torch/`
with `ast` and fails on any `import` or `from ... import` of a forbidden
package, module-level or function-local: the JAX package, JAX and its
libraries, and the `lpips` package (the port converts its weights itself,
`tools/convert_lpips_weights.py`).  So do `chip_smoke.py`,
`chip_probe_nan.py` and `chip_probe_bwd.py`, the root scripts that drive
it on the card.  The
two weight converters also run as `python -m` entry points.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "open_diffusiongs_tpu_torch"
FORBIDDEN = ("open_diffusiongs_tpu", "jax", "jaxlib", "flax", "optax", "orbax",
             "lpips")


def forbidden_imports(source: str) -> list:
    """(line, module) of every absolute import of a FORBIDDEN package in
    `source`, at any nesting depth; relative imports stay inside the
    package and are allowed."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        found += [(node.lineno, m) for m in mods
                  if m.split(".")[0] in FORBIDDEN]
    return found


def _port_files():
    return sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py"))


@pytest.mark.parametrize("path", _port_files())
def test_module_imports_no_jax_side(path):
    assert forbidden_imports((ROOT / path).read_text()) == []


@pytest.mark.parametrize("path", ["chip_smoke.py", "chip_probe_nan.py",
                                  "chip_probe_bwd.py"])
def test_chip_scripts_import_no_jax_side(path):
    """The root scripts that drive the port on the card."""
    assert forbidden_imports((ROOT / path).read_text()) == []


@pytest.mark.parametrize("snippet,mods", [
    ("import jax", ["jax"]),
    ("import numpy as np, jax.numpy as jnp", ["jax.numpy"]),
    ("from flax import linen", ["flax"]),
    ("def f():\n    if True:\n        from open_diffusiongs_tpu.utils "
     "import matting\n", ["open_diffusiongs_tpu.utils"]),
    ("class A:\n    def g(self):\n        import optax, orbax.checkpoint\n",
     ["optax", "orbax.checkpoint"]),
    ("from .utils import matting\nimport open_diffusiongs_tpu_torch\n"
     "import jaxtyping\n", []),
])
def test_scanner_finds_imports_at_any_depth(snippet, mods):
    assert [m for _, m in forbidden_imports(snippet)] == mods


@pytest.mark.parametrize("tool", ["convert_lpips_weights",
                                  "convert_u2net_weights"])
def test_weight_converters_run_as_modules(tool):
    path = f"open_diffusiongs_tpu_torch/tools/{tool}.py"
    assert path in _port_files()
    assert forbidden_imports((ROOT / path).read_text()) == []
    out = subprocess.run(
        [sys.executable, "-m", f"open_diffusiongs_tpu_torch.tools.{tool}",
         "--help"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--out" in out.stdout
