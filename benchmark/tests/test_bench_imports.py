"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere (top-level names compared whole), and nothing of the program in
the reference."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from .tiny import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "gesture_diffusion_tpu"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH / "reference")))
def test_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "functools", "importlib",
                                       "math", "typing", "numpy", "torch"}


def test_a_run_loads_no_jax():
    """Every module a run imports, in a fresh interpreter, then the
    harness's own look at ``sys.modules``."""
    code = (
        "import sys, importlib; sys.path.insert(0, %r)\n"
        "import benchmark.run, benchmark.control\n"
        "from benchmark.common import harness, serving, program\n"
        "import gesture_diffusion_torch.generation.generator\n"
        "import gesture_diffusion_torch.models.factory\n"
        "import gesture_diffusion_torch.utils.json_config\n"
        "for kind in ('interactive', 'sequence'): harness.traffic_class(kind)\n"
        "import json\n"
        "spec = json.load(open(%r))\n"
        "[harness.metric_reader(m['name']) for m in spec['per_layer']]\n"
        "print(harness.jax_modules())\n") % (str(ROOT), str(ROOT / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    from benchmark.common import harness

    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "flax.core", object())
    monkeypatch.setitem(sys.modules, "gesture_diffusion_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "gesture_diffusion_torch_like", object())
    found = harness.jax_modules()
    assert {"flax.core", "gesture_diffusion_tpu.ops"} <= set(found)
    # the port's name begins with the JAX package's stem, not its name
    assert not [m for m in found if m.startswith(("gesture_diffusion_torch",
                                                  "jaxtyping"))]
