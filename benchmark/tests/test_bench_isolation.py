"""Nothing under benchmark/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
reference imports nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.core import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "difashion_tpu"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def sources():
    return sorted(p for p in harness.BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    bad = {str(p): sorted(set(imported_tops(p)) & FORBIDDEN) for p in sources()}
    assert not {k: v for k, v in bad.items() if v}
    # whole names: the port's package is not the JAX package
    assert "difashion_tpu_torch" not in FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for p in (harness.BENCH / "reference").rglob("*.py"):
        tops = set(imported_tops(p))
        assert not tops & (FORBIDDEN | {"difashion_tpu_torch"}), p
        assert tops <= {"__future__", "hashlib", "math", "re", "struct", "typing", "numpy",
                        "torch", "benchmark"}, (p, tops)


def test_loading_every_module_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import importlib, pathlib\n"
            "from benchmark.core import harness\n"
            "for p in sorted(harness.BENCH.rglob('*.py')):\n"
            "    rel = p.relative_to(harness.ROOT).with_suffix('')\n"
            "    if 'tests' in rel.parts or p.name == 'run.py' or '__pycache__' in rel.parts:\n"
            "        continue\n"
            "    if 'metrics' in rel.parts:\n"
            "        harness.load_reader(p.stem)\n"
            "    else:\n"
            "        importlib.import_module('.'.join(rel.parts))\n"
            "import difashion_tpu_torch.engine.pipeline, difashion_tpu_torch.engine.train\n"
            "print(harness.forbidden_modules())\n" % str(harness.ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "[]"
