"""What the benchmark imports: nothing of JAX or of the JAX package
anywhere, and nothing of the program in the reference and the counts.
Top-level module names are compared whole: ``pathtrace_tpu_torch`` begins
with ``pathtrace_tpu`` and is the program."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import common

JAX = {"jax", "jaxlib", "flax", "pathtrace_tpu"}
PROGRAM = {"pathtrace_tpu_torch"}
FILES = sorted(p for p in common.BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(common.BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_reference_takes_nothing_of_the_program(sub):
    for path in (common.BENCH / sub).rglob("*.py"):
        assert not top_level_imports(path) & (JAX | PROGRAM), path


def test_modules_loaded_by_a_run_of_every_driver():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness, benchmark.calibrate\n"
            "from benchmark.drivers import preview, collect, inverse, train\n"
            "import pathtrace_tpu_torch.interactive, pathtrace_tpu_torch.data.collect\n"
            "import pathtrace_tpu_torch.inverse, pathtrace_tpu_torch.train\n"
            "print(benchmark.harness.forbidden_modules())\n") % str(common.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reference_alone_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import tracer, fpn, camera, lattice\n"
            "from benchmark.counts import ops\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
            ) % (str(common.ROOT), JAX | PROGRAM)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
