"""Nothing the benchmark runs loads JAX or the JAX package (whole top-level names)."""

import ast
import subprocess
import sys

from conftest import REPO
from portbench import run


def test_forbidden_names_are_compared_whole():
    names = ["kb2e_tpu_torch", "kb2e_tpu_torch.ops", "jaxtyping", "flaxen", "jax.numpy", "jaxlib", "kb2e_tpu.models",
             "kb2e_tpu", "flax"]
    assert run.forbidden_modules(names) == ["flax", "jax.numpy", "jaxlib", "kb2e_tpu", "kb2e_tpu.models"]


def test_no_benchmark_source_imports_a_forbidden_module():
    for path in (REPO / "portbench").rglob("*.py"):
        if "tests" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not run.forbidden_modules(names), (path, names)


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, tempfile, pathlib; sys.path[:0] = [{repo!r}, {tests!r}];"
            "from conftest import tiny_root; from portbench import cell, spec, run;"
            "root = tiny_root(pathlib.Path(tempfile.mkdtemp()));"
            "cell.run(spec.load('transr-fb15k.train', root), 5, 0.2, True, device='cpu');"
            "cell.run(spec.load('transe-fb15k.eval', root), 5, 0.2, False, device='cpu');"
            "print(run.forbidden_modules(sys.modules))").format(repo=str(REPO), tests=str(REPO / "portbench/tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
