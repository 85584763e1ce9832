"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

FORBIDDEN = ("jax", "jaxlib", "deftet_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_importing_everything_loads_no_jax():
    code = (
        "import sys\n"
        "from benchmark import harness, run, calibrate, counts, trace\n"
        "from benchmark.reference import steps\n"
        "for k in harness.listing()['drivers']: harness.driver(k)\n"
        "for k in harness.listing()['metrics']: harness.reader(k)\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'deftet_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.ROOT.parent, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_names_jax_and_the_reference_none_of_the_program():
    for path in harness.ROOT.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))
        if "reference" in path.relative_to(harness.ROOT).parts:
            assert "deftet_tpu_torch" not in tops, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deftet_tpu_torch_fake", object())
    assert "deftet_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert harness.forbidden_modules() == ["jaxlib.fake"]
