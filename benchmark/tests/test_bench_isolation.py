"""No module of the run is JAX or the JAX package, and the plain
reference loads nothing of the system under test; top-level names are
compared whole (``scan_tpu_torch`` is not ``scan_tpu``)."""

import ast
import subprocess
import sys

from benchmark.harness import core


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_names_compare_whole():
    assert core.forbidden_modules(["scan_tpu_torch", "scan_tpu_torch.ops",
                                   "jaxtyping", "flaxen"]) == []
    assert core.forbidden_modules(["scan_tpu.ops", "jax._src", "optax"]) == [
        "jax", "optax", "scan_tpu"]


def test_reference_imports_neither_jax_nor_the_system():
    for path in (core.HERE / "reference").glob("*.py"):
        bad = top_level_imports(path) & {*core.FORBIDDEN, "scan_tpu_torch"}
        assert not bad, (path.name, bad)


def run_and_list(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT,
                         capture_output=True, text=True, check=True)
    return out.stdout.split()


def test_reference_loads_nothing_of_the_system():
    mods = run_and_list(
        "import sys; import benchmark.reference.model, benchmark.reference.step;"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "scan_tpu_torch" not in mods
    assert not set(mods) & set(core.FORBIDDEN)


def test_harness_loads_no_jax():
    mods = run_and_list(
        "import sys, benchmark.run; from benchmark.traffic import da_step, eval_loop;"
        "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "scan_tpu_torch" in mods  # the system is loaded ...
    assert not set(mods) & set(core.FORBIDDEN)  # ... and nothing of JAX
