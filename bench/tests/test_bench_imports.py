"""Nothing the benchmark runs imports JAX, the JAX package or the JAX
package's benchmarks, compared by whole top-level name; the reference
imports nothing of the program."""
import ast
import sys

from bench.harness import core

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(core.BENCH_DIR.rglob("*.py"))
    assert len(files) > 20
    for path in files:
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (core.BENCH_DIR / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_forbidden_modules_compares_whole_top_level_names():
    assert core.forbidden_modules(["repro_torch", "repro_torch.core",
                                   "reprox", "jaxtyping"]) == []
    assert core.forbidden_modules(["repro.core", "jax", "jax.numpy",
                                   "flax"]) == ["flax", "jax", "jax.numpy",
                                                "repro.core"]


def test_a_run_on_the_cpu_loads_no_jax():
    from bench.tests import tiny
    before = set(sys.modules)
    tiny.run("ledger.light-client")
    assert not core.forbidden_modules(set(sys.modules) - before)
