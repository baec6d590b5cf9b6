"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports the JAX package (``repro``, ``repro.*``) or JAX
(``jax``, ``jaxlib``, ``jax.*``).  Only the tests import both packages.

Each file is parsed, not imported, so an import inside a function (the
port builds and loads its kernels lazily) is caught too.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(str(p.relative_to(ROOT))
               for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
FILES.append("chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top == "repro" or top.startswith("jax")


def imported_modules(tree: ast.AST) -> list[tuple[int, str]]:
    """(line, absolute module name) of every import in ``tree``; relative
    imports stay inside their own package and are skipped."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module or ""))
    return out


def test_the_walk_sees_the_port():
    assert len(FILES) > 30
    assert "src/repro_torch/storage/durable/segment.py" in FILES


def test_every_reference_module_has_a_counterpart():
    """Each module of src/repro has one at the same relative path under
    src/repro_torch (the mesh, dry-run, roofline and analysis modules
    were the last)."""
    ref = ROOT / "src" / "repro"
    missing = [str(p.relative_to(ref)) for p in sorted(ref.rglob("*.py"))
               if not (ROOT / "src" / "repro_torch" / p.relative_to(ref))
               .exists()]
    assert missing == []
    for rel in ("analysis/engine.py", "launch/mesh.py", "launch/dryrun.py",
                "roofline.py"):
        assert f"src/repro_torch/{rel}" in FILES


@pytest.mark.parametrize("path", FILES)
def test_imports_nothing_of_repro_or_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = [(ln, m) for ln, m in imported_modules(tree) if _forbidden(m)]
    assert bad == [], f"{path} imports {bad}"


def test_the_check_catches_a_forbidden_import():
    src = ("import os\nfrom . import x\nimport repro_torch.core\n"
           "def f():\n    import jax.numpy as jnp\n"
           "    from repro.core import ForkBase\n")
    found = [m for _, m in imported_modules(ast.parse(src))
             if _forbidden(m)]
    assert found == ["jax.numpy", "repro.core"]
