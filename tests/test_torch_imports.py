"""The port imports nothing of JAX and nothing of the JAX package.

An AST scan, not ``sys.modules``: the interpreter may import jax at start
for reasons of its own. The package name is compared exactly, since
``calipsync_tpu_torch`` starts with ``calipsync_tpu``.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "calipsync_tpu"}
SOURCES = sorted((REPO / "calipsync_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _top_level_imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_scan_covers_the_port():
    assert len(SOURCES) > 10
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = _top_level_imports(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_scan_catches_forbidden_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import calipsync_tpu_torch\nfrom calipsync_tpu import x\n"
                 "def g():\n    import jax.numpy\n")
    assert _top_level_imports(f) & FORBIDDEN == {"calipsync_tpu", "jax"}
