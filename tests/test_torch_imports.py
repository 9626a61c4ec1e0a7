"""The port imports nothing of JAX, nothing of the JAX package and no
``transformers``, and imports ``safetensors`` (absent on some hosts) only
inside the function that reads a safetensors file.

An AST scan, not ``sys.modules``: the interpreter may import jax at start
for reasons of its own. The package name is compared exactly, since
``calipsync_tpu_torch`` starts with ``calipsync_tpu``.
"""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "calipsync_tpu",
             "transformers"}
LAZY_ONLY = {"safetensors", "ultralytics"}
SOURCES = sorted((REPO / "calipsync_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _top_level_imports(path: pathlib.Path,
                       module_level_only: bool = False) -> set[str]:
    """Top-level package names imported anywhere in the file, or only by
    statements that run at import (not inside a def or class)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    nodes = ast.walk(tree)
    if module_level_only:
        nodes = [n for stmt in tree.body
                 if not isinstance(stmt, (ast.FunctionDef,
                                          ast.AsyncFunctionDef, ast.ClassDef))
                 for n in ast.walk(stmt)]
    names = set()
    for node in nodes:
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_scan_covers_the_port():
    assert len(SOURCES) > 10
    assert all(p.exists() for p in SOURCES)
    tools = REPO / "calipsync_tpu_torch" / "tools"
    assert {p.name for p in SOURCES if p.parent == tools} >= {
        "__init__.py", "train_proof.py", "clone_proof.py", "clone_curve.py",
        "hubert_longaudio_delta.py", "soak_streaming.py"}


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = _top_level_imports(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_optional_packages_imported_lazily(path):
    bad = _top_level_imports(path, module_level_only=True) & LAZY_ONLY
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)} " \
                    "at module level"


def test_scan_catches_forbidden_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import calipsync_tpu_torch\nfrom calipsync_tpu import x\n"
                 "def g():\n    import jax.numpy\n")
    assert _top_level_imports(f) & FORBIDDEN == {"calipsync_tpu", "jax"}
    f.write_text("import safetensors\ndef g():\n    import safetensors\n")
    assert _top_level_imports(f, module_level_only=True) == {"safetensors"}
    f.write_text("def g():\n    from safetensors.torch import load_file\n")
    assert _top_level_imports(f, module_level_only=True) == set()
