"""Nothing under bench/ imports JAX or the JAX package, the top-level name
compared whole (``repro_torch`` begins with ``repro``), and the plain
reference imports nothing of the program."""
import ast
from pathlib import Path

from bench import run

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_no_jax_anywhere_under_bench():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(set(_imports(f)) & JAX) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in set(_imports(f)), f


def test_the_whole_name_is_compared(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.serving", sys)
    assert run.forbidden_modules() == ["repro"]
