"""What the benchmark may import: nothing under ``acsbench/`` imports JAX
(``jax``, ``jaxlib``, ``flax``) or the JAX package (``repro``), and the
plain reference (``acsbench/reference/``) imports nothing of the program
(``repro_torch``). Names are compared whole, by the part before the first
dot, so ``repro_torch`` is not ``repro``."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "repro"}


def _top_names(path: Path):
    """The top-level module names a file imports, relative imports resolved
    inside ``acsbench``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            yield "acsbench" if node.level else (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    bad = set(_top_names(path)) & JAX_NAMES
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_names(path))
    assert "repro_torch" not in names and not names & JAX_NAMES, names


def test_reference_loads_no_program_module():
    code = ("import sys; import acsbench.reference.model, acsbench.compare; "
            "bad = sorted({n.split('.')[0] for n in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
