"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the JAX package
``repro`` (an AST scan, so imports inside functions and under
``TYPE_CHECKING`` count too).  Every module also imports without a GPU.
"""
import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FILES = PORT + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path} imports {bad}"


def test_every_port_module_imports_without_gpu():
    assert len(PORT) > 20
    for p in PORT:
        rel = p.relative_to(ROOT / "src").with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__init__"):
            name = name[:-len(".__init__")]
        importlib.import_module(name)
