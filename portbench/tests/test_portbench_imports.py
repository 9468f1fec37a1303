"""By the syntax tree: the references import nothing of JAX, pffft_tpu or the port,
and no module of the benchmark imports JAX or pffft_tpu."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "pffft_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            elif node.level > 1 or path.parent.name != "reference":
                names.add("portbench")  # a relative import out of its own package
    return names


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_import_nothing_of_the_programs(path):
    found = top_level_imports(path)
    assert not found & (JAX_SIDE | {"pffft_tpu_torch", "portbench"}), found


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_pffft_tpu(path):
    assert not top_level_imports(path) & JAX_SIDE

