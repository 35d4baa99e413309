"""No file of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port; module names are compared whole
by their top-level part, since ``k8s_tpu_torch`` begins with
``k8s_tpu``."""

from __future__ import annotations

import ast
import pathlib

import pytest

from portbench import common

PKG = pathlib.Path(common.PKG)
FILES = sorted(PKG.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def _top(name):
    return name.split(".", 1)[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if _top(m) in common.FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    bad = [m for m in _imports(path) if _top(m) == "k8s_tpu_torch"]
    assert not bad, f"{path} imports {bad}"


def test_the_scan_compares_top_level_names_whole(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import k8s_tpu_torch.models\nfrom k8s_tpu.ops import a\n"
                 "import jaxtyping\n")
    tops = [_top(m) for m in _imports(f)]
    assert [t for t in tops if t in common.FORBIDDEN] == ["k8s_tpu"]
