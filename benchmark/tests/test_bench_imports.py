"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program: each import's top-level name,
the part before the first dot, compared whole."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
EVERYWHERE = {"jax", "jaxlib", "flax", "uda_poseestimation_tpu"}
MODULES = sorted(p for p in HERE.rglob("*.py") if "_cache" not in p.parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_imports(path):
    names = top_level_imports(path)
    assert not names & EVERYWHERE, names & EVERYWHERE
    if "reference" in path.relative_to(HERE).parts:
        assert "uda_poseestimation_torch" not in names
        assert "benchmark" not in names  # only its own relative imports


def test_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import uda_poseestimation_torch.ops\nfrom jaxtyping import x\n")
    assert top_level_imports(p) == {"uda_poseestimation_torch", "jaxtyping"}
    assert not top_level_imports(p) & EVERYWHERE
