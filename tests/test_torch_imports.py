"""repro_torch stands alone: no file of it (nor chip_smoke.py) imports jax
or the JAX package, and its entry points refuse to run without a card
unless the caller asks for the CPU."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args and \
                isinstance(node.args[0], ast.JoinedStr | ast.Constant):
            first = node.args[0]
            text = first.value if isinstance(first, ast.Constant) else \
                first.values[0].value
            roots.add(text.split(".")[0])
    return roots


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"ops.py", "engine.py", "transformer.py", "mamba2.py",
            "_bridge.py", "chip_smoke.py", "qwen3_14b.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch import models
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import RunConfig
    from repro_torch.serve import ServeEngine
    cfg = get_smoke_config("qwen3-14b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        models.init_cache(cfg, 1, 8)
    params = models.init(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, RunConfig(), params)
