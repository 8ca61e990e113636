"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports ``jax``, the reference package ``repro`` or
``ml_dtypes`` (the card's machine has none; bf16 goes through bit
patterns)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_has_files():
    assert len(FILES) > 20
    for src in ("etap.cu", "etap_quant.cu", "flash_decode_wgmma.cu",
                "combine.cu", "selective_scan.cu"):
        assert (ROOT / "src/repro_torch/kernels/csrc" / src).exists()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
