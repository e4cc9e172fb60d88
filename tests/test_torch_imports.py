"""The port stands alone: neither its package nor the scripts that drive it
on the card (chip_smoke.py) import JAX or anything of the JAX package."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "neural_speech_decoding_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "neural_speech_decoding_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_files_exist():
    assert (PORT / "__init__.py").is_file()
    assert (REPO / "chip_smoke.py").is_file()
    for name in ("kuramoto_pair_sums", "bandcov_grams", "logcov_feats", "logm_clenshaw", "iir_cascade"):
        assert (PORT / "csrc" / f"{name}.cu").is_file()
    assert (PORT / "csrc" / "sym8_eigen.cuh").is_file()


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"
    text = path.read_text()
    assert "import jax" not in text
    assert "neural_speech_decoding_tpu." not in text.replace("neural_speech_decoding_tpu_torch.", "")
