"""The port stands alone: neither its package nor the scripts that drive it
on the card (chip_smoke.py) import JAX, anything of the JAX package, the
reference app's shim over it (`Utilities`), or the repository's `tools`
package (which drives the JAX package)."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "neural_speech_decoding_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "neural_speech_decoding_tpu", "tools", "Utilities")


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


def _exported(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    return {alias.asname or alias.name for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)
            for alias in node.names}


@pytest.mark.parametrize("sub", ["parallel", "train"])
def test_package_exports_match_jax(sub):
    """The port's parallel/ and train/ export what the JAX package's do
    (parallel: make_mesh, mesh_axes, batch_sharding, replicate,
    shard_params_tp, sharded_predict_fn; train: TrainState among them)."""
    import importlib

    port = importlib.import_module(f"neural_speech_decoding_tpu_torch.{sub}")
    want = _exported(REPO / "neural_speech_decoding_tpu" / sub / "__init__.py")
    assert want and want <= set(dir(port))


def test_slice_8_modules_import():
    import importlib

    for name in ("parallel.mesh", "parallel.sharding", "parallel.collective", "tools.sweep"):
        importlib.import_module(f"neural_speech_decoding_tpu_torch.{name}")
    from neural_speech_decoding_tpu_torch.ops.kuramoto import mai_filter_batch_sharded

    assert callable(mai_filter_batch_sharded)


def test_slice_9_modules_import():
    """The reference surface, the evaluation and fidelity tools, the
    quickstart and entry.py import without JAX on the path."""
    import importlib

    for name in ("utilities", "utilities.tester", "utilities.lstm_eeg_model", "utilities.preprocessor",
                 "utilities.neurokit_connector", "utilities.knight_board_init", "utilities.streaming_process",
                 "tools.eval_models", "tools.fidelity_report", "quickstart", "entry"):
        mod = importlib.import_module(f"neural_speech_decoding_tpu_torch.{name}")
        assert (PORT / (name.replace(".", "/") + ("/__init__.py" if name == "utilities" else ".py"))).is_file()
        assert mod.__name__.endswith(name)
    from neural_speech_decoding_tpu_torch.entry import dryrun_multichip, entry

    assert callable(entry) and callable(dryrun_multichip)


@pytest.mark.parametrize("name", sorted(p.stem for p in (REPO / "Utilities").glob("*.py") if p.stem != "__init__"))
def test_utilities_offers_every_shim_module(name):
    """Each module of Utilities/ has its counterpart in the port's
    utilities/, with every name the shim's module imports or defines."""
    import importlib

    port = importlib.import_module(f"neural_speech_decoding_tpu_torch.utilities.{name}")
    tree = ast.parse((REPO / "Utilities" / f"{name}.py").read_text())
    offered = set()
    for node in tree.body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef)):
            offered.add(node.name)
        elif isinstance(node, ast.ImportFrom) and node.module != "__future__":
            offered.update(alias.asname or alias.name for alias in node.names)
    assert offered and offered <= set(dir(port))
