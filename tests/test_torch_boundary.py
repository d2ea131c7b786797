"""The port's import boundary and device rules: ``sitewhere_tpu_torch`` and
``chip_smoke.py`` import neither ``jax``, ``ml_dtypes`` nor anything of
``sitewhere_tpu``, and nothing silently drops to the CPU when no card is
present."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sitewhere_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "sitewhere_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_importing_the_port_loads_no_jax():
    """Every module of the package (and chip_smoke.py) imported in a fresh
    interpreter: conftest has already imported JAX in this one."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import sitewhere_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib', 'ml_dtypes', "
        "'sitewhere_tpu') or m.startswith(('jax.', 'jaxlib.', 'ml_dtypes.', 'sitewhere_tpu.')))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 10 else 0)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


def test_no_forbidden_import_in_the_source():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_no_card_no_silent_cpu():
    """Entry points default to the card; without one they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the rule under test needs none")
    from sitewhere_tpu_torch.models import get_model, make_config
    from sitewhere_tpu_torch.ops.windows import init_window_state
    from sitewhere_tpu_torch.parallel.mesh import MeshManager
    from sitewhere_tpu_torch.parallel.sharded import ShardedScorer

    with pytest.raises(RuntimeError, match="device='cpu'"):
        MeshManager()
    with pytest.raises((RuntimeError, AssertionError)):
        init_window_state(8, 4)
    spec = get_model("lstm_ad")
    with pytest.raises((RuntimeError, AssertionError)):
        spec.init(torch.Generator().manual_seed(0), make_config("lstm_ad", {}))
    scorer = ShardedScorer(
        MeshManager(device="cpu"), spec, make_config("lstm_ad", {}),
        slots_per_shard=2, max_streams=16, window=8,
    )
    assert scorer.device.type == "cpu" and scorer.plain


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The kernels build only where the CUDA toolkit is; elsewhere the
    build raises rather than leaving a wrapper without its kernel."""
    from sitewhere_tpu_torch import kernels

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()
    assert kernels.launches() == {name: 0 for name in kernels.KERNELS}
