"""The port's import closure: torch only, never jax, never ``repro``,
never ``ml_dtypes`` (the card's machine has none)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "benchmarks" / "torch_profile.py",
    ROOT / "benchmarks" / "train_readings.py",
    ROOT / "benchmarks" / "tp_readings.py",
    ROOT / "benchmarks" / "analysis_bounds.py"]


def test_import_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.kernels.paged_attention, "
            "repro_torch.apps.jacobi2d, repro_torch.apps.lulesh_proxy, "
            "repro_torch.core.overdecomp, repro_torch.core.spmd_stencil, "
            "repro_torch.runtime, repro_torch.kernels.jacobi, "
            "repro_torch.kernels.flash_attention, "
            "repro_torch.serving.workunit, repro_torch.serving.simengine, "
            "repro_torch.serving.workload, repro_torch.serving.shapes, "
            "repro_torch.core.checkpointing, repro_torch.cluster, "
            "repro_torch.optim.adamw, repro_torch.data.pipeline, "
            "repro_torch.core.elastic, repro_torch.launch.train, "
            "repro_torch.launch.dist, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding, repro_torch.launch.specs, "
            "repro_torch.launch.hlo_analysis, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.') or m == 'ml_dtypes')\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, sorted(roots)
