"""The port stands alone: importing every module of it (and the GPU smoke
script, and the port's example scripts) loads neither JAX nor the JAX
package, and no source file of it imports them."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pointcloud_style_transfer_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = Path(pointcloud_style_transfer_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "pointcloud_style_transfer_tpu")
# the port's example scripts (and the module they share)
EXAMPLES = tuple(sorted(p.stem for p in (ROOT / "examples").glob("*_torch.py")))


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="pointcloud_style_transfer_torch."))


def test_import_loads_no_jax():
    mods = port_modules()
    assert len(EXAMPLES) >= 13 and "profile_sampler_step_torch" in EXAMPLES
    for name in ("cli.inference", "ops.interpolate", "ops.pruned_knn",
                 "ops.kernels.knn_packed", "ops.kernels.knn_pruned"):
        assert f"pointcloud_style_transfer_torch.{name}" in mods
    code = (
        "import importlib, sys\n"
        "sys.path.insert(0, 'examples')\n"
        f"for m in {mods!r} + ['chip_smoke'] + {list(EXAMPLES)!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")\b", re.M)
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "examples" / f"{name}.py" for name in EXAMPLES]
    assert len(files) > 15
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders
