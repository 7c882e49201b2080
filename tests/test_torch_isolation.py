"""The port stands alone: emx_torch, chip_smoke.py and the card-only
tests import neither JAX, flax, ml_dtypes, msgpack nor the emx package,
at module level or in a function body (the machine with the card has
none of them)."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "ml_dtypes", "msgpack", "emx")
PORT_FILES = sorted((ROOT / "emx_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py",
    ROOT / "scripts" / "port_scope_drive.py",
    ROOT / "scripts" / "port_dqn_spread.py"]


def _imported_names(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            yield node.args[0].value


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_forbidden_import(path):
    names = list(_imported_names(ast.parse(path.read_text(), str(path))))
    bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_with_jax_blocked():
    """Every emx_torch module and chip_smoke import in a process where
    jax, flax and ml_dtypes cannot be imported, and none reaches emx."""
    code = """
import importlib, pkgutil, sys
for m in ("jax", "flax", "ml_dtypes", "msgpack"):
    sys.modules[m] = None
import emx_torch
names = [m.name for m in pkgutil.walk_packages(emx_torch.__path__,
                                               "emx_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = [m for m in sys.modules if m == "emx" or m.startswith("emx.")
       or (m.split(".")[0] in ("jax", "flax", "ml_dtypes", "msgpack")
           and sys.modules[m] is not None)]
assert not bad, bad
print(len(names))
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 60


@pytest.mark.parametrize("name", [
    "cli.py", "bench/qat_finetune.py", "bench/quality_run.py",
    "bench/quant_check.py", "bench/head_sweep.py", "bench/qat_profile.py",
    "io/tiff.py", "io/dm.py", "io/dm_native.py", "io/manifest.py",
    "data/crops.py", "data/harvest.py", "physics/stats.py",
    "train/dose_probe.py", "bench/pipeline_bench.py",
    "bench/train_bench.py", "data/degrade.py", "nn/infilling.py",
    "train/gan.py", "train/checkpoints.py", "analysis/inpaint.py",
    "bench/gan_quality.py", "bench/gan_demo.py", "physics/ctf.py",
    "physics/propagate.py", "recon/__init__.py", "recon/ewrec.py",
    "recon/align.py", "recon/fit.py", "bench/ewrec_bench.py",
    "bench/ewrec_diagnosis.py", "serve/artifact.py", "serve/tf_import.py",
    "analysis/stats.py", "analysis/pearson.py", "analysis/optim_demo.py",
    "nn/autoencoder.py", "nn/latent.py", "nn/kernels.py", "nn/fractal.py",
    "nn/profiles.py", "nn/vaegan.py", "nn/manifold.py", "nn/style.py",
    "bench/zoo_ladder.py", "bench/style_artifact.py", "scope/__init__.py",
    "scope/protocol.py", "scope/sim.py", "scope/env.py", "scope/dqn.py",
    "scope/vec_env.py", "scope/classifier.py", "scope/demo.py",
    "bench/dqn_run.py", "bench/dqn_vec.py", "bench/sweep.py", "data/cif.py",
    "data/misc_files.py"])
def test_recipe_modules_are_checked(name):
    """The recipe's, the file path's, the GAN's, EWREC's, the model zoo's
    and the scope's modules, the tools and the CLI are among the files
    checked."""
    assert ROOT / "emx_torch" / name in PORT_FILES
