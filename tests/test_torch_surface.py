"""The port's public surface against emx's: each ported package's
`__init__` exports every name of emx's `__all__` (the port may add
names of its own), and the keywords emx's callers pass exist."""

import importlib
import inspect

import numpy as np
import pytest

PACKAGES = ("analysis", "data", "io", "nn", "ops", "parallel", "physics",
            "recon", "scope", "serve", "train", "utils")


@pytest.mark.parametrize("package", PACKAGES)
def test_all_covers_emx(package):
    emx = importlib.import_module(f"emx.{package}")
    port = importlib.import_module(f"emx_torch.{package}")
    missing = sorted(set(emx.__all__) - set(port.__all__))
    assert not missing, f"emx_torch.{package} lacks {missing}"
    for name in port.__all__:
        assert hasattr(port, name), f"emx_torch.{package}.{name}"


def test_ops_import_builds_nothing():
    """Importing emx_torch.ops (and its fused_poisson_degrade) in a fresh
    process compiles and loads no kernel."""
    import subprocess
    import sys

    code = ("from emx_torch.ops import _build, fused_poisson_degrade\n"
            "assert callable(fused_poisson_degrade)\n"
            "print(len(_build._built))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "0"


@pytest.mark.parametrize("name, module", [
    ("iter_shards", "utils.config"), ("read_loss_log", "utils.metrics")])
def test_helpers_match_emx(tmp_path, name, module):
    emx = getattr(importlib.import_module(f"emx.{module}"), name)
    port = getattr(importlib.import_module(f"emx_torch.{module}"), name)
    if name == "iter_shards":
        items = list(range(11))
        for k in range(3):
            assert list(port(items, k, 3)) == list(emx(items, k, 3))
        return
    log = tmp_path / "log.txt"
    log.write_text("step 1 loss: 0.5\nnoise\nstep 2 loss: 1e-3 lr: 2\n"
                   "loss: -inf\nloss: .\n")
    for key in ("loss", "lr"):
        assert port(str(log), key) == emx(str(log), key)


def test_keywords_match_emx(tmp_path):
    """load_artifact(template_variables=) restores the template's
    structure as flax's from_bytes does (a key it lacks raises);
    InferenceServer stores input_shape."""
    from emx.serve.export import load_artifact as emx_load
    from emx.serve.server import InferenceServer as EmxServer
    from emx_torch.serve import load_artifact, save_artifact
    from emx_torch.serve.server import InferenceServer

    for cls in (EmxServer, InferenceServer):
        assert "input_shape" in inspect.signature(cls).parameters
    variables = {"params": {"a": {"kernel": np.ones((2, 3), np.float32)},
                            "b": np.zeros(4, np.float32)}}
    save_artifact(str(tmp_path), "denoiser", {"x": 1}, variables)
    template = {"params": {"a": {"kernel": np.zeros((2, 3), np.float32)}}}
    port = load_artifact(str(tmp_path), template_variables=template)
    ref = emx_load(str(tmp_path), template_variables=template)
    assert set(port.variables["params"]) == set(ref.variables["params"])
    np.testing.assert_array_equal(port.variables["params"]["a"]["kernel"],
                                  ref.variables["params"]["a"]["kernel"])
    with pytest.raises(ValueError, match="not present"):
        load_artifact(str(tmp_path),
                      template_variables={"params": {"c": np.zeros(1)}})


@pytest.mark.parametrize("name, keywords", [
    ("train.Trainer", ("mesh", "example_fn")),
    ("train.gan.GANTrainer", ("mesh", "example_fn")),
    ("parallel.batch_sharding", ("spatial_dims",)),
    ("parallel.make_mesh", ("data", "spatial", "devices")),
    ("parallel.mesh.make_mesh_for_batch", ("spatial", "devices")),
    ("parallel.halo.spatial_apply", ("halo", "axis_name", "grid")),
    ("parallel.halo.halo_denoise", ("halo", "axis_name")),
    ("parallel.distributed.initialize", ("coordinator_address",
                                         "num_processes", "process_id")),
    ("parallel.distributed.make_pod_mesh", ("dcn_data", "spatial")),
    ("nn.blocks.Norm", ("axis_name",)),
    ("nn.DenoiserConfig", ("axis_name",)),
])
def test_mesh_keywords_match_emx(name, keywords):
    """The keywords emx's callers pass to the mesh surface exist on both
    sides: mesh=, spatial_dims=, grid=, halo=, axis_name=."""
    module, attr = name.rsplit(".", 1)
    for pkg in ("emx", "emx_torch"):
        obj = getattr(importlib.import_module(f"{pkg}.{module}"), attr)
        params = (set(inspect.signature(obj).parameters)
                  if not hasattr(obj, "__dataclass_fields__")
                  else set(obj.__dataclass_fields__))
        missing = set(keywords) - params
        assert not missing, f"{pkg}.{name} lacks {sorted(missing)}"
