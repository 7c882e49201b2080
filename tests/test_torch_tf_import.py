"""The port's TF1 importer (emx_torch/serve/tf_import.py) against emx's
(emx/serve/tf_import.py) on synthetic TF-named dicts: the mapping
records are equal; emx's export of a randomised tf_compat Denoiser
imported by the port gives emx's variables exactly (float32 numpy on
both sides) and a port Denoiser whose output is emx's (within 2e-5, as
emx's own round trip); the port's export of that model imported by emx
gives the same function back (within 2e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from emx.nn import Denoiser as FlaxDenoiser
from emx.serve import tf_import as emx_tf
from emx_torch.serve import tf_import as port_tf
from emx_torch.serve.convert import to_flax_params
from emx_torch.serve.export import nest
from torch_zoo_helpers import ref_jit

KW = dict(features=(8, 8, 8, 8, 8), num_middle_blocks=1, aspp_out=8)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def emx_model():
    """emx's tf_compat Denoiser's variable tree (from jax.eval_shape of
    its init) with every leaf drawn at random, except the separable
    convs' biases (the TF graph has none), as tests/test_tf_import.py
    randomises it; its output on a 64x64 image."""
    cfg = emx_tf.tf_compat_config(**KW)
    model = FlaxDenoiser(cfg)
    x = np.random.default_rng(1).random((1, 64, 64)).astype(np.float32)
    variables = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.asarray(x), train=False))
    flat, treedef = jax.tree_util.tree_flatten_with_path(variables)
    rng = np.random.default_rng(5)
    leaves = []
    for path, leaf in flat:
        keys = [getattr(p, "key", "") for p in path]
        if "bias" in keys and any(k.startswith("SepConvBlock")
                                  for k in keys):
            leaves.append(jnp.zeros(leaf.shape, leaf.dtype))
        elif keys[-1] == "var":
            leaves.append(jnp.asarray(rng.uniform(0.5, 2.0, leaf.shape),
                                      leaf.dtype))
        else:
            leaves.append(jnp.asarray(rng.normal(0, 0.5, leaf.shape),
                                      leaf.dtype))
    variables = jax.tree_util.tree_unflatten(treedef, leaves)
    out = np.asarray(ref_jit(lambda v, x: model.apply(v, x, train=False))(
        variables, jnp.asarray(x)))
    return {"cfg": cfg, "model": model, "variables": variables, "x": x,
            "out": out}


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


def test_mapping_matches_emx():
    port = port_tf.denoiser_tf1_mapping(port_tf.tf_compat_config(**KW))
    ref = emx_tf.denoiser_tf1_mapping(emx_tf.tf_compat_config(**KW))
    assert port == ref
    full = port_tf.denoiser_tf1_mapping()
    assert full == emx_tf.denoiser_tf1_mapping()
    cfg = port_tf.tf_compat_config()
    assert (cfg.space_to_depth, cfg.aspp_separable, cfg.upsample,
            cfg.norm) == (1, False, "transpose", "batch")


def test_import_of_emx_export_matches_emx(emx_model):
    """emx's TF1 dict -> the port's import: emx's variables leaf for
    leaf, and a port Denoiser computing emx's output."""
    tf_vars = emx_tf.export_tf1_vars(emx_model["variables"],
                                     emx_model["cfg"])
    ref = emx_tf.import_tf1_checkpoint(tf_vars, emx_model["cfg"])
    got = port_tf.import_tf1_checkpoint(tf_vars,
                                        port_tf.tf_compat_config(**KW))
    for coll in ("params", "batch_stats"):
        a, b = _flat(ref[coll]), _flat(got[coll])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    model = port_tf.load_tf1_denoiser(tf_vars, port_tf.tf_compat_config(
        **KW), device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(emx_model["x"]), train=False).numpy()
    np.testing.assert_allclose(out, emx_model["out"], atol=2e-5)


def test_port_export_imported_by_emx(emx_model):
    """The port's export of the imported model, read back by emx's
    import: the same function."""
    tf_vars = emx_tf.export_tf1_vars(emx_model["variables"],
                                     emx_model["cfg"])
    model = port_tf.load_tf1_denoiser(tf_vars, port_tf.tf_compat_config(
        **KW), device="cpu")
    params, stats = to_flax_params(model)
    back = port_tf.export_tf1_vars({"params": nest(params),
                                    "batch_stats": nest(stats)},
                                   port_tf.tf_compat_config(**KW))
    assert set(back) == set(tf_vars)
    reimported = emx_tf.import_tf1_checkpoint(back, emx_model["cfg"])
    out = np.asarray(ref_jit(lambda v, x: emx_model["model"].apply(
        v, x, train=False))(reimported, jnp.asarray(emx_model["x"])))
    np.testing.assert_allclose(out, emx_model["out"], atol=2e-5)
