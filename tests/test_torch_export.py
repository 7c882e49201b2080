"""Directory artifacts (emx_torch/serve/export.py) against emx's
(emx/serve/export.py): the port's msgpack codec against flax's
serialization, artifacts written by one package and read by the other,
bit-exact both ways (a bfloat16 leaf included), the denoiser factory's
forward against emx's on the same artifact, and the torch.export
round trip."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from emx.nn import Denoiser as FlaxDenoiser
from emx.nn import DenoiserConfig as FlaxConfig
from emx.serve import export as emx_export
from emx_torch.nn import Denoiser, DenoiserConfig
from emx_torch.serve import export, msgpack_codec


def _tree():
    """Nested variables with float32, int32 and bfloat16 leaves."""
    rng = np.random.default_rng(0)
    return {"params": {
        "Conv_0": {"kernel": rng.standard_normal((3, 3, 1, 4), np.float32),
                   "bias": np.zeros((4,), np.float32)},
        "Dense_0": {"kernel": jnp.asarray(rng.standard_normal((4, 2)),
                                          jnp.bfloat16)},
        "step": np.arange(3, dtype=np.int32)}}


def _port_leaf(v):
    """The same leaf as the port holds it: bfloat16 as a torch tensor."""
    if getattr(v, "dtype", None) == jnp.bfloat16:
        return torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
    return np.asarray(v)


def _map(tree, fn):
    return ({k: _map(v, fn) for k, v in tree.items()}
            if isinstance(tree, dict) else fn(tree))


def _equal_bits(a, b):
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy()
        b = np.asarray(b).view(np.int16)
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_codec_bytes_equal_flax():
    """packb of the port's leaves gives flax's bytes (keys sorted as jax
    sorts them), and unpackb reads flax's bytes back."""
    tree = _tree()
    ref = serialization.msgpack_serialize(tree)
    assert msgpack_codec.packb(export._sorted_tree(_map(tree, _port_leaf))
                               ) == ref
    back = msgpack_codec.unpackb(ref)
    assert back["params"]["Dense_0"]["kernel"].dtype == torch.bfloat16
    _equal_bits(back["params"]["Dense_0"]["kernel"],
                tree["params"]["Dense_0"]["kernel"])
    _equal_bits(back["params"]["step"], tree["params"]["step"])


@pytest.mark.parametrize("value", [
    0, 127, 128, -1, -32, -33, -129, 70000, -70000, 2 ** 40, -2 ** 40,
    1.25, "", "x" * 31, "x" * 32, "é" * 300, b"\x00" * 300, None, True,
    [1] * 20, {f"k{i:02d}": i for i in range(20)}, np.float32(2.5),
    np.zeros((0, 3), np.float32)],
    ids=lambda v: type(v).__name__)
def test_codec_scalars_and_containers(value):
    ref = serialization.msgpack_serialize({"v": value})
    assert msgpack_codec.packb({"v": value}) == ref
    back = msgpack_codec.unpackb(ref)["v"]
    np.testing.assert_array_equal(np.asarray(back), np.asarray(value))


def test_codec_rejects_trailing_bytes():
    with pytest.raises(ValueError, match="extra bytes"):
        msgpack_codec.unpackb(msgpack_codec.packb(1) + b"\x00")


def test_emx_artifact_loads_in_port(tmp_path):
    tree = _tree()
    emx_export.save_artifact(str(tmp_path), "tiny", {"a": [1, 2]}, tree)
    art = export.load_artifact(str(tmp_path))
    assert art.model_name == "tiny" and art.config == {"a": [1, 2]}
    _map_pairs(art.variables, tree)


def _map_pairs(got, ref):
    assert isinstance(got, dict) == isinstance(ref, dict)
    if isinstance(ref, dict):
        assert list(got) == sorted(ref)
        for k in ref:
            _map_pairs(got[k], ref[k])
    else:
        _equal_bits(got, ref)


def test_port_artifact_loads_in_emx(tmp_path):
    """The port's files load in emx with every leaf bit-exact, and its
    params.msgpack is byte for byte the file emx writes."""
    tree = _tree()
    export.save_artifact(str(tmp_path / "port"), "tiny", {"a": (1, 2)},
                         _map(tree, _port_leaf))
    emx_export.save_artifact(str(tmp_path / "emx"), "tiny", {"a": (1, 2)},
                             tree)
    art = emx_export.load_artifact(str(tmp_path / "port"))
    assert art.model_name == "tiny" and art.config == {"a": [1, 2]}
    for k in ("Conv_0", "Dense_0"):
        for leaf, v in tree["params"][k].items():
            got = art.variables["params"][k][leaf]
            assert got.dtype == np.asarray(v).dtype
            np.testing.assert_array_equal(np.asarray(got, np.float32),
                                          np.asarray(v, np.float32))
    assert ((tmp_path / "port" / "params.msgpack").read_bytes()
            == (tmp_path / "emx" / "params.msgpack").read_bytes())
    meta = json.loads((tmp_path / "port" / "artifact.json").read_text())
    assert meta["format"] == "emx-artifact-v1"


@pytest.fixture(scope="module")
def denoiser_artifact(tmp_path_factory):
    cfg = dataclasses.replace(FlaxConfig.tiny(), norm="none",
                              space_to_depth=2, folded_head=16)
    model = FlaxDenoiser(cfg)
    x = np.random.default_rng(1).random((2, 64, 64)).astype(np.float32)
    variables = model.init(jax.random.key(0), jnp.asarray(x), train=False)
    path = str(tmp_path_factory.mktemp("art"))
    emx_export.save_artifact(path, "denoiser", dataclasses.asdict(cfg),
                             variables)
    ref = np.asarray(emx_export.load_artifact(path).apply_fn()(x))
    return path, x, ref


def test_denoiser_factory_matches_emx(denoiser_artifact):
    """An emx directory artifact served by the port: float32 forward
    within 1e-5 of emx's."""
    path, x, ref = denoiser_artifact
    art = export.load_artifact(path)
    got = art.apply_fn("cpu")(x).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_port_denoiser_artifact_runs_in_emx(tmp_path, denoiser_artifact):
    """The port saves a Denoiser's config and parameters; emx builds and
    runs it, within 1e-5 of the port's forward."""
    path, x, _ = denoiser_artifact
    art = export.load_artifact(path)
    model = art.module("cpu")
    conf = {f.name: getattr(model.config, f.name)
            for f in dataclasses.fields(model.config)}
    export.save_artifact(str(tmp_path), "denoiser", conf, art.variables)
    ref = np.asarray(emx_export.load_artifact(str(tmp_path)).apply_fn()(x))
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_export_compiled_round_trip(tmp_path):
    """torch.export of a tiny bf16 Denoiser, saved and loaded, against
    eager: the same program, within one bf16 step."""
    cfg = dataclasses.replace(DenoiserConfig.tiny(), norm="none",
                              space_to_depth=4, folded_head=16,
                              dtype=torch.bfloat16)
    model = Denoiser(cfg, device="cpu").eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    x = torch.rand((1, 64, 64), generator=gen)
    export.export_compiled(str(tmp_path), model, (x,))
    loaded = export.load_compiled(str(tmp_path))
    with torch.inference_mode():
        ref, got = model(x), loaded(x)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 2.0 ** -8
