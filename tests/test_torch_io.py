"""The port's file IO against emx's on the CPU: TIFF (the port's own
numpy codec against emx's PIL one), DM3/DM4 and manifests. Files are
exchanged both ways and compared bit for bit."""

import builtins
import json
import os

import numpy as np
import pytest
from PIL import Image

from emx.io import dm as emx_dm
from emx.io import manifest as emx_manifest
from emx.io.tiff import read_tiff as emx_read_tiff
from emx.io.tiff import write_tiff as emx_write_tiff
from emx_torch.io import dm, dm_native, manifest
from emx_torch.io.tiff import (TiffError, decode_tiff, read_npy_stack,
                               read_tiff, write_npy_stack, write_tiff)

RNG = np.random.default_rng(0)
IMG = RNG.random((70, 53)).astype(np.float32)
# What the port writes, as values each dtype holds.
WRITTEN = {"float32": IMG * 7 - 2, "uint8": np.round(IMG * 255),
           "uint16": np.round(IMG * 65535), "int16": np.round(IMG * 6e4 - 3e4),
           "int32": np.round(IMG * 4e6 - 2e6)}


def test_port_reads_what_emx_writes(tmp_path):
    """emx writes float32 through PIL mode 'F'; the port reads it back
    bit for bit, as emx does."""
    path = str(tmp_path / "emx.tif")
    emx_write_tiff(path, IMG * 3 - 1)
    got = read_tiff(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, emx_read_tiff(path))
    np.testing.assert_array_equal(got, IMG * 3 - 1)


@pytest.mark.parametrize("byteorder", ["<", ">"])
@pytest.mark.parametrize("dtype", sorted(WRITTEN))
def test_emx_reads_what_the_port_writes(tmp_path, dtype, byteorder):
    """Each dtype the port writes, in either byte order: emx's reader
    (PIL) and the port's give the values back bit for bit."""
    values = WRITTEN[dtype].astype(dtype)
    path = str(tmp_path / "port.tif")
    write_tiff(path, values, dtype=dtype, byteorder=byteorder)
    with open(path, "rb") as f:
        assert f.read(2) == (b"II" if byteorder == "<" else b"MM")
    want = values.astype(np.float32)
    np.testing.assert_array_equal(emx_read_tiff(path), want)
    np.testing.assert_array_equal(read_tiff(path), want)


@pytest.mark.parametrize("mode", ["L", "I;16", "I;16B", "I", "F"])
def test_port_reads_pil_modes(tmp_path, mode):
    """Files PIL writes in its integer and float modes (both byte orders
    of 16-bit): the port reads what emx reads."""
    dtype = {"L": np.uint8, "I;16": np.uint16, "I;16B": ">u2",
             "I": np.int32, "F": np.float32}[mode]
    arr = (IMG * (200 if mode == "L" else 60000)).astype(dtype)
    path = str(tmp_path / "pil.tif")
    Image.fromarray(arr, mode=mode).save(path)
    np.testing.assert_array_equal(read_tiff(path), emx_read_tiff(path))
    np.testing.assert_array_equal(read_tiff(path), arr.astype(np.float32))


def test_truncated_tiff_gives_the_fallback(tmp_path):
    path = str(tmp_path / "cut.tif")
    emx_write_tiff(path, IMG)
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(TiffError, match="truncated"):
        read_tiff(path)
    out = read_tiff(path, fallback_shape=(8, 9))
    np.testing.assert_array_equal(out, np.full((8, 9), 0.5, np.float32))
    np.testing.assert_array_equal(
        out, emx_read_tiff(path, fallback_shape=(8, 9)))


def test_other_formats_go_through_pil(tmp_path, monkeypatch):
    """A PNG and an RGB TIFF read as emx reads them (RGB averaged to
    grey); without PIL the PNG raises, naming its format."""
    png = str(tmp_path / "x.png")
    rgb = str(tmp_path / "rgb.tif")
    Image.fromarray((IMG * 255).astype(np.uint8)).save(png)
    Image.fromarray((IMG * 255).astype(np.uint8)).convert("RGB").save(rgb)
    for p in (png, rgb):
        np.testing.assert_array_equal(read_tiff(p), emx_read_tiff(p))
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(TiffError, match="PNG needs PIL"):
        read_tiff(png)
    np.testing.assert_array_equal(read_tiff(rgb),    # baseline: no PIL
                                  emx_read_tiff(rgb))


def test_decoder_refuses_what_it_does_not_read():
    with pytest.raises(TiffError):
        decode_tiff(b"\x89PNG\r\n\x1a\n" + bytes(16))
    with pytest.raises(ValueError, match="writes"):
        write_tiff("/nonexistent/x.tif", IMG, dtype=np.float64)


def test_npy_stacks_match_emx(tmp_path):
    imgs = [IMG, IMG * 2]
    write_npy_stack(str(tmp_path / "p.npy"), imgs)
    from emx.io.tiff import write_npy_stack as emx_stack

    emx_stack(str(tmp_path / "e.npy"), imgs)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"),
                                  np.load(tmp_path / "e.npy"))
    assert read_npy_stack(str(tmp_path / "p.npy")).shape == (2, 70, 53, 1)


DM_CASES = [(3, True, np.float32), (4, True, np.float32),
            (3, False, np.uint16), (4, False, np.int16)]


@pytest.mark.parametrize("version,little,dtype", DM_CASES)
def test_dm_files_cross_read(tmp_path, version, little, dtype):
    """DM3/DM4, little- and big-endian data: the port decodes what emx
    wrote, and emx what the port wrote, to the same image and tags
    (the port's Python parser; the native decoder where it is built)."""
    arr = (IMG * 1000).astype(dtype)
    pe, pp = str(tmp_path / f"e.dm{version}"), str(tmp_path / f"p.dm{version}")
    emx_dm.write_dm(pe, arr, data_le=little, scale=0.5, units="A")
    dm.write_dm(pp, arr, data_le=little, scale=0.5, units="A")
    assert open(pe, "rb").read() == open(pp, "rb").read()
    for path in (pe, pp):
        ours = dm.read_dm(path, prefer_native=False).image()
        theirs = emx_dm.read_dm(path, prefer_native=False).image()
        np.testing.assert_array_equal(ours.data, theirs.data)
        np.testing.assert_array_equal(ours.data, arr)
        assert (ours.scale, ours.units, ours.is_imaging_mode) == (
            theirs.scale, theirs.units, theirs.is_imaging_mode)
        if dm_native.available():
            np.testing.assert_array_equal(dm.read_dm(path).image().data, arr)


def test_dm_truncated_and_spectrum(tmp_path):
    path = str(tmp_path / "s.dm3")
    dm.write_dm(path, IMG, operation_mode="SPECTROSCOPY")
    assert not dm.read_dm(path, prefer_native=False).image().is_imaging_mode
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 3])
    for read in (dm.read_dm, emx_dm.read_dm):
        with pytest.raises((dm.DMDecodeError, emx_dm.DMDecodeError,
                            OSError, KeyError)):
            read(path, prefer_native=False).image()


def test_manifest_matches_emx(tmp_path):
    for i in range(7):
        (tmp_path / f"{i}.tif").write_bytes(b"")
    pattern = str(tmp_path / "*.tif")
    ours = manifest.build_manifest(pattern, seed=3)
    theirs = emx_manifest.build_manifest(pattern, seed=3)
    assert ours.records == theirs.records
    assert [len(m) for m in manifest.split_manifest(ours)] == [
        len(m) for m in emx_manifest.split_manifest(theirs)]
    ours.save(str(tmp_path / "m.jsonl"))
    theirs.save(str(tmp_path / "e.jsonl"))
    assert open(tmp_path / "m.jsonl").read() == open(tmp_path / "e.jsonl").read()
    assert manifest.Manifest.load(str(tmp_path / "m.jsonl")).records == \
        ours.records
    assert [json.loads(x)["path"] for x in open(tmp_path / "m.jsonl")] == \
        sorted(os.path.join(tmp_path, f"{i}.tif") for i in range(7))
