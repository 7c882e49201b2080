"""The port's training-from-files data path against emx's on the CPU:
crops, the statistics suite, the DM harvest (census, reap, crop
datasets, packs, CSV) and DataPipeline's batches."""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.data import crops as emx_crops
from emx.data import harvest as emx_harvest
from emx.data.pipeline import DataPipeline as EmxPipeline
from emx.data.pipeline import PipelineConfig as EmxPipelineConfig
from emx.io.dm import write_dm as emx_write_dm
from emx.io.tiff import write_tiff as emx_write_tiff
from emx.physics import stats as emx_stats
from emx_torch.data import crops, harvest
from emx_torch.data.pipeline import (DataPipeline, PipelineConfig,
                                     synthetic_micrographs)
from emx_torch.io.manifest import Manifest
from emx_torch.io.tiff import read_tiff
from emx_torch.physics import stats

CPU = "cpu"
RNG = np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# -- crops ---------------------------------------------------------------

@pytest.mark.parametrize("s,size", [(512, 256), (600, 200), (512, 128),
                                    (384, 48), (64, 64)])
def test_box_resize_integer_ratio_is_exact(s, size):
    x = (RNG.random((2, s, s)) * 1000).astype(np.float32)
    want = np.asarray(emx_crops.box_resize(jnp.asarray(x), size))
    got = crops.box_resize(torch.from_numpy(x), size).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s,size", [(300, 204), (150, 204), (640, 512),
                                    (96, 40)])
def test_box_resize_other_ratios(s, size):
    """jax.image.resize(linear, antialias) against F.interpolate
    (bilinear, antialias) within 1e-5 of the image's range."""
    x = RNG.random((s, s)).astype(np.float32)
    want = np.asarray(emx_crops.box_resize(jnp.asarray(x), size))
    got = crops.box_resize(torch.from_numpy(x), size).numpy()
    assert got.shape == want.shape == (size, size)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape", [(700, 520), (520, 700), (512, 512)])
def test_harvest_preprocess_and_square_crop(shape):
    x = (RNG.random(shape) * 50).astype(np.float32)
    np.testing.assert_array_equal(
        crops.center_square_crop(torch.from_numpy(x)).numpy(),
        np.asarray(emx_crops.center_square_crop(jnp.asarray(x))))
    np.testing.assert_allclose(
        crops.harvest_preprocess(torch.from_numpy(x), 256).numpy(),
        np.asarray(emx_crops.harvest_preprocess(jnp.asarray(x), 256)),
        atol=5e-5, rtol=0)


def test_tiles_and_random_crop():
    x = RNG.random((3, 130, 100)).astype(np.float32)
    t = crops.tile_grid(torch.from_numpy(x), 32)
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(emx_crops.tile_grid(jnp.asarray(x), 32)))
    back = crops.untile_grid(t, 4, 3)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(emx_crops.untile_grid(
            jnp.asarray(t.numpy()), 4, 3)))
    np.testing.assert_array_equal(back.numpy(), x[:, :128, :96])
    a = crops.random_crop(torch.Generator().manual_seed(1),
                          torch.from_numpy(x), 40)
    b = crops.random_crop(torch.Generator().manual_seed(1),
                          torch.from_numpy(x), 40)
    assert a.shape == (3, 40, 40) and torch.equal(a, b)
    assert any(torch.equal(a[0], torch.from_numpy(x[0, i:i + 40, j:j + 40]))
               for i in range(91) for j in range(61))


# -- statistics ----------------------------------------------------------

def test_image_stats_match_emx():
    """Each of the 40 statistics of each image of a batch against emx's
    jitted image_stats on that image: rtol 1e-3, atol 1e-4 (float32 sums
    in other orders; skewness of a near-symmetric image is a small
    difference of large terms)."""
    x = (RNG.random((3, 96, 96)) ** 2 * 500).astype(np.float32)
    got = stats.image_stats(torch.from_numpy(x))
    assert tuple(got) == stats.STAT_NAMES == emx_stats.STAT_NAMES
    fn = jax.jit(emx_stats.image_stats)
    for i in range(3):
        want = fn(jnp.asarray(x[i]))
        for k in stats.STAT_NAMES:
            np.testing.assert_allclose(float(got[k][i]), float(want[k]),
                                       rtol=1e-3, atol=1e-4, err_msg=k)


def test_noise_and_profile_match_emx():
    x = RNG.random((2, 64, 64)).astype(np.float32)
    np.testing.assert_allclose(
        stats.estimate_noise(torch.from_numpy(x)).numpy(),
        np.asarray(emx_stats.estimate_noise(jnp.asarray(x))), rtol=1e-5)
    prof, freqs = stats.radial_fft_profile(torch.from_numpy(x[0]))
    eprof, efreqs = emx_stats.radial_fft_profile(jnp.asarray(x[0]))
    np.testing.assert_allclose(prof.numpy(), np.asarray(eprof), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(freqs.numpy(), np.asarray(efreqs), rtol=1e-6)
    raw = stats.image_stats(torch.from_numpy(x[0]), raw=torch.from_numpy(
        x[0, :50, :40]))
    assert float(raw["width"]) == 40 and float(raw["num_px"]) == 2000


# -- the harvest ---------------------------------------------------------

@pytest.fixture(scope="module")
def dm_corpus(tmp_path_factory):
    """Six imaging micrographs of 512x512 (DM3 and DM4), one of 600x560
    (the non-integer resize), and three to reject: under min_side, a
    spectrum, a truncated file."""
    d = tmp_path_factory.mktemp("dm")
    imgs = synthetic_micrographs(6, 512, seed=3) * 900 + 50
    for i, im in enumerate(imgs):
        emx_write_dm(str(d / f"m{i}.dm{3 + i % 2}"), im.astype(np.float32))
    emx_write_dm(str(d / "odd.dm3"), (RNG.random((600, 560)) * 80 + 10)
                 .astype(np.float32))
    emx_write_dm(str(d / "small.dm3"), np.ones((64, 64), np.float32))
    emx_write_dm(str(d / "spec.dm4"), imgs[0].astype(np.float32),
                 operation_mode="SPECTROSCOPY")
    raw = (d / "m0.dm3").read_bytes()
    (d / "trunc.dm3").write_bytes(raw[:len(raw) // 3])
    return str(d)


@pytest.fixture(scope="module")
def reaped(dm_corpus, tmp_path_factory):
    """reap on 7 usable files in statistics batches of 3 (two full and a
    ragged one), against emx's."""
    paths = harvest.find_dm_files(dm_corpus)
    assert paths == emx_harvest.find_dm_files(dm_corpus)
    ours = tmp_path_factory.mktemp("ours")
    theirs = tmp_path_factory.mktemp("theirs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harvest, "STATS_BATCH", 3)
        m = harvest.reap(paths, str(ours), size=128, device=CPU)
    e = emx_harvest.reap(paths, str(theirs), size=128)
    return paths, m, e, ours, theirs


def test_census_matches_emx(dm_corpus):
    paths = harvest.find_dm_files(dm_corpus)
    got = harvest.census(paths)
    assert got == emx_harvest.census(paths)
    assert got == {"total": 10, "decode_failed": 1, "not_imaging": 1,
                   "too_small": 1, "too_dim": 0, "usable": 7}


def test_reap_matches_emx(reaped):
    """The manifests key for key (the same files, order, sources and
    stats keys in the same order), the stats within rtol 1e-3 / atol
    1e-4 (a skewness near 0 differs by ~2e-5 in float32), the TIFFs
    within 2e-5 (the non-integer resize)."""
    _, m, e, ours, theirs = reaped
    assert len(m) == len(e) == 7
    lines = [json.loads(x) for x in open(ours / "manifest_0.jsonl")]
    elines = [json.loads(x) for x in open(theirs / "manifest_0.jsonl")]
    for r, er in zip(lines, elines):
        assert list(r) == list(er)
        assert r["source"] == er["source"] and r["split"] == er["split"]
        assert r["path"].replace(str(ours), "") == \
            er["path"].replace(str(theirs), "")
        assert list(r["stats"]) == list(er["stats"])
        for k, v in er["stats"].items():
            np.testing.assert_allclose(r["stats"][k], v, rtol=1e-3,
                                       atol=1e-5, err_msg=k)
        a, b = read_tiff(r["path"]), read_tiff(er["path"])
        assert a.shape == b.shape == (128, 128)
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


def test_crop_dataset_pack_and_csv_match_emx(reaped, tmp_path):
    _, m, e, _, _ = reaped
    got = harvest.crop_dataset(m, str(tmp_path / "ours"), tile=64, seed=2)
    want = emx_harvest.crop_dataset(e, str(tmp_path / "theirs"), tile=64,
                                     seed=2)
    assert got == want
    for dtype in (np.float32, np.uint16, np.uint8):
        n = harvest.pack_crops(str(tmp_path / "ours" / "train"),
                               str(tmp_path / "p.npy"), 64, dtype)
        emx_harvest.pack_crops(str(tmp_path / "theirs" / "train"),
                               str(tmp_path / "e.npy"), 64, dtype)
        a, b = np.load(tmp_path / "p.npy"), np.load(tmp_path / "e.npy")
        assert n == len(a) and a.dtype == b.dtype == dtype
        assert np.abs(a.astype(np.float64) - b).max() <= (
            2e-5 if dtype == np.float32 else 1)
    harvest.stats_to_csv([m], str(tmp_path / "s.csv"))
    emx_harvest.stats_to_csv([e], str(tmp_path / "e.csv"))
    rows = list(csv.reader(open(tmp_path / "s.csv")))
    erows = list(csv.reader(open(tmp_path / "e.csv")))
    assert rows[0] == erows[0] and len(rows) == len(erows) == 8


def test_extract_stacks_matches_emx(tmp_path):
    stack = (RNG.random((3, 40, 40)) * 10).astype(np.float32)
    emx_write_dm(str(tmp_path / "s.dm4"), stack)
    got = harvest.extract_stacks([str(tmp_path / "s.dm4")],
                                 str(tmp_path / "ours"))
    want = emx_harvest.extract_stacks([str(tmp_path / "s.dm4")],
                                      str(tmp_path / "theirs"))
    assert len(got) == len(want) == 1
    for m in range(3):
        np.testing.assert_array_equal(
            read_tiff(f"{got[0]}/img{m + 1}.tif"), stack[m])


# -- DataPipeline --------------------------------------------------------

@pytest.fixture(scope="module")
def tiff_dir(tmp_path_factory):
    """Eleven TIFFs written by emx: nine of 48x40, one square at the
    crop size and one smaller than the crop (padded with 0.5)."""
    d = tmp_path_factory.mktemp("tiffs")
    paths = []
    for i in range(11):
        shape = (32, 32) if i == 9 else (20, 44) if i == 10 else (48, 40)
        p = str(d / f"{i:02d}.tif")
        emx_write_tiff(p, RNG.random(shape).astype(np.float32) * (i + 1))
        paths.append(p)
    return paths


def _batches(pipe, n):
    it = iter(pipe)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("workers", [1, 3])
def test_pipeline_matches_emx_across_epochs(tiff_dir, workers):
    """The same batches as emx's for the same files and seed, through
    three epochs (11 files, batch 4: two batches an epoch), bit for
    bit, and the same cursor after each."""
    cfg = dict(batch_size=4, crop_size=32, seed=5, num_workers=workers,
               prefetch=2)
    ours = DataPipeline(tiff_dir, PipelineConfig(**cfg))
    theirs = EmxPipeline(tiff_dir, EmxPipelineConfig(**cfg))
    oi, ti = iter(ours), iter(theirs)
    for _ in range(6):
        a, b = next(oi), next(ti)
        assert a.dtype == np.float32 and a.shape == (4, 32, 32)
        np.testing.assert_array_equal(a, b)
        assert ours.state_dict() == theirs.state_dict()
    assert ours.state_dict() == {"epoch": 2, "index": 8}


def test_pipeline_resumes_mid_epoch_like_emx(tiff_dir):
    cfg = dict(batch_size=3, crop_size=32, seed=1, num_workers=2)
    whole = _batches(DataPipeline(tiff_dir, PipelineConfig(**cfg)), 7)
    first = DataPipeline(tiff_dir, PipelineConfig(**cfg))
    _batches(first, 4)
    cursor = first.state_dict()
    assert cursor == {"epoch": 1, "index": 3}
    resumed = DataPipeline(tiff_dir, PipelineConfig(**cfg))
    resumed.load_state_dict(cursor)
    emx_resumed = EmxPipeline(tiff_dir, EmxPipelineConfig(**cfg))
    emx_resumed.load_state_dict(cursor)
    for a, b, c in zip(_batches(resumed, 3), _batches(emx_resumed, 3),
                       whole[4:]):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(a, b)


def test_pipeline_packed_arrays_match_emx():
    """An array source at the crop size takes the one-gather path and
    keeps its dtype (integer packs), as emx's."""
    packed = (RNG.random((9, 16, 16)) * 65535).astype(np.uint16)
    cfg = dict(batch_size=4, crop_size=16, seed=2)
    for a, b in zip(_batches(DataPipeline(packed, PipelineConfig(**cfg)), 5),
                    _batches(EmxPipeline(packed, EmxPipelineConfig(**cfg)),
                             5)):
        assert a.dtype == np.uint16
        np.testing.assert_array_equal(a, b)


def test_pipeline_refuses_a_batch_larger_than_the_source(tiff_dir):
    with pytest.raises(ValueError, match="exceeds"):
        DataPipeline(tiff_dir[:3], PipelineConfig(batch_size=4))
