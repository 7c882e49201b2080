"""The port's remaining tools against emx's on the CPU:
emx_torch/data/cif.py (no network: fetch_cifs gets a fake opener),
emx_torch/data/misc_files.py and emx_torch/bench/sweep.py (its variant
table, and `measure` at a tiny size).

Tolerances: the noise census within 1e-6 relative (float32 sums in
another order); everything else equal."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import emx.data.cif as emx_cif
import emx.data.misc_files as emx_misc
from emx_torch.bench import sweep
from emx_torch.data import cif, misc_files
from emx_torch.io.tiff import write_tiff

CPU = torch.device("cpu")

CIFS = {
    "cod://quartz": """data_quartz
_chemical_formula_sum 'Si O2'
_cell_length_a 4.913
_publ_section_title
;
 A title on its own lines
;
loop_
_atom_site_label
_atom_site_type_symbol
_atom_site_fract_x
Si1 Si4+ 0.470
O1 'O2-' 0.413
data_second_block
_cell_length_a 9.9
""",
    "cod://ice": """data_ice
loop_
_atom_site_label
_atom_site_fract_x
O1 0.0
HO1 0.1
""",
    "cod://holmium": """data_ho
loop_
_atom_site_label
Ho1
Hf2
""",
    "cod://broken": None,
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_cif_parsing_matches_emx():
    for text in (t for t in CIFS.values() if t):
        got, want = cif.parse_cif(text), emx_cif.parse_cif(text)
        assert got == want
        assert cif.atom_elements(got) == emx_cif.atom_elements(want)
        assert cif.contains_hydrogen(got) == emx_cif.contains_hydrogen(want)
    for label in ("O2-", "Fe3+", "Ca1", "D", "HO1", "Hf2", "Ho1", "x"):
        assert cif.element_symbol(label) == emx_cif.element_symbol(label)
    assert cif.ATOMIC_NUMBER == emx_cif.ATOMIC_NUMBER


@pytest.mark.parametrize("no_h_only", [False, True])
def test_fetch_filter_and_stage_match_emx(tmp_path, no_h_only):
    """fetch_cifs with a fake opener (a None blob raises, as a failed
    download would), then filter_no_h and stage_felix_jobs: the same
    files as emx's, byte for byte."""
    sel = tmp_path / "sel.txt"
    sel.write_text("\n".join(CIFS) + "\n")

    def opener(url):
        if CIFS[url] is None:
            raise OSError("unreachable")
        return CIFS[url].encode()

    tpl = tmp_path / "tpl"
    tpl.mkdir()
    (tpl / "felix.inp").write_text("inp")
    (tpl / "felix.hkl").write_text("hkl")
    trees = {}
    for name, mod in (("port", cif), ("emx", emx_cif)):
        out = tmp_path / name
        n = mod.fetch_cifs(str(sel), str(out / "cifs"), n=3, opener=opener,
                           no_h_only=no_h_only, seed=4)
        paths = sorted(str(p) for p in (out / "cifs").iterdir())
        keep = mod.filter_no_h(paths + [str(out / "missing.cif")])
        staged = mod.stage_felix_jobs(keep, [str(tpl)], str(out / "jobs"),
                                      4, seed=1)
        trees[name] = (n, [os.path.basename(p) for p in keep], staged, {
            os.path.relpath(os.path.join(d, f), out): open(
                os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(out) for f in fs})
    assert trees["port"] == trees["emx"]


def test_partition_dataset_matches_emx(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for i in range(13):
        write_tiff(str(src / f"img{i}.tif"),
                   np.full((4, 4), i / 13, np.float32))
    got = misc_files.partition_dataset(str(src), str(tmp_path / "p"), seed=2)
    want = emx_misc.partition_dataset(str(src), str(tmp_path / "e"), seed=2)
    assert got == want
    for split in got:
        names = sorted(os.listdir(tmp_path / "p" / split))
        assert names == sorted(os.listdir(tmp_path / "e" / split))
        for n in names:
            assert (tmp_path / "p" / split / n).read_bytes() == \
                (tmp_path / "e" / split / n).read_bytes()


def test_noise_census_matches_emx(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, sigma in enumerate((0.01, 0.05, 0.2)):
        paths.append(str(tmp_path / f"n{i}.tif"))
        write_tiff(paths[-1], (0.5 + rng.normal(0, sigma, (40, 56)))
                   .astype(np.float32))
    paths.append(str(tmp_path / "missing.tif"))
    got = misc_files.noise_census(paths)
    want = emx_misc.noise_census(paths)
    assert [r["path"] for r in got] == [r["path"] for r in want] == paths[:3]
    for g, w in zip(got, want):
        assert g["mean"] == w["mean"]
        assert g["noise"] == pytest.approx(w["noise"], rel=1e-6)


def test_video_and_ocr_tools_match_emx(tmp_path):
    """video_to_slices writes emx's frames where cv2 is installed;
    images_to_text raises emx's ImportError where pytesseract is not."""
    for fn, args in ((misc_files.images_to_text, (str(tmp_path),)),
                     (misc_files.video_to_slices, ("x.mp4", str(tmp_path)))):
        dep = "pytesseract" if fn is misc_files.images_to_text else "cv2"
        try:
            __import__(dep)
        except ImportError:
            with pytest.raises(ImportError) as got:
                fn(*args)
            with pytest.raises(ImportError) as want:
                getattr(emx_misc, fn.__name__)(*args)
            assert str(got.value) == str(want.value)
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5.0, (16, 16))
    if not vw.isOpened():
        pytest.skip("no usable VideoWriter backend")
    for i in range(5):
        vw.write(np.full((16, 16, 3), i * 50, np.uint8))
    vw.release()
    n = misc_files.video_to_slices(path, str(tmp_path / "p"), every_n=2)
    assert n == emx_misc.video_to_slices(path, str(tmp_path / "e"),
                                         every_n=2) == 3
    for j in range(n):
        assert (tmp_path / "p" / f"frame{j}.png").read_bytes() == \
            (tmp_path / "e" / f"frame{j}.png").read_bytes()


def test_sweep_variants_match_emx(monkeypatch):
    """The port's table is emx's: the same names, batches and configs
    (emx's table is read from its main with measure stubbed)."""
    cache = "JAX_COMPILATION_CACHE_DIR"
    if cache not in os.environ:   # emx's module sets it on import
        monkeypatch.setenv(cache, "")
        monkeypatch.delenv(cache)
    import emx.bench.sweep as emx_sweep

    seen = {}
    monkeypatch.setattr(emx_sweep, "measure",
                        lambda name, cfg, b: seen.update({name: (cfg, b)}))
    port = sweep.variants()
    emx_sweep.main(list(port))
    assert set(seen) == set(port)
    for name, (cfg, b) in port.items():
        ref_cfg, ref_b = seen[name]
        assert b == ref_b, name
        for f in dataclasses.fields(cfg):
            if f.name in ("dtype", "axis_name"):
                continue
            assert getattr(cfg, f.name) == getattr(ref_cfg, f.name), \
                (name, f.name)
        assert cfg.dtype == torch.bfloat16
        assert ref_cfg.dtype.__name__ == "bfloat16"


def test_sweep_measure_tiny():
    """measure at a tiny config and size on the CPU: emx's keys (the
    first call's seconds for emx's compile seconds), finite forwards."""
    from emx_torch.nn import DenoiserConfig

    cfg = dataclasses.replace(DenoiserConfig.tiny(), norm="group",
                              dtype=torch.bfloat16)
    out = sweep.measure("tiny", cfg, 2, n_iters=2, size=32, device=CPU)
    assert set(out) == {"variant", "batch", "size", "img_per_s",
                        "ms_per_launch", "first_call_s", "device"}
    assert out["device"] == "cpu" and out["img_per_s"] > 0
