"""The port's Poisson degrade (emx_torch/ops/degrade_kernel.py) on the
CPU, where the wrapper takes its plain version: Philox against published
known-answer vectors, the sampler's moments against Poisson's, the
rescaled output against emx's statistical reference in distribution,
emx's own degrade checks (tests/test_parallel_ops.py:62-106), the
small-rate divergence from emx's Pallas kernel, and the batched
example synthesis against emx's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emx.data.degrade import denoiser_example as flax_denoiser_example
from emx.data.degrade import sample_dose_scale as flax_dose_scale
from emx.utils.image import flip_rotate as flax_flip_rotate
from emx.ops.degrade_kernel import reference_poisson_degrade
from emx_torch.data.degrade import denoiser_example, sample_dose_scale
from emx_torch.ops import _build, degrade_kernel
from emx_torch.ops.degrade_kernel import (TILE, degrade_plan,
                                          fused_poisson_degrade,
                                          philox4x32_10,
                                          poisson_counts_reference)
from emx_torch.utils.image import flip_rotate


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    """Two intra-op threads: the suite runs files in parallel workers,
    and torch's default of one thread per core oversubscribes them."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# Random123's known-answer vectors of Philox4x32-10: (counter, key, out).
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,expected", PHILOX_KAT)
def test_philox_known_answers(counter, key, expected):
    words = philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in words) == expected


def _counts(rate, seed=3, n=4):
    """Counts of n constant 256x256 images at `rate`: 262,144 draws."""
    return poisson_counts_reference(
        seed, torch.full((n, 256, 256), 1.0), torch.full((n,), float(rate)))


@pytest.mark.parametrize("rate", [0.5, 2.0, 5.0, 9.5, 10.5, 30.0, 200.0])
def test_sampler_moments_match_poisson(rate):
    c = _counts(rate).double()
    n = c.numel()
    # Below 10 the draw is exact Poisson; above, the rounded normal adds
    # the rounding's 1/12 to the variance. 5 standard errors: mean SE
    # sqrt(rate / n), variance SE sqrt((rate + 2 rate^2) / n).
    var = rate + (1 / 12 if rate >= 10 else 0.0)
    assert abs(float(c.mean()) - rate) < 5 * (rate / n) ** 0.5
    assert abs(float(c.var()) - var) < 5 * ((rate + 2 * rate ** 2) / n) ** 0.5
    assert bool((c == c.round()).all()) and float(c.min()) >= 0


def _emx_kernel_loop(u, rate):
    """numpy transcription of emx/ops/degrade_kernel.py:50-63, the small-
    rate CDF loop of the Pallas kernel as written."""
    safe = np.float32(min(rate, 15.0))
    p = np.exp(-safe).astype(np.float32)
    cdf = p
    k = np.zeros_like(u)
    for i in range(1, 32):
        p = np.float32(p * safe / np.float32(i))
        cdf = np.float32(cdf + p)
        k = k + (u > cdf).astype(np.float32)
    return k


@pytest.mark.parametrize("rate", [0.5, 2.0, 5.0, 9.5])
def test_emx_kernel_loop_is_one_count_low(rate):
    """emx's kernel compares from j = 1 on and so draws max(X - 1, 0),
    whose mean is rate - 1 + exp(-rate): 0.107 at 0.5, 1.135 at 2, 4.007
    at 5, 8.500 at 9.5. The port counts from j = 0 and draws X (ROADMAP.md
    Queue 3). Both within 5 standard errors (sqrt(rate / n) bounds the
    std of either draw) of 262,144 draws."""
    n = 262_144
    u = np.random.default_rng(0).random(n).astype(np.float32)
    emx_mean = float(_emx_kernel_loop(u, rate).mean())
    port_mean = float(_counts(rate).double().mean())
    se = (rate / n) ** 0.5
    assert abs(emx_mean - (rate - 1.0 + np.exp(-rate))) < 5 * se
    assert abs(port_mean - rate) < 5 * se


def _stats(out, imgs):
    """Per image: mean of the output, std of its residual against the
    clean image rescaled to [0, 1]."""
    lo = imgs.min(axis=(1, 2), keepdims=True)
    hi = imgs.max(axis=(1, 2), keepdims=True)
    clean = (imgs - lo) / (hi - lo)
    return out.mean(axis=(1, 2)), (out - clean).std(axis=(1, 2))


def test_matches_emx_reference_in_distribution():
    """Per-image mean and residual std at four doses, port against emx's
    jax.random.poisson reference, over 16 seeds each. The min-max rescale
    makes both statistics depend on the draw's extremes, so they scatter
    from seed to seed; they must agree within 4 standard errors of the
    difference of the two 16-seed means."""
    rng = np.random.default_rng(0)
    imgs = rng.random((4, 128, 128)).astype(np.float32)
    doses = np.array([30.0, 80.0, 150.0, 400.0], np.float32)
    port, ref = [], []
    for seed in range(16):
        port.append(_stats(fused_poisson_degrade(
            seed, torch.from_numpy(imgs), torch.from_numpy(doses)).numpy(),
            imgs))
        ref.append(_stats(np.asarray(reference_poisson_degrade(
            jax.random.key(seed), jnp.asarray(imgs), jnp.asarray(doses))),
            imgs))
    port, ref = np.array(port), np.array(ref)   # (seed, stat, image)
    se = np.sqrt(port.var(0, ddof=1) / 16 + ref.var(0, ddof=1) / 16)
    assert (np.abs(port.mean(0) - ref.mean(0)) < 4 * se).all()
    # The residual falls with dose in both.
    for r in (port, ref):
        assert (np.diff(r.mean(0)[1]) < 0).all()


def test_range_and_residual_fall_with_dose():
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.random((4, 64, 64)).astype(np.float32))
    out = fused_poisson_degrade(7, imgs, torch.tensor([30.0, 80.0, 150.0,
                                                       400.0])).numpy()
    assert out.shape == (4, 64, 64)
    assert out.min() >= 0.0 and out.max() <= 1.0
    _, resid = _stats(out, imgs.numpy())
    assert resid[-1] < resid[0]


def test_constant_images():
    # Poisson(100): the rescaled output sits mid-range; a zero image
    # draws all-zero counts, a constant, which maps to 0.5.
    out = fused_poisson_degrade(3, torch.full((1, 128, 128), 0.5),
                                torch.tensor([200.0]))
    assert 0.3 < float(out.mean()) < 0.7
    zero = fused_poisson_degrade(3, torch.zeros((2, 16, 16)),
                                 torch.tensor([50.0, 50.0]))
    assert bool((zero == 0.5).all())


def test_deterministic_per_seed():
    imgs = torch.from_numpy(
        np.random.default_rng(1).random((2, 32, 32)).astype(np.float32))
    scales = torch.tensor([50.0, 50.0])
    a = fused_poisson_degrade(5, imgs, scales)
    b = fused_poisson_degrade(5, imgs, scales)
    c = fused_poisson_degrade(6, imgs, scales)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])   # images of one batch differ
    # The 64-bit seed's high word keys the stream too.
    assert not torch.equal(a, fused_poisson_degrade(5 + 2 ** 32, imgs,
                                                    scales))


def test_wrapper_checks_and_cpu_path():
    imgs, scales = torch.rand(2, 8, 8), torch.tensor([10.0, 20.0])
    before = fused_poisson_degrade.launches
    fused_poisson_degrade(0, imgs, scales)
    assert fused_poisson_degrade.launches == before   # the CPU: plain
    with pytest.raises(ValueError, match="B, H, W"):
        fused_poisson_degrade(0, imgs[0], scales)
    with pytest.raises(ValueError, match="scales"):
        fused_poisson_degrade(0, imgs, scales[:1])
    with pytest.raises(TypeError, match="float32"):
        fused_poisson_degrade(0, imgs.double(), scales)
    with pytest.raises(ValueError, match="seed"):
        fused_poisson_degrade(-1, imgs, scales)
    with pytest.raises(ValueError, match="contiguous"):   # as the kernel
        fused_poisson_degrade(0, imgs.transpose(1, 2), scales)
    with pytest.raises(ValueError, match="device"):
        fused_poisson_degrade(0, imgs.to("meta"), scales.to("meta"))


def test_kernel_source_is_self_contained():
    """K2 carries its own Philox (no cuRAND, no torch headers; only the
    CUDA runtime, whose launch API gives the rescale its programmatic
    dependence) and is not built with fast math, which would change
    expf/logf/cosf and the divisions the plain version repeats."""
    src = (_build.CSRC / "degrade.cu").read_text()
    includes = [ln for ln in src.splitlines() if ln.startswith("#include")]
    assert includes == ["#include <cuda_runtime.h>", "#include <cstdint>"]
    assert "0xD2511F53u" in src and "emx_poisson_degrade" in src
    assert not any("fast" in f for f in _build.NVCC_FLAGS)


def _source_constant(name: str) -> str:
    src = (_build.CSRC / "degrade.cu").read_text()
    line, = [ln for ln in src.splitlines()
             if ln.startswith(f"constexpr int {name} = ")]
    return line.split("=")[1].split(";")[0].strip()


def test_degrade_plan_follows_the_source():
    """The plan's tile sizes are the kernel's: 256 threads of 8 elements
    a counting block, 16,384 elements a rescale block."""
    assert _source_constant("THREADS") == str(degrade_kernel.THREADS)
    assert _source_constant("TILE") == "THREADS * PER_THREAD"
    assert int(_source_constant("PER_THREAD")) * degrade_kernel.THREADS \
        == TILE
    assert _source_constant("RESCALE_TILE") == str(
        degrade_kernel.RESCALE_TILE)
    assert _source_constant("INV_TERMS") == str(degrade_kernel.INV_TERMS)


def _spans(grid: int, tiles: int, tile: int, hw: int):
    """(image, first element, end) of each block, as the kernels compute
    them: block k takes tile k % tiles of image k // tiles."""
    return [(k // tiles, (k % tiles) * tile, min((k % tiles + 1) * tile, hw))
            for k in range(grid)]


def _covered_once(spans, b: int, hw: int) -> bool:
    """Whether the blocks' (image, start, end) spans cover every element
    of every image exactly once."""
    per_image: dict[int, list[tuple[int, int]]] = {}
    for image, start, end in spans:
        assert 0 <= image < b and 0 <= start < end <= hw
        per_image.setdefault(image, []).append((start, end))
    if sorted(per_image) != list(range(b)):
        return False
    for runs in per_image.values():
        runs.sort()
        if runs[0][0] != 0 or runs[-1][1] != hw or any(
                a[1] != c[0] for a, c in zip(runs, runs[1:])):
            return False
    return True


@pytest.mark.parametrize("b,hw,tiles,rescale_tiles", [
    (16, 512 * 512, 128, 16),    # the training batch
    (4, 512 * 512, 128, 16),
    (1, 35, 1, 1),               # (1, 7, 5): one partial block each
    (1000, 35, 1, 1),            # many tiny images, one block each
    (40, 512 * 512, 128, 16),
    (3, 50 * 47, 2, 1),          # no whole tile: the second block partial
])
def test_degrade_plan(b, hw, tiles, rescale_tiles):
    """A counting block per 2,048 elements of one image and a rescale
    block per 16,384, as many as the shape needs: every element in exactly
    one block of each grid, as the kernels compute their spans."""
    plan = degrade_plan(b, hw)
    assert (plan.tiles, plan.rescale_tiles) == (tiles, rescale_tiles)
    assert (plan.grid, plan.rescale_grid) == (b * tiles, b * rescale_tiles)
    assert _covered_once(_spans(plan.grid, plan.tiles, TILE, hw), b, hw)
    assert _covered_once(_spans(plan.rescale_grid, plan.rescale_tiles,
                                degrade_kernel.RESCALE_TILE, hw), b, hw)


def test_degrade_plan_shared_memory_and_lists():
    """A counting block's shared memory: a 16-byte list entry for each of
    its 2,048 elements, the CDF terms' (j, 1/j), the warps' (min, max)
    and two counters: under the 48 KB of static shared memory, and five
    blocks fit in an H100 SM's 228 KB (1 KB reserved a block). The two
    lists share one array of TILE entries, which holds every element of
    any block's tile, the ragged last one too."""
    plan = degrade_plan(16, 512 * 512)
    assert plan.smem_bytes == 2048 * 16 + 64 * 8 + 8 * 2 * 4 + 8 == 33352
    assert plan.smem_bytes <= 48 * 1024
    assert 5 * (plan.smem_bytes + 1024) <= 228 * 1024
    for b, hw in ((16, 512 * 512), (3, 50 * 47), (1, 35)):
        plan = degrade_plan(b, hw)
        assert all(end - start <= TILE for _, start, end in
                   _spans(plan.grid, plan.tiles, TILE, hw))


def test_degrade_plan_refuses_what_the_kernel_cannot_launch():
    with pytest.raises(ValueError, match="empty"):
        degrade_plan(0, 512 * 512)
    with pytest.raises(ValueError, match="32 bits"):
        degrade_plan(1, 2 ** 32)
    with pytest.raises(ValueError, match="2\\^31"):
        degrade_plan(2 ** 20, 2 ** 22)


def test_dose_scale_matches_emx_in_distribution():
    # 25 + 75 Exponential(1): mean 100, sd 75. 20,000 draws each; means
    # within 4 standard errors (4 * 75 * sqrt(2 / 20000) = 3.0).
    n = 20_000
    port = sample_dose_scale(torch.Generator().manual_seed(0), n).numpy()
    ref = np.asarray(jax.vmap(flax_dose_scale)(
        jax.random.split(jax.random.key(0), n)))
    assert port.min() >= 25.0 and ref.min() >= 25.0
    assert abs(port.mean() - ref.mean()) < 3.0
    assert abs(port.mean() - 100.0) < 2.2 and abs(ref.mean() - 100.0) < 2.2
    assert abs(np.median(port) - np.median(ref)) < 3.0


def test_flip_rotate_matches_emx_branch_order():
    img = np.random.default_rng(0).random((6, 6)).astype(np.float32)
    got = flip_rotate(torch.from_numpy(np.stack([img] * 8)), torch.arange(8))
    assert got.is_contiguous()   # the degrade kernel takes it as it is
    got = got.numpy()
    for choice in range(8):
        ref = np.asarray(flax_flip_rotate(jnp.asarray(img), choice))
        np.testing.assert_array_equal(got[choice], ref)


def _d4_codes(batch):
    """Which D4 transform each (4, 4) image of a transformed arange(16)
    got: the places of its largest and second-largest pixel, a corner
    and an edge beside it, differ for all eight."""
    order = np.argsort(batch.reshape(len(batch), -1), axis=1)
    return order[:, -1] * 16 + order[:, -2]


def test_denoiser_example_matches_emx_in_distribution():
    """Each image gets its own D4 transform, uniform over the eight as in
    emx; the target is the clean image rescaled to its noisy image's
    mean."""
    n = 2048
    imgs = torch.arange(16.0).reshape(1, 4, 4).repeat(n, 1, 1)
    lq, target = denoiser_example(11, imgs)
    assert lq.shape == target.shape == (n, 4, 4)
    assert float(lq.min()) >= 0.0 and float(lq.max()) <= 1.0
    torch.testing.assert_close(target.mean(dim=(1, 2)), lq.mean(dim=(1, 2)),
                               rtol=1e-5, atol=1e-6)
    _, flax_t = jax.vmap(flax_denoiser_example)(
        jax.random.split(jax.random.key(0), n), jnp.asarray(imgs.numpy()))
    # 256 expected per transform, sd sqrt(2048 / 8 * 7 / 8) = 15; 4 sd.
    for codes in (_d4_codes(target.numpy()), _d4_codes(np.asarray(flax_t))):
        values, counts = np.unique(codes, return_counts=True)
        assert len(values) == 8
        assert (np.abs(counts - n / 8) < 60).all()
