"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``; every test skips without a card. The
file imports neither JAX nor OpenCV, so it runs on the card's machine:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances: kernels A, B, D, E, F and their plain versions do the same
float32 operations in the same order (the kernels are built without FMA
contraction), so they agree to 1e-4 on [0, 255] images and 1e-5 (1e-6 for
the block-local lookups) on correlation values; 0 is expected. Kernel C
sums its products in another order than the plain einsum; its tests state
the bound. Kernels G, H and I round to bf16 inside (gates, activations), and
they too sum in another order than their plain versions, so a rounding may
fall the other way on a small share of entries; their tests state the bound
in bf16 ulps of the rounded quantity.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from woft_tpu_torch.device import resolve_device
from woft_tpu_torch.models import corr, layers, update
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.ops import kernels, warp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return resolve_device("cuda")


def _h(theta, scale, tx, ty, persp=(0.0, 0.0)):
    c, s = math.cos(theta) * scale, math.sin(theta) * scale
    return torch.tensor([[c, -s, tx], [s, c, ty], [persp[0], persp[1], 1.0]])


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("H", [
    _h(0.0, 1.0, 0.5, -0.25),
    _h(math.radians(30), 1.5, 20.0, -10.0),            # outside the TPU envelope
    _h(math.pi / 2, 2.0, 150.0, -20.0),
    _h(0.05, 0.9, 90.0, 40.0, (2e-4, -1e-4)),          # partly off-image
    _h(0.0, 1.0, 1e4, -3e3),                           # fully off-image
], ids=["subpixel", "rot30x1.5", "rot90x2", "perspective", "off-image"])
def test_warp_kernel_matches_plain(dev, H, channels):
    """97 x 203 cuts the 32 x 8 tiles on both axes; 1, 3 and 4 channels are
    the kernel's templates."""
    g = torch.Generator(device=dev).manual_seed(0)
    img = torch.rand(1, 97, 203, channels, device=dev, generator=g) * 255
    H = H.to(dev)
    n0 = kernels.warp_perspective_bilinear.launches
    got = warp.warp_perspective_fast(img, H)
    want = warp.warp_perspective(img, H)
    torch.cuda.synchronize()
    assert kernels.warp_perspective_bilinear.launches == n0 + 1
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("channels", [1, 3, 4, 5])
@pytest.mark.parametrize("out_hw", [(32, 48), (37, 45), (7, 5)],
                         ids=["32x48", "37x45", "7x5"])
def test_warp_kernel_batch_and_output_size(dev, channels, out_hw):
    """A batch of two, an output size other than the source's and not a
    multiple of the tile, and a channel count without a template (5)."""
    g = torch.Generator(device=dev).manual_seed(1)
    img = torch.rand(2, 40, 56, channels, device=dev, generator=g) * 255
    H = torch.stack([_h(0.1, 1.1, 3.0, 2.0), _h(-0.2, 0.8, -5.0, 7.0)]).to(dev)
    got = kernels.warp_perspective_bilinear(img, warp.inverse_h(H), *out_hw)
    want = warp.warp_perspective(img, H, out_shape=out_hw)
    assert got.shape == want.shape == (2, *out_hw, channels)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("src_hw,out_hw,scale,t", [
    ((1080, 1920), (192, 344), 0.3, (-450.0, -156.0)),     # partly off
    ((1080, 1920), (192, 344), 0.2688, (-93.0, -96.0)),    # bench.py's crop
    ((720, 1280), (192, 344), 0.4033, (-86.0, -96.8)),     # WOFT_window 720p
    ((720, 1280), (320, 512), 0.6, (-128.0, -86.0)),       # native, 720p
], ids=["1080p-partly-off", "1080p", "720p", "720p-native"])
def test_warp_kernel_window_crop(dev, src_hw, out_hw, scale, t):
    """The window tracker's crop (``warp_axis_aligned``): a full frame into
    a window of another size by scale-and-translate, so a warp's 32 pixels
    span up to ~120 source columns; then the window's pre-warp by a pose
    near identity. Both exact against the plain version."""
    g = torch.Generator(device=dev).manual_seed(6)
    img = torch.rand(1, *src_hw, 3, device=dev, generator=g) * 255
    H = torch.tensor([[scale, 0.0, t[0]], [0.0, scale, t[1]],
                      [0.0, 0.0, 1.0]], device=dev)
    n0 = kernels.warp_perspective_bilinear.launches
    got = warp.warp_axis_aligned(img, H, out_hw)
    want = warp.warp_perspective(img, H, out_hw)
    torch.cuda.synchronize()
    assert kernels.warp_perspective_bilinear.launches == n0 + 1
    assert got.shape == want.shape == (1, *out_hw, 3)
    assert (got - want).abs().max().item() <= 1e-4
    prior = _h(0.003, 1.002, 0.7, -1.2, (1e-5, -2e-5)).to(dev)
    got = warp.warp_perspective_fast(want, prior)
    assert (got - warp.warp_perspective(want, prior)).abs().max().item() \
        <= 1e-4


@pytest.mark.parametrize("n", [2, 8])
def test_warp_kernel_one_source_n_homographies(dev, n):
    """One source warped by N homographies in one launch: the multi-target
    tracker's N search crops from one frame (a 1080p frame, N crops of
    256 x 256 at the multi-target layout), each equal to the plain warp."""
    g = torch.Generator(device=dev).manual_seed(7)
    img = torch.rand(1, 1080, 1920, 3, device=dev, generator=g) * 255
    hs = []
    for t in range(n):
        x0, y0 = (t % 4) * 480 + 60, (t // 4) * 540 + 100
        s = 256.0 / (300.0 + 20 * t)
        hs.append(torch.tensor([[s, 0.0, -s * x0], [0.0, s, -s * y0],
                                [0.0, 0.0, 1.0]]))
    H = torch.stack(hs).to(dev)
    n0 = kernels.warp_perspective_bilinear.launches
    got = warp.warp_axis_aligned(img, H, (256, 256))
    want = warp.warp_perspective(img, H, (256, 256))
    torch.cuda.synchronize()
    assert kernels.warp_perspective_bilinear.launches == n0 + 1
    assert got.shape == want.shape == (n, 256, 256, 3)
    assert (got - want).abs().max().item() <= 1e-4
    for t in range(n):
        one = kernels.warp_perspective_bilinear(img, warp.inverse_h(H[t:t + 1]),
                                                256, 256)
        assert torch.equal(one[0], got[t])


def test_warp_wrapper_checks_inputs(dev):
    img = torch.rand(1, 16, 16, 3, device=dev)
    hinv = torch.eye(3, device=dev)[None]
    with pytest.raises(TypeError):
        kernels.warp_perspective_bilinear(img.double(), hinv, 16, 16)
    with pytest.raises(ValueError):
        kernels.warp_perspective_bilinear(img.transpose(1, 2), hinv, 16, 16)
    with pytest.raises(ValueError):
        kernels.warp_perspective_bilinear(img, hinv.cpu(), 16, 16)
    with pytest.raises(ValueError):          # a source batch of 1 or N
        kernels.warp_perspective_bilinear(img.repeat(2, 1, 1, 1),
                                          hinv.repeat(3, 1, 1), 16, 16)


@pytest.fixture(scope="module")
def pyramid(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    f1 = torch.randn(1, 23, 37, 64, device=dev, generator=g)
    f2 = torch.randn(1, 23, 37, 64, device=dev, generator=g)
    pyr, _ = corr.corr_pyramid_fused(f1, f2, 4)
    coords = torch.rand(1, 23, 37, 2, device=dev, generator=g) * 80 - 20
    coords[0, 0, :3] = torch.tensor([[-300.0, 5.0], [1e4, -1e4],
                                     [-5.5, -5.5]], device=dev)
    return pyr, coords


# radius 1, 3, 4: templates; 6: the run-time path. 37 and 13 columns: rows
# of 148 and 52 bytes, not multiples of 16. 851 and 143 queries fill
# neither the last block of two (four levels) nor of eight (one level).
LOOKUP_GRID = [(r, lv, hw) for r in (1, 3, 4, 6) for lv in (1, 4)
               for hw in ((23, 37), (11, 13))]
LOOKUP_IDS = [f"r{r}-L{lv}-{hw[0]}x{hw[1]}" for r, lv, hw in LOOKUP_GRID]


def _lookup_case(dev, levels, hw):
    """A pyramid over an odd-sized map, and coordinates around and beyond
    it: far outside first, then exact integers and all four borders
    straddled."""
    H1, W1 = hw
    g = torch.Generator(device=dev).manual_seed(1)
    f1 = torch.randn(1, H1, W1, 64, device=dev, generator=g)
    f2 = torch.randn(1, H1, W1, 64, device=dev, generator=g)
    pyr, _ = corr.corr_pyramid_fused(f1, f2, levels)
    coords = torch.rand(1, H1, W1, 2, device=dev, generator=g)
    coords = coords * torch.tensor([W1 + 16.0, H1 + 16.0], device=dev) - 8
    coords[0, 0, :11] = torch.tensor(
        [[-300.0, 5.0], [1e4, -1e4], [-5.5, -5.5], [3.0, 4.0], [0.0, 0.0],
         [W1 - 1.0, H1 - 1.0], [-0.5, 5.25], [W1 - 0.5, 5.25],
         [6.75, -0.5], [6.75, H1 - 0.5], [W1 - 0.75, H1 - 0.25]], device=dev)
    return pyr, coords


@pytest.mark.parametrize("radius,levels,hw", LOOKUP_GRID, ids=LOOKUP_IDS)
def test_lookup_kernel_matches_plain(dev, radius, levels, hw):
    pyr, coords = _lookup_case(dev, levels, hw)
    n0 = kernels.corr_pyramid_lookup.launches
    got = corr.corr_lookup(pyr, coords, radius)
    want = corr.corr_lookup_plain(pyr, coords, radius)
    torch.cuda.synchronize()
    assert kernels.corr_pyramid_lookup.launches == n0 + 1
    assert got.shape == want.shape == (1, *hw,
                                       levels * (2 * radius + 1) ** 2)
    assert (got - want).abs().max().item() <= 1e-5
    assert got[0, 0, :2].abs().max().item() == 0.0
    assert got[0, 0, 3:11].abs().amax(-1).min().item() > 0.0


@pytest.mark.parametrize("radius,levels,hw", LOOKUP_GRID, ids=LOOKUP_IDS)
def test_indexed_lookup_kernel(dev, radius, levels, hw):
    pyr, coords = _lookup_case(dev, levels, hw)
    Q = hw[0] * hw[1]
    g = torch.Generator(device=dev).manual_seed(2)
    cells = torch.randint(0, Q, (301,), device=dev, generator=g)
    cells[:11] = torch.arange(11, device=dev)          # the border cases
    cells[100:150] = cells[3]                          # duplicates
    c = coords.reshape(Q, 2)[cells][None, None]
    got = corr.corr_lookup(pyr, c, radius, rows=cells)
    want = corr.corr_lookup_plain([p[cells] for p in pyr], c, radius)
    dense = corr.corr_lookup(pyr, coords, radius).reshape(Q, -1)
    assert (got - want).abs().max().item() <= 1e-5
    assert torch.equal(got.reshape(301, -1), dense[cells])
    assert got[0, 0, :2].abs().max().item() == 0.0


def test_lookup_kernel_batched_windows(dev):
    """Kernel B over the pyramid of a batch of 8 windows of 32 x 32 cells
    (the per-window multi-target forward, B = 8: rows ``b*1024 + cell``),
    dense (Q = 8,192) and indexed at the sparse weight head's M = 8 x 4,500
    rows, each equal to the plain lookup."""
    g = torch.Generator(device=dev).manual_seed(8)
    f1 = torch.randn(8, 32, 32, 256, device=dev, generator=g)
    f2 = torch.randn(8, 32, 32, 256, device=dev, generator=g)
    pyr, _ = corr.corr_pyramid_fused(f1, f2, 4)
    coords = _grid(dev, 32, 32).expand(8, -1, -1, -1) + (torch.rand(
        8, 32, 32, 2, device=dev, generator=g) - 0.5) * 24
    coords = coords.contiguous()
    got = corr.corr_lookup(pyr, coords, 4)
    assert (got - corr.corr_lookup_plain(pyr, coords, 4)).abs().max() <= 1e-5
    rows = torch.randint(0, 8 * 1024, (36000,), device=dev, generator=g)
    c = coords.reshape(-1, 2)[rows][None, None].contiguous()
    got_i = corr.corr_lookup(pyr, c, 4, rows=rows)
    want_i = corr.corr_lookup_plain([p[rows] for p in pyr], c, 4)
    assert (got_i - want_i).abs().max().item() <= 1e-5
    assert torch.equal(got_i.reshape(36000, -1),
                       got.reshape(8 * 1024, -1)[rows])


@pytest.mark.parametrize("hw", [(30, 54), (45, 80), (68, 120), (23, 40)],
                         ids=["54x30", "80x45", "120x68", "40x23"])
def test_lookup_kernel_downscale_grids(dev, hw):
    """Kernel B dense on the padded grids of the downscale paths (3x of
    1280x720 and 1920x1080, 2x of 1920x1080, 4x of 1280x720; levels of odd
    sizes such as 23, 11, 5), at the network's 256 channels and radius 4,
    equal to the plain lookup."""
    H1, W1 = hw
    g = torch.Generator(device=dev).manual_seed(9)
    f1 = torch.randn(1, H1, W1, 256, device=dev, generator=g)
    f2 = torch.randn(1, H1, W1, 256, device=dev, generator=g)
    pyr, _ = corr.corr_pyramid_fused(f1, f2, 4)
    coords = (_grid(dev, H1, W1) + (torch.rand(
        1, H1, W1, 2, device=dev, generator=g) - 0.5) * 30).contiguous()
    n0 = kernels.corr_pyramid_lookup.launches
    got = corr.corr_lookup(pyr, coords, 4)
    want = corr.corr_lookup_plain(pyr, coords, 4)
    torch.cuda.synchronize()
    assert kernels.corr_pyramid_lookup.launches == n0 + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("radius,levels,hw", LOOKUP_GRID, ids=LOOKUP_IDS)
def test_lookup_kernel_bf16_levels(dev, radius, levels, hw):
    """Kernel B's bf16-level form (the 'bf16' and 'default' modes' pyramid)
    at odd level sizes, dense and indexed: each value widened as it is
    read, float32 blend and output, equal to the plain version on the same
    bf16 levels bit for bit."""
    pyr, coords = _lookup_case(dev, levels, hw)
    pyr = [p.to(torch.bfloat16) for p in pyr]
    n0 = kernels.corr_pyramid_lookup.launches
    got = corr.corr_lookup(pyr, coords, radius)
    want = corr.corr_lookup_plain(pyr, coords, radius)
    torch.cuda.synchronize()
    assert kernels.corr_pyramid_lookup.launches == n0 + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    Q = hw[0] * hw[1]
    g = torch.Generator(device=dev).manual_seed(3)
    cells = torch.randint(0, Q, (301,), device=dev, generator=g)
    cells[:11] = torch.arange(11, device=dev)
    c = coords.reshape(Q, 2)[cells][None, None]
    got_i = corr.corr_lookup(pyr, c, radius, rows=cells)
    assert torch.equal(got_i, corr.corr_lookup_plain(
        [p[cells] for p in pyr], c, radius))
    assert torch.equal(got_i.reshape(301, -1), got.reshape(Q, -1)[cells])


def test_lookup_wrapper_refuses_mixed_level_dtypes(dev, pyramid):
    pyr, coords = pyramid
    mixed = [pyr[0].to(torch.bfloat16)] + list(pyr[1:])
    with pytest.raises(TypeError):
        kernels.corr_pyramid_lookup(mixed, coords, 4)
    with pytest.raises(TypeError):
        kernels.corr_pyramid_lookup([p.half() for p in pyr], coords, 4)


def test_lookup_wrapper_checks_inputs(dev, pyramid):
    pyr, coords = pyramid
    with pytest.raises(ValueError):          # rows must match the queries
        kernels.corr_pyramid_lookup(pyr, coords[:, :5].contiguous(), 4)
    with pytest.raises(TypeError):
        kernels.corr_pyramid_lookup(pyr, coords, 4,
                                    rows=torch.zeros(23 * 37, device=dev,
                                                     dtype=torch.int32))
    with pytest.raises(ValueError):          # beyond the run-time path
        kernels.corr_pyramid_lookup(pyr, coords, 9)


# ---------------------------------------------------------------------------
# block-local kernels C, D, E, F
# ---------------------------------------------------------------------------

def _features(dev, H1, W1, D, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(1, H1, W1, D, device=dev, generator=g),
            torch.randn(1, H1, W1, D, device=dev, generator=g))


def _grid(dev, H1, W1):
    ys, xs = torch.meshgrid(torch.arange(H1, device=dev, dtype=torch.float32),
                            torch.arange(W1, device=dev, dtype=torch.float32),
                            indexing="ij")
    return torch.stack([xs, ys], -1)[None]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -7)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("hw", [(16, 32), (21, 50)], ids=["16x32", "21x50"])
def test_local_corr_kernel_matches_plain(dev, dtype, rtol, hw):
    """Kernel C sums the D products in another order than the plain
    einsum: float32 agrees to accumulation error; bf16 volumes to one bf16
    ulp (2^-8 relative; 2^-7 bounds it for any mantissa)."""
    f1, f2 = _features(dev, *hw, 64, seed=2)
    meta = corr._local_layout(*hw, 4, 3, 8)
    nbh, nbw = meta["nbh"], meta["nbw"]
    f1b = corr._to_blocked(f1.reshape(-1, 64), meta).reshape(
        nbh * nbw, 128, 64).to(dtype).contiguous()
    lv = f2
    for d in meta["levels"]:
        n0 = kernels.local_corr_build.launches
        f2l = lv[0].to(dtype).contiguous()
        got = corr.block_local_corr(f1b, f2l, d, nbh, nbw, dtype)
        want = corr.block_local_corr_plain(f1b, f2l, d, nbh, nbw, dtype)
        torch.cuda.synchronize()
        assert kernels.local_corr_build.launches == n0 + 1
        assert got.shape == want.shape and got.dtype == dtype
        got, want = got.float(), want.float()
        assert ((got - want).abs() <= 2e-5 + rtol * want.abs()).all()
        lv = warp.avg_pool2d(lv)


# (H1, W1, margin): the 720p grid, the 192x344 window's grid (padding
# columns), and odd sizes whose windows reach past every border of every
# level (TMA's zero fill in bf16)
LOCAL_SHAPES = [(90, 160, 16), (24, 43, 16), (135, 240, 16), (37, 53, 8),
                (13, 21, 16)]


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -7)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", LOCAL_SHAPES,
                         ids=["90x160m16", "24x43m16", "135x240m16",
                              "37x53m8", "13x21m16"])
def test_local_corr_levels_in_one_launch(dev, dtype, rtol, shape):
    """Kernel C builds all four levels in one launch, each equal to the
    plain version to the tolerance of two summation orders."""
    H1, W1, margin = shape
    D = 256 if H1 in (90, 24, 135) else 64   # the main path's feature width
    f1, f2 = _features(dev, H1, W1, D, seed=5)
    meta = corr._local_layout(H1, W1, 4, 4, margin)
    nbh, nbw = meta["nbh"], meta["nbw"]
    f1b = corr._to_blocked(f1.reshape(-1, D), meta).reshape(
        nbh * nbw, 128, D).to(dtype).contiguous()
    levels = [f2]
    while len(levels) < 4:
        levels.append(warp.avg_pool2d(levels[-1]))
    levels = [lv[0].to(dtype).contiguous() for lv in levels]
    n0 = kernels.local_corr_build.launches
    got = corr.block_local_corr_levels(f1b, levels, meta["levels"], nbh, nbw,
                                       dtype)
    torch.cuda.synchronize()
    assert kernels.local_corr_build.launches == n0 + 1
    for g, lv, d in zip(got, levels, meta["levels"]):
        want = corr.block_local_corr_plain(f1b, lv, d, nbh, nbw, dtype)
        assert g.shape == want.shape and g.dtype == dtype
        g, want = g.float(), want.float()
        assert ((g - want).abs() <= 2e-5 + rtol * want.abs()).all()
    # the cached parameter block serves a second call on the same tensors
    again = kernels.local_corr_build(
        f1b, levels, [(d["pad"], d["sh"], d["sw"], d["wh"], d["ww"])
                      for d in meta["levels"]], nbh, nbw, dtype)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.fixture(scope="module", params=[torch.float32, torch.bfloat16],
                ids=["fp32", "bf16"])
def local_volume(dev, request):
    f1, f2 = _features(dev, 40, 64, 64, seed=3)
    out_dtype = None if request.param == torch.float32 else request.param
    return corr.build_local_corr(f1, f2, 4, 3, 8, out_dtype=out_dtype)


def _coords(dev, kind):
    grid = _grid(dev, 40, 64)
    g = torch.Generator(device=dev).manual_seed(4)
    if kind == "smooth":
        xs, ys = grid[..., 0], grid[..., 1]
        res = torch.stack([0.15 * ys - 0.1 * xs + 2.3,
                           0.12 * xs + 0.05 * ys - 3.1], -1)
    else:          # independent jitter: blocks violate their fine windows
        res = (torch.rand(grid.shape, device=dev, generator=g) - 0.5) * 30
    coords = grid + res
    coords[0, :8] += 400.0                   # a saturated block row
    return coords.contiguous()


@pytest.mark.parametrize("kind", ["smooth", "jitter"])
def test_local_lookup_kernels_match_plain(dev, local_volume, kind):
    """Kernels D, E, F do the plain versions' float32 operations in the
    same order (no FMA contraction): 0 expected, 1e-6 allowed."""
    local = local_volume
    coords = _coords(dev, kind)
    k = 9
    vols = local.volumes
    od = vols[0].dtype
    starts, frac = corr._local_level_coords(local, coords)
    rcs, rel, ok = corr._fine_anchor_starts(local, starts)
    assert bool(ok.all()) == (kind == "smooth")

    n0 = kernels.local_lookup_fine_multi.launches
    got = corr.block_local_lookup_fine_multi(rcs, vols, rel, frac, k, od)
    want = corr.block_local_lookup_fine_multi_plain(rcs, vols, rel, frac, k,
                                                    od)
    torch.cuda.synchronize()
    assert kernels.local_lookup_fine_multi.launches == n0 + 1
    assert (got.float() - want.float()).abs().max().item() <= 1e-6

    n0 = kernels.local_lookup_fine.launches
    rc0 = rcs[:, 1].contiguous()
    got_f = corr.block_local_lookup_fine(rc0, vols[1], rel[1], frac[1], k)
    want_f = corr.block_local_lookup_fine_plain(rc0, vols[1], rel[1],
                                                frac[1], k)
    assert kernels.local_lookup_fine.launches == n0 + 1
    assert (got_f - want_f).abs().max().item() <= 1e-6

    n0 = kernels.local_lookup_exact.launches
    got_e = corr.block_local_lookup(vols[0], starts[0], frac[0], k)
    want_e = corr.block_local_lookup_plain(vols[0], starts[0], frac[0], k)
    assert kernels.local_lookup_exact.launches == n0 + 1
    assert got_e.dtype == torch.float32
    assert (got_e - want_e).abs().max().item() <= 1e-6

    # the guard: flagged blocks are rewritten in place, the rest kept
    flag = (~ok).to(torch.uint8)
    flag[3] = 1
    out_k, out_p = got.clone(), want.clone()
    corr.block_local_lookup(vols[0], starts[0], frac[0], k, flag=flag,
                            out=out_k, channel=0)
    corr.block_local_lookup_plain(vols[0], starts[0], frac[0], k, flag=flag,
                                  out=out_p, channel=0)
    torch.cuda.synchronize()
    assert (out_k.float() - out_p.float()).abs().max().item() <= 1e-6
    keep = flag == 0
    assert torch.equal(out_k[keep], got[keep])
    assert torch.equal(out_k[:, 81:], got[:, 81:])


@pytest.mark.parametrize("flagged", ["none", "some", "all"])
def test_exact_lookup_levels_in_one_launch(dev, local_volume, flagged):
    """Kernel E covers every level in one launch: equal to the plain
    version on the flagged blocks, and the other blocks' rows (and channels
    before ``channel``) kept bit for bit."""
    local = local_volume
    vols = local.volumes
    L, k = len(vols), 9
    nb, bq = vols[0].shape[0], vols[0].shape[3]
    starts, frac = corr._local_level_coords(local, _coords(dev, "jitter"))
    flag = torch.zeros(nb, dtype=torch.uint8, device=dev)
    if flagged == "some":
        flag[1::3] = 1
    elif flagged == "all":
        flag[:] = 1
    g = torch.Generator(device=dev).manual_seed(6)
    for od in (torch.float32, torch.bfloat16):
        base = torch.randn(nb, 5 + L * k * k, bq, device=dev,
                           generator=g).to(od)
        out_k, out_p = base.clone(), base.clone()
        n0 = kernels.local_lookup_exact.launches
        kernels.local_lookup_exact(vols, starts, frac, k, flag=flag,
                                   out=out_k, channel=5)
        assert kernels.local_lookup_exact.launches == n0 + 1
        for lvl, vol in enumerate(vols):
            corr.block_local_lookup_plain(vol, starts[lvl], frac[lvl], k,
                                          flag=flag, out=out_p,
                                          channel=5 + lvl * k * k)
        torch.cuda.synchronize()
        assert torch.equal(out_k, out_p)
        keep = flag == 0
        assert torch.equal(out_k[keep], base[keep])
        assert torch.equal(out_k[:, :5], base[:, :5])
    # no flag, no output: a new float32 (NB, L*k*k, BQ), as the plain path
    got = corr.block_local_lookup_levels(vols, starts, frac, k)
    want = corr.block_local_lookup_levels_plain(vols, starts, frac, k)
    assert got.dtype == torch.float32 and torch.equal(got, want)


def test_local_blocked_lookup_on_card_matches_cpu(dev, local_volume):
    """The whole guarded lookup on the card equals the CPU path on the same
    volume (the kernels equal their plain versions, so only the volume's
    construction could differ; the volume is shared here)."""
    local = local_volume
    cpu = corr.LocalCorrVolumes([v.cpu() for v in local.volumes], local.meta)
    for kind in ("smooth", "jitter"):
        coords = _coords(dev, kind)
        got = corr.corr_lookup_local_blocked(local, coords, 4)
        want = corr.corr_lookup_local_blocked(cpu, coords.cpu(), 4)
        exact = corr.corr_lookup_local_blocked(local, coords, 4, fine=False)
        assert (got.data.float().cpu() - want.data.float()).abs().max() <= 1e-6
        # guarded fine lookup == exact lookup (up to the output's rounding)
        assert (got.data.float()
                - exact.data.to(got.data.dtype).float()).abs().max() <= 1e-6


def _field(dev, H1, W1, kind):
    """Lookup centroids on an H1 x W1 grid: 'smooth' (an affine residual
    and a saturated block row), 'jitter' (+-15 cells: blocks violate their
    fine windows) or 'saturated' (the whole field 40 cells off)."""
    grid = _grid(dev, H1, W1)
    g = torch.Generator(device=dev).manual_seed(8)
    xs, ys = grid[..., 0], grid[..., 1]
    if kind == "smooth":
        res = torch.stack([0.02 * ys - 0.015 * xs + 2.3,
                           0.012 * xs + 0.01 * ys - 3.1], -1)
        coords = grid + res
        coords[0, :8] += 400.0
    elif kind == "jitter":
        coords = grid + (torch.rand(grid.shape, device=dev, generator=g)
                         - 0.5) * 30
    else:
        coords = grid + torch.tensor([40.0, -35.0], device=dev)
    return coords.contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(90, 160, 4, 16), (24, 43, 4, 16),
                                   (135, 240, 4, 16), (37, 83, 3, 8)],
                         ids=["720p", "24x43", "1080p", "37x83"])
def test_coord_lookup_kernels_match_plain(dev, dtype, shape):
    """Kernels D and E from coordinates against their plain versions (the
    coordinate arithmetic as tensor ops, then the explicit lookups) at the
    720p layout, at the 192x344 window's (padding columns) and at one
    whose grid cuts the blocks on both axes (padding queries in rows and
    columns): data and flags equal bit for bit; E
    rewrites exactly the flagged blocks and keeps the others' rows."""
    H1, W1, L, margin = shape
    f1, f2 = _features(dev, H1, W1, 64, seed=9)
    local = corr.build_local_corr(
        f1, f2, 4, L, margin,
        out_dtype=None if dtype == torch.float32 else dtype)
    k = 9
    for kind in ("smooth", "jitter", "saturated"):
        coords = _field(dev, H1, W1, kind)
        n0 = kernels.local_lookup_coords.launches
        got, bad = corr.block_local_lookup_coords(local, coords, k, dtype)
        want, bad_p = corr.block_local_lookup_coords_plain(local, coords, k,
                                                           dtype)
        torch.cuda.synchronize()
        assert kernels.local_lookup_coords.launches == n0 + 1
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got, want), kind
        assert bad.dtype == torch.uint8 and torch.equal(bad, bad_p), kind
        if kind == "jitter" or (H1, W1) == (90, 160):  # 720p: padding
            assert bool(bad.any())                     # queries
        for flags in (bad, torch.zeros_like(bad),
                      (torch.arange(bad.numel(), device=dev) % 3 == 0)
                      .to(torch.uint8).reshape(bad.shape)):
            out_k, out_p = got.clone(), got.clone()
            n0 = kernels.local_lookup_exact_coords.launches
            corr.block_local_lookup_exact_coords(local, coords, k, bad=flags,
                                                 out=out_k)
            corr.block_local_lookup_exact_coords_plain(local, coords, k,
                                                       bad=flags, out=out_p)
            torch.cuda.synchronize()
            assert kernels.local_lookup_exact_coords.launches == n0 + 1
            assert torch.equal(out_k, out_p), kind
            keep = ~flags.bool().any(1)
            assert torch.equal(out_k[keep], got[keep])
        exact = corr.block_local_lookup_exact_coords(local, coords, k)
        assert torch.equal(exact, corr.block_local_lookup_exact_coords_plain(
            local, coords, k))


def test_guarded_lookup_is_two_launches(dev, local_volume):
    """One guarded ``corr_lookup_local_blocked`` on the card is two kernel
    launches, D then E, and nothing else on the device; ``fine=False`` is
    one, E."""
    from torch.profiler import ProfilerActivity, profile

    local = local_volume
    coords = _coords(dev, "jitter")
    # a first trace starts the tracer, which can miss kernels of the
    # window it is started in
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    for fine, names in ((True, ["local_lookup_fine_kernel",
                                "local_lookup_exact_kernel"]),
                        (False, ["local_lookup_exact_kernel"])):
        corr.corr_lookup_local_blocked(local, coords, 4, fine=fine)
        torch.cuda.synchronize()
        # the lookup's kernels queue behind a spin of ~10 ms, so they run
        # well after the trace has started; the spin is not counted
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(20_000_000)
            corr.corr_lookup_local_blocked(local, coords, 4, fine=fine)
            torch.cuda.synchronize()
        seen = [e.name for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "spin" not in e.name]
        assert len(seen) == len(names), seen
        assert all(n in e for n, e in zip(names, seen)), seen


def test_local_wrappers_check_inputs(dev, local_volume):
    local = local_volume
    coords = _coords(dev, "smooth")
    starts, frac = corr._local_level_coords(local, coords)
    vols = local.volumes
    with pytest.raises(TypeError):
        kernels.local_lookup_exact(vols, starts.long(), frac, 9)
    with pytest.raises(ValueError):
        kernels.local_lookup_exact(vols, starts[..., :3].contiguous(),
                                   frac, 9)
    with pytest.raises(ValueError):          # one start set a level
        kernels.local_lookup_exact(vols[:2], starts, frac, 9)
    table = local.consts["table"]
    with pytest.raises(ValueError):          # the table's layout
        kernels.local_lookup_coords(coords, vols[:2], table, 9,
                                    torch.float32)
    with pytest.raises(ValueError):
        kernels.local_lookup_coords(coords[:, :-1].contiguous(), vols, table,
                                    9, torch.float32)
    with pytest.raises(ValueError):          # flags need an output
        kernels.local_lookup_exact_coords(
            coords, vols, table, 9,
            bad=torch.zeros(vols[0].shape[0], len(vols), dtype=torch.uint8,
                            device=dev))
    with pytest.raises(ValueError):          # a flag needs an output
        kernels.local_lookup_exact(vols, starts, frac, 9,
                                   flag=torch.zeros(vols[0].shape[0],
                                                    dtype=torch.uint8,
                                                    device=dev))
    with pytest.raises(ValueError):
        kernels.local_corr_build(torch.zeros(2, 64, 64, device=dev),
                                 [torch.zeros(8, 8, 64, device=dev)],
                                 [(13, 8, 16, 34, 48)], 1, 2, torch.float32)
    with pytest.raises(ValueError):          # bf16 needs D % 64 == 0
        kernels.local_corr_build(
            torch.zeros(1, 128, 96, device=dev, dtype=torch.bfloat16),
            [torch.zeros(8, 8, 96, device=dev, dtype=torch.bfloat16)],
            [(13, 8, 16, 34, 48)], 1, 1, torch.bfloat16)
    with pytest.raises(ValueError):          # tiles are whole window rows
        kernels.local_corr_build(
            torch.zeros(1, 128, 64, device=dev, dtype=torch.bfloat16),
            [torch.zeros(8, 8, 64, device=dev, dtype=torch.bfloat16)],
            [(13, 8, 16, 34, 136)], 1, 1, torch.bfloat16)


# ---------------------------------------------------------------------------
# fused update-block kernels G, H, I
# ---------------------------------------------------------------------------

ULP = 2.0 ** -8            # one bf16 ulp relative to a value's binade top
# the last nine sit one pixel below, at and above the kernels' tiles: G lays
# a map's lines end to end with two zero positions after each and gives a
# CTA 124 output positions (one line of 122 pixels is exactly one tile,
# along W for 1 x W, along H for H x 1); I gives a CTA 10 x 14 pixels
UPDATE_SHAPES = [(16, 32), (19, 28), (8, 16), (90, 160), (5, 3),
                 (1, 121), (1, 122), (1, 123), (121, 1), (122, 1), (123, 1),
                 (9, 13), (10, 14), (11, 15)]
UPDATE_IDS = [f"{h}x{w}" for h, w in UPDATE_SHAPES]


@pytest.fixture(scope="module")
def update_block(dev):
    cfg = traft.RaftConfig(precision="bf16")
    return traft.init_raft_params(cfg, seed=1, device=dev).update_block


def _maps(dev, hw, seed, *channels, dtype=torch.bfloat16, scale=1.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(scale * torch.randn(1, *hw, c, device=dev, generator=g)).to(dtype)
            for c in channels]


def _gru_args(dev, ub, hw, seed, w_scale=1.0):
    (h,) = _maps(dev, hw, seed, 128, dtype=torch.float32)
    x, pre_zr, pre_q = _maps(dev, hw, seed + 1, 128, 256, 128)
    dirs = []
    for names in (("convz1", "convr1", "convq1"),
                  ("convz2", "convr2", "convq2")):
        wzr, bzr = update.gru_taps(ub.gru, names[:2], 128, 128)
        wq, bq = update.gru_taps(ub.gru, names[2:], 128, 128)
        dirs.append(((w_scale * wzr.float()).bfloat16(),
                     (w_scale * wq.float()).bfloat16(), bzr, bq))
    return h, x, pre_zr, pre_q, dirs


@pytest.mark.parametrize("hw", UPDATE_SHAPES, ids=UPDATE_IDS)
@pytest.mark.parametrize("axis", ["w", "h"])
def test_gru_kernel_matches_plain(dev, update_block, hw, axis):
    """Kernel G against its plain version. A flip of one bf16 rounding (z,
    1 - z, q, z * q; gates and q are at most 1) moves the float32 result by
    at most one bf16 ulp of max(1, |h|); a few may coincide, and a flipped
    r * h shifts q's sum slightly. Bound: 4 ulps; at most 2 % of the
    entries differ at all."""
    h, x, pre_zr, pre_q, dirs = _gru_args(dev, update_block, hw, 10,
                                          w_scale=4.0)
    wzr, wq, bzr, bq = dirs[0 if axis == "w" else 1]
    n0 = kernels.fused_gru_update.launches
    got = update.gru_update(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis)
    want = update.gru_update_plain(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis)
    torch.cuda.synchronize()
    assert kernels.fused_gru_update.launches == n0 + 1
    assert got.shape == want.shape == h.shape and got.dtype == torch.float32
    diff = (got - want).abs()
    assert (diff <= 4 * ULP * h.abs().clamp(min=1.0)).all(), diff.max().item()
    assert (diff > 1e-6).float().mean().item() <= 0.02


def test_gru_kernel_border(dev, update_block):
    """Zero padding at the border: impulses at opposite corners, constant
    context. ``r * h`` outside the image is zero, not ``sigmoid(bias) * 0``
    read from a neighbouring line."""
    hw = (8, 16)
    h = torch.zeros(1, *hw, 128, device=dev)
    h[0, 0, 0] = 1.0
    x = torch.zeros(1, *hw, 128, device=dev, dtype=torch.bfloat16)
    x[0, -1, -1] = 1.0
    pre_zr = torch.ones(1, *hw, 256, device=dev, dtype=torch.bfloat16)
    pre_q = torch.ones(1, *hw, 128, device=dev, dtype=torch.bfloat16)
    _, _, _, _, dirs = _gru_args(dev, update_block, hw, 11, w_scale=4.0)
    for axis, (wzr, wq, bzr, bq) in zip("wh", dirs):
        got = update.gru_update(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis)
        want = update.gru_update_plain(h, x, pre_zr, pre_q, wzr, wq, bzr, bq,
                                       axis)
        assert (got - want).abs().max().item() <= 4 * ULP


@pytest.mark.parametrize("hw", UPDATE_SHAPES, ids=UPDATE_IDS)
def test_motion_encoder_kernel_matches_plain(dev, update_block, hw):
    """Kernel H against its plain version: bf16 output, one ulp (2^-7
    relative bounds it for any mantissa) plus what flipped first-stage
    activations move the second sum by (2^-8 of the output's scale); lanes
    126-127 are bf16(flow) exactly."""
    cor1, flo1 = _maps(dev, hw, 12, 256, 128)
    cor1, flo1 = cor1.relu(), flo1.relu()
    (flow,) = _maps(dev, hw, 13, 2, dtype=torch.float32, scale=3.0)
    params = [p * 4 if p.dtype == torch.bfloat16 else p
              for p in update.motion_encoder_params(update_block.encoder)]
    n0 = kernels.motion_encoder_tail.launches
    got = update.motion_encoder_tail(cor1, flo1, flow, *params)
    want = update.motion_encoder_tail_plain(cor1, flo1, flow, *params)
    torch.cuda.synchronize()
    assert kernels.motion_encoder_tail.launches == n0 + 1
    assert got.shape == want.shape == (1, *hw, 128)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got[..., 126:], flow.bfloat16())
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    assert scale > 0.5
    diff = (got - want).abs()
    assert (diff <= 2 * ULP * want.abs() + ULP * scale).all()
    assert (diff > 0).float().mean().item() <= 0.02


def _tail_case(dev, ub, hw, seed):
    cor1, flo1 = _maps(dev, hw, seed, 256, 128)
    (flow,) = _maps(dev, hw, seed + 1, 2, dtype=torch.float32, scale=3.0)
    params = [p * 4 if p.dtype == torch.bfloat16 else p
              for p in update.motion_encoder_params(ub.encoder)]
    return cor1.relu(), flo1.relu(), flow, params


def _check_tail(got, want, mid, want_mid):
    """Kernel H's result and its first launch's map against their plain
    versions: each bf16 value within one ulp (2^-7 relative bounds it for
    any mantissa) plus one ulp of the map's scale (2^-8 of its largest
    value), which covers a sum near zero whose sign the order of the
    float32 sums decides (relu then keeps one value and zeroes the other)
    and, in the result, flipped first-stage activations; at most 2 % of
    the entries differ."""
    for g, w, what in ((mid, want_mid, "stage 1"), (got, want, "result")):
        g, w = g.float(), w.float()
        scale = w.abs().max().item()
        assert scale > 0.5, what
        diff = (g - w).abs()
        assert (diff <= 2 * ULP * w.abs() + ULP * scale).all(), (
            what, diff.max().item(), scale)
        assert (diff > 0).float().mean().item() <= 0.02, what


# kernel H gives a CTA 8 x 16 output pixels in both launches: one row or
# column short of a tile, exactly one, one over, and the 720p loop shape
# with a ragged last tile row (90 = 11 * 8 + 2)
TAIL_SHAPES = [(7, 16), (8, 15), (8, 16), (9, 17), (1, 1), (3, 200),
               (17, 33), (90, 160), (89, 159)]


@pytest.mark.parametrize("hw", TAIL_SHAPES,
                         ids=[f"{h}x{w}" for h, w in TAIL_SHAPES])
def test_motion_encoder_kernel_stages(dev, update_block, hw):
    """Kernel H's two launches at the edges of its tiles: the first
    launch's map ``cat(cor2, flo2)`` (read back through ``mid``) against
    ``motion_encoder_stage1_plain``, the result against
    ``motion_encoder_stage2_plain`` of the plain map."""
    cor1, flo1, flow, params = _tail_case(dev, update_block, hw, 17)
    wc2, bc2, wf2, bf2, wcv, bcv = params
    mid = torch.full((1, *hw, 256), float("nan"), device=dev,
                     dtype=torch.bfloat16)
    n0 = kernels.motion_encoder_tail.launches
    got = kernels.motion_encoder_tail(cor1, flo1, flow, *params, mid=mid)
    want_mid = update.motion_encoder_stage1_plain(cor1, flo1, wc2, bc2, wf2,
                                                  bf2)
    want = update.motion_encoder_stage2_plain(want_mid, flow, wcv, bcv)
    torch.cuda.synchronize()
    assert kernels.motion_encoder_tail.launches == n0 + 1
    assert torch.equal(got[..., 126:], flow.bfloat16())
    _check_tail(got, want, mid, want_mid)


def test_motion_encoder_kernel_positive_bias_border(dev, update_block):
    """Every first-stage bias positive, so relu(bias) > 0 wherever the
    first stage has no signal: outside the image the second launch must
    still read zeros, and the border pixels must match the plain version's
    zero padding of the activations."""
    hw = (13, 21)
    cor1, flo1, flow, params = _tail_case(dev, update_block, hw, 19)
    wc2, bc2, wf2, bf2, wcv, bcv = params
    bc2, bf2 = bc2.abs() + 0.5, bf2.abs() + 0.5
    cor1[:, :, :4], flo1[:, 4:] = 0, 0      # no signal: relu(bias) alone
    mid = torch.empty((1, *hw, 256), device=dev, dtype=torch.bfloat16)
    got = kernels.motion_encoder_tail(cor1, flo1, flow, wc2, bc2, wf2, bf2,
                                      wcv, bcv, mid=mid)
    want_mid = update.motion_encoder_stage1_plain(cor1, flo1, wc2, bc2, wf2,
                                                  bf2)
    want = update.motion_encoder_stage2_plain(want_mid, flow, wcv, bcv)
    assert (want_mid[0, 5:, :, 192:] > 0).all()
    _check_tail(got, want, mid, want_mid)
    # the same map padded with relu(bias) = bf16(bias) instead of zeros
    # gives border pixels beyond the tolerance
    rb = torch.cat([bc2, bf2]).to(torch.bfloat16)
    padded = F.pad(want_mid, (0, 0, 1, 1, 1, 1))
    padded[:, 0] = padded[:, -1] = rb
    padded[:, :, 0] = padded[:, :, -1] = rb
    wrong = update.motion_encoder_stage2_plain(
        padded, F.pad(flow, (0, 0, 1, 1, 1, 1)), wcv, bcv)[:, 1:-1, 1:-1]
    w = want.float()
    assert ((wrong.float() - w).abs()
            > 2 * ULP * w.abs() + ULP * w.abs().max()).any()


@pytest.mark.parametrize("hw", UPDATE_SHAPES, ids=UPDATE_IDS)
def test_flow_head_kernel_matches_plain(dev, update_block, hw):
    """Kernel I against its plain version: the float32 delta differs by
    accumulation order and by the few hidden activations whose bf16 rounding
    flipped, each weighted by one tap: 2^-8 of the delta's scale bounds it."""
    (net,) = _maps(dev, hw, 14, 128, dtype=torch.float32)
    w1, b1, w2, b2 = update.flow_head_params(update_block.flow_head)
    w1, w2 = w1 * 4, w2 * 4
    n0 = kernels.flow_head.launches
    got = update.flow_head(net, w1, b1, w2, b2)
    want = update.flow_head_plain(net, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert kernels.flow_head.launches == n0 + 1
    assert got.shape == want.shape == (1, *hw, 2)
    assert got.dtype == torch.float32
    scale = want.abs().max().item()
    assert scale > 0.1
    assert (got - want).abs().max().item() <= ULP * scale


def test_update_border_zero_padding(dev, update_block):
    """First-stage activations outside the image are zero before the second
    convolution (not relu(bias)): zero inputs make every first-stage value
    relu(bias), and the border pixels then differ from the interior."""
    hw = (16, 32)
    cor1 = torch.zeros(1, *hw, 256, device=dev, dtype=torch.bfloat16)
    flo1 = torch.zeros(1, *hw, 128, device=dev, dtype=torch.bfloat16)
    flow = torch.zeros(1, *hw, 2, device=dev)
    params = update.motion_encoder_params(update_block.encoder)
    got = update.motion_encoder_tail(cor1, flo1, flow, *params).float()
    want = update.motion_encoder_tail_plain(cor1, flo1, flow, *params).float()
    assert (got - want).abs().max().item() <= 2 * ULP * want.abs().max().item()
    assert not torch.equal(want[0, 0, 0], want[0, 8, 16])
    net = torch.zeros(1, *hw, 128, device=dev)
    fh = update.flow_head_params(update_block.flow_head)
    got = update.flow_head(net, *fh)
    want = update.flow_head_plain(net, *fh)
    assert (got - want).abs().max().item() <= ULP * want.abs().max().item()
    assert not torch.equal(want[0, 0, 0], want[0, 8, 16])


def test_update_wrappers_check_inputs(dev, update_block):
    hw = (8, 16)
    h, x, pre_zr, pre_q, dirs = _gru_args(dev, update_block, hw, 15)
    wzr, wq, bzr, bq = dirs[0]
    with pytest.raises(TypeError):           # the state is float32
        kernels.fused_gru_update(h.bfloat16(), x, pre_zr, pre_q, wzr, wq, bzr,
                                 bq, "w")
    with pytest.raises(ValueError):          # channels-minor and contiguous
        kernels.fused_gru_update(h.permute(0, 2, 1, 3), x, pre_zr, pre_q, wzr,
                                 wq, bzr, bq, "w")
    with pytest.raises(ValueError):
        kernels.fused_gru_update(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, "x")
    with pytest.raises(ValueError):          # taps of the other convolution
        kernels.fused_gru_update(h, x, pre_zr, pre_q, wq, wzr, bzr, bq, "w")
    with pytest.raises(TypeError):
        kernels.flow_head(h.bfloat16(),
                          *update.flow_head_params(update_block.flow_head))
    with pytest.raises(ValueError):          # a CPU tensor never launches
        kernels.flow_head(h.cpu(),
                          *update.flow_head_params(update_block.flow_head))


@pytest.mark.parametrize("flags", [dict(gru_fused=True),
                                   dict(tail_fused=True),
                                   dict(gru_fused=True, tail_fused=True)],
                         ids=["gru", "tail", "both"])
def test_fused_forward_on_card_matches_cpu(dev, flags):
    """The fused forward on the card (kernels G, I) against the CPU path
    (their plain versions), 64x96, bf16: 0.05 px, the bound the unfused
    bf16 forward is held to between card and CPU."""
    g = torch.Generator().manual_seed(5)
    img1 = torch.rand(1, 64, 96, 3, generator=g) * 255
    img2 = torch.roll(img1, shifts=(2, 3), dims=(1, 2))
    cfg = traft.RaftConfig(iters=4, corr_impl="local", local_margin=8,
                           precision="bf16", **flags)
    outs = []
    for d in ("cpu", dev):
        model = traft.init_raft_params(cfg, seed=0, device=d)
        n_g, n_i = kernels.fused_gru_update.launches, kernels.flow_head.launches
        outs.append(traft.weighted_raft_forward(
            model, cfg, img1.to(d), img2.to(d))["flow_up"].cpu())
    assert kernels.fused_gru_update.launches - n_g == (
        8 if cfg.gru_fused else 0)
    assert kernels.flow_head.launches - n_i == (4 if cfg.tail_fused else 0)
    assert (outs[0] - outs[1]).abs().max().item() <= 0.05


def test_fused_motion_encoder_module(dev, update_block):
    """``BasicMotionEncoder.forward(fused=True)`` reaches kernel H and
    agrees with the unfused module to bf16 rounding."""
    g = torch.Generator(device=dev).manual_seed(16)
    corr_feat = torch.randn(1, 324, 24, 40, device=dev, generator=g)
    flow = 3 * torch.randn(1, 2, 24, 40, device=dev, generator=g)
    n0 = kernels.motion_encoder_tail.launches
    with layers.precision_scope("bf16"), torch.no_grad():
        got = update_block.encoder(flow, corr_feat, fused=True)
        want = update_block.encoder(flow, corr_feat)
    assert kernels.motion_encoder_tail.launches == n0 + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    assert diff.max().item() <= 4 * ULP * want.float().abs().max().item()
    with pytest.raises(ValueError), torch.no_grad():
        update_block.encoder(flow, corr_feat, fused=True)   # float32 mode
