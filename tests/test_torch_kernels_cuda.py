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
in bf16 ulps of the rounded quantity. Kernel J (the bf16 weight head) is
held to a float64 evaluation at its rounding points, beside the unfused
cuDNN chain it replaces.
"""

import copy
import math

import pytest
import torch
import torch.nn.functional as F

from woft_tpu_torch.device import resolve_device
from woft_tpu_torch.models import corr, layers, loop_graph, update
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models import weight_head as whead
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("radius,levels,hw", LOOKUP_GRID, ids=LOOKUP_IDS)
def test_lookup_backward_kernel_matches_plain(dev, radius, levels, hw,
                                              dtype):
    """Kernel B' against autograd through the plain lookup (levels widened
    to float32, each gradient rounded once to the level's dtype): float32
    sums in another order, so 1e-5 of the largest magnitude, plus one bf16
    ulp of the value for bf16 levels."""
    pyr, coords = _lookup_case(dev, levels, hw)
    pyr = [p.to(dtype).contiguous() for p in pyr]
    flat = coords.reshape(-1, 2).contiguous()
    k = 2 * radius + 1
    g = torch.randn(flat.shape[0], levels * k * k, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2))
    n0 = kernels.corr_pyramid_lookup_backward.launches
    d_lv, d_c = kernels.corr_pyramid_lookup_backward(pyr, flat, g, radius)
    p_lv, p_c = corr.corr_lookup_backward_plain(pyr, flat, g, radius)
    torch.cuda.synchronize()
    assert kernels.corr_pyramid_lookup_backward.launches == n0 + 1
    for a, b in zip(d_lv, p_lv):
        assert a.dtype == dtype and a.shape == b.shape
        a, b = a.float(), b.float()
        tol = 1e-5 * b.abs().max().item()
        if dtype == torch.bfloat16:
            tol = tol + torch.exp2(torch.floor(torch.log2(
                b.abs().clamp(min=1e-30))) - 7)
        assert ((a - b).abs() <= tol).all()
    assert (d_c - p_c).abs().max().item() <= 1e-5 * p_c.abs().max().item()
    assert d_c[:2].abs().max().item() == 0.0     # wholly outside


def test_lookup_function_launches_b_and_b_prime(dev):
    """Under grad, ``corr_lookup`` goes through its ``autograd.Function``:
    one launch of B forward, one of B' backward."""
    pyr, coords = _lookup_case(dev, 4, (23, 37))
    pyr = [p.requires_grad_() for p in pyr]
    c = coords.clone().requires_grad_()
    n_b = kernels.corr_pyramid_lookup.launches
    n_bb = kernels.corr_pyramid_lookup_backward.launches
    out = corr.corr_lookup(pyr, c, 4)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert kernels.corr_pyramid_lookup.launches == n_b + 1
    assert kernels.corr_pyramid_lookup_backward.launches == n_bb + 1
    lv = [p.detach().requires_grad_() for p in pyr]
    c2 = coords.clone().requires_grad_()
    corr.corr_lookup_plain(lv, c2, 4).square().sum().backward()
    for a, b in zip(pyr, lv):
        assert (a.grad - b.grad).abs().max() <= 1e-5 * b.grad.abs().max()
    assert (c.grad - c2.grad).abs().max() <= 1e-5 * c2.grad.abs().max()


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


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.bfloat16, 2.0 ** -7)],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(90, 160, 4, 16), (37, 83, 3, 8)],
                         ids=["720p", "37x83"])
def test_band_kernels_match_plain_and_whole_grid(dev, dtype, rtol, shape):
    """Kernels C, D and E on a band of the grid (blocks b0 .. b0 + nb - 1,
    the spatially sharded forward's share of a rank) against their plain
    versions at that b0 (C to the tolerance of two summation orders, D and
    E bit for bit) and against the matching rows of the whole-grid launch
    (bit for bit); C's kept parameter block is keyed on b0."""
    H1, W1, L, margin = shape
    f1, f2 = _features(dev, H1, W1, 64, seed=9)
    whole = corr.build_local_corr(
        f1, f2, 4, L, margin,
        out_dtype=None if dtype == torch.float32 else dtype)
    meta = whole.meta
    nbh, nbw = meta["nbh"], meta["nbw"]
    b0 = nbh * nbw // 2
    rows = slice(b0, nbh * nbw)
    f1b = corr._to_blocked(f1.reshape(-1, 64), meta).reshape(
        nbh * nbw, 128, 64)[rows].to(dtype).contiguous()
    levels = [f2]
    while len(levels) < L:
        levels.append(warp.avg_pool2d(levels[-1]))
    levels = [lv[0].to(dtype).contiguous() for lv in levels]
    vols = corr.block_local_corr_levels(f1b, levels, meta["levels"], nbh,
                                        nbw, dtype, b0)
    for v, w, lv, d in zip(vols, whole.volumes, levels, meta["levels"]):
        assert torch.equal(v, w[rows])
        want = corr.block_local_corr_plain(f1b, lv, d, nbh, nbw, dtype,
                                           b0).float()
        assert ((v.float() - want).abs() <= 2e-5 + rtol * want.abs()).all()
    # the same pointers at b0 = 0: a kept plan of the band must not serve
    at0 = corr.block_local_corr_levels(f1b, levels, meta["levels"], nbh,
                                       nbw, dtype)
    want0 = corr.block_local_corr_plain(f1b, levels[0], meta["levels"][0],
                                        nbh, nbw, dtype).float()
    assert ((at0[0].float() - want0).abs() <= 2e-5 + rtol
            * want0.abs()).all()
    band = corr.LocalCorrVolumes(vols, meta, b0)
    for kind in ("smooth", "jitter", "saturated"):
        coords = _field(dev, H1, W1, kind)
        d_all, bad_all = corr.block_local_lookup_coords(whole, coords, 9,
                                                        dtype)
        got, bad = corr.block_local_lookup_coords(band, coords, 9, dtype)
        want, bad_p = corr.block_local_lookup_coords_plain(band, coords, 9,
                                                           dtype)
        assert torch.equal(got, want) and torch.equal(bad, bad_p), kind
        assert torch.equal(got, d_all[rows]), kind
        assert torch.equal(bad, bad_all[rows]), kind
        e_all = d_all.clone()
        corr.block_local_lookup_exact_coords(whole, coords, 9, bad=bad_all,
                                             out=e_all)
        out_k, out_p = got.clone(), got.clone()
        corr.block_local_lookup_exact_coords(band, coords, 9, bad=bad,
                                             out=out_k)
        corr.block_local_lookup_exact_coords_plain(band, coords, 9, bad=bad,
                                                   out=out_p)
        assert torch.equal(out_k, out_p) and torch.equal(out_k,
                                                         e_all[rows]), kind


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

UPDATE_KERNELS = ("fused_gru_update", "motion_encoder_tail", "flow_head")


def _launches():
    return {fn.__name__: n for fn, n in kernels.launch_counters().items()}


ULP = 2.0 ** -8            # one bf16 ulp relative to a value's binade top
# the last nine sit one pixel below, at and above the kernels' tiles: G lays
# a map's lines end to end with two zero positions after each and gives a
# CTA 124 output positions (one line of 122 pixels is exactly one tile,
# along W for 1 x W, along H for H x 1); I gives a CTA 10 x 14 pixels;
# 135 x 240 is the 1080p loop's grid (ragged against every kernel's tile)
UPDATE_SHAPES = [(16, 32), (19, 28), (8, 16), (90, 160), (5, 3),
                 (1, 121), (1, 122), (1, 123), (121, 1), (122, 1), (123, 1),
                 (9, 13), (10, 14), (11, 15), (135, 240)]
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


# G's float32 form against its plain version: both sum the same 1,280
# float32 products in another order and then round alike, so they differ by
# a few float32 ulps of the state (6.3e-7 at 720p on the card; the unfused
# cuDNN path there matched the kernel bit for bit); a tap out of place moves
# the state by 0.7
GRU_F32_TOL = 1e-5
# 720p, a line of one CTA's 124 positions and one more on each axis, a map
# smaller than the 5-tap window, a ragged one
GRU_F32_SHAPES = [(90, 160), (1, 124), (1, 125), (124, 1), (125, 1), (5, 3),
                  (19, 28)]


@pytest.fixture(scope="module")
def update_block_f32(dev):
    return traft.init_raft_params(traft.RaftConfig(), seed=1,
                                  device=dev).update_block


def _gru_f32_args(dev, ub, hw, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    h, x, inp = (torch.randn(1, 128, *hw, device=dev, generator=g)
                 for _ in range(3))
    h, x, inp = torch.tanh(h), torch.relu(x), torch.relu(inp)
    with layers.precision_scope("highest"), torch.no_grad():
        pre = update.LoopRoute("f32").context(ub.gru, inp)
    return update.nhwc(h), update.nhwc(x), pre


@pytest.mark.parametrize("hw", GRU_F32_SHAPES,
                         ids=[f"{h}x{w}" for h, w in GRU_F32_SHAPES])
@pytest.mark.parametrize("axis", ["w", "h"])
def test_gru_f32_kernel_matches_plain(dev, update_block_f32, hw, axis):
    """Kernel G's float32 form against its plain version on the card's
    tensors (full float32 products: TF32 is off)."""
    h, x, pre = _gru_f32_args(dev, update_block_f32, hw, 20)
    args = pre[0 if axis == "w" else 1]
    assert args[-1] == axis
    n0 = kernels.fused_gru_update_f32.launches
    with torch.no_grad():
        got = update.gru_update_f32(h, x, *args)
        want = update.gru_update_f32_plain(h, x, *args)
    torch.cuda.synchronize()
    assert kernels.fused_gru_update_f32.launches == n0 + 1
    assert got.shape == want.shape == h.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= GRU_F32_TOL
    assert want.abs().max().item() > 0.1


def test_gru_f32_kernel_border(dev, update_block_f32):
    """Zero padding at the border on both axes: impulses at opposite
    corners, a constant context; ``r * h`` outside the image is zero, not
    a neighbouring line's."""
    hw = (8, 16)
    h = torch.zeros(1, *hw, 128, device=dev)
    h[0, 0, 0] = 1.0
    x = torch.zeros(1, *hw, 128, device=dev)
    x[0, -1, -1] = 1.0
    inp = torch.ones(1, 128, *hw, device=dev)
    with layers.precision_scope("highest"), torch.no_grad():
        pre = update.LoopRoute("f32").context(update_block_f32.gru, inp)
        for args in pre:
            got = update.gru_update_f32(h, x, *args)
            want = update.gru_update_f32_plain(h, x, *args)
            assert (got - want).abs().max().item() <= GRU_F32_TOL
            assert not torch.allclose(want[0, 0, 0], want[0, 4, 8])


def test_woft_step_720p_runs_the_float32_gru(dev, monkeypatch):
    """One ``WOFT.py`` tracker step on a 720p frame of the walk, on the
    trained weights: 24 launches of G's float32 form a flow (12 iterations,
    2 directions), and its H within 1e-3 px (the card-against-CPU flow
    bound of 12 float32 iterations) of the unfused route's H."""
    import sys

    import numpy as np

    sys.path.insert(0, str(kernels.CSRC.parents[1]))
    import chip_smoke
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.tracker import WOFTTracker

    template, frames, _ = chip_smoke.walk(720, 1280, dev, n=1)
    mask, corners = chip_smoke.centred_mask(720, 1280, 0.5)
    config = str(kernels.CSRC.parent / "configs" / "WOFT.py")

    def step():
        tracker = WOFTTracker(load_config(config))
        tracker.init(template, mask)
        n0 = kernels.fused_gru_update_f32.launches
        H, meta = tracker.track(frames[0])
        torch.cuda.synchronize()
        flows = 1 + (not meta.global_H_success)
        return np.asarray(H), flows, kernels.fused_gru_update_f32.launches - n0

    H, flows, n = step()
    assert n == 24 * flows
    with monkeypatch.context() as m:
        m.setattr(update, "loop_route",
                  lambda *a, **k: update.LoopRoute("unfused"))
        H_unfused, _, n_unfused = step()
    assert n_unfused == 0
    assert chip_smoke.h_diff_px(H, H_unfused, corners) <= 1e-3


def test_training_step_keeps_the_unfused_gru(dev):
    """A whole-net training step (``train_forward`` and its backward, every
    parameter trained) launches G's float32 form 0 times and gives the GRU
    its gradient."""
    cfg = traft.RaftConfig(iters=2)
    model = traft.init_raft_params(cfg, seed=0, device=dev)
    g = torch.Generator().manual_seed(5)
    img1 = (torch.rand(1, 64, 96, 3, generator=g) * 255).to(dev)
    img2 = torch.roll(img1, shifts=(2, 3), dims=(1, 2))
    n0 = kernels.fused_gru_update_f32.launches
    out = traft.train_forward(model, cfg, img1, img2)
    out["flow_up"].abs().mean().backward()
    torch.cuda.synchronize()
    assert kernels.fused_gru_update_f32.launches == n0
    assert model.update_block.gru.convz1.weight.grad.abs().sum().item() > 0


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
# column short of a tile, exactly one, one over, the 720p loop shape with a
# ragged last tile row (90 = 11 * 8 + 2) and the 1080p one (135 = 16 * 8 +
# 7)
TAIL_SHAPES = [(7, 16), (8, 15), (8, 16), (9, 17), (1, 1), (3, 200),
               (17, 33), (90, 160), (89, 159), (135, 240)]


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
    """The fused forward against the CPU path under the flags (their plain
    versions of G, I), 64x96, bf16: 0.05 px, the bound the unfused bf16
    forward is held to between card and CPU. The card takes its own route
    whatever the flags: G twice, H and I once an iteration."""
    g = torch.Generator().manual_seed(5)
    img1 = torch.rand(1, 64, 96, 3, generator=g) * 255
    img2 = torch.roll(img1, shifts=(2, 3), dims=(1, 2))
    cfg = traft.RaftConfig(iters=4, corr_impl="local", local_margin=8,
                           precision="bf16", **flags)
    outs = []
    for d in ("cpu", dev):
        model = traft.init_raft_params(cfg, seed=0, device=d)
        n0 = _launches()
        outs.append(traft.weighted_raft_forward(
            model, cfg, img1.to(d), img2.to(d))["flow_up"].cpu())
    n1 = _launches()
    assert {k: n1[k] - n0[k] for k in UPDATE_KERNELS} == {
        "fused_gru_update": 8, "motion_encoder_tail": 4, "flow_head": 4}
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




@pytest.mark.parametrize("precision", ["bf16", "highest"])
def test_block_local_loop_graph_matches_eager(dev, precision):
    """The block-local forward's volume and refinement loop replayed from a
    CUDA graph (``models/loop_graph.py``): the first forward of a shape runs
    eagerly and captures, later ones replay. A replay's outputs equal, bit
    for bit, an eager forward of a copy of the model on the same pair (the
    same kernels on the same operands), also after a further replay has
    overwritten the graph's buffers; the kernel counters advance by what
    the eager forward launches."""
    cfg = traft.RaftConfig(corr_impl="local", precision=precision, iters=3)
    model = traft.init_raft_params(cfg, seed=2, device=dev)
    twin = copy.deepcopy(model)
    g = torch.Generator().manual_seed(9)
    imgs = [(torch.rand(1, 256, 448, 3, generator=g) * 255).to(dev)
            for _ in range(4)]
    cells = torch.arange(0, 32 * 56, 7, device=dev)

    def forward(m, frame):
        n0 = _launches()
        out = traft.weighted_raft_forward(m, cfg, imgs[0], frame,
                                          sparse_weight_head=True)
        w = out.pop("weight_head_at")(cells)
        torch.cuda.synchronize()
        n1 = _launches()
        return ({k: v.clone() for k, v in out.items()}, w,
                {k: n1[k] - n0[k] for k in n0 if n1[k] != n0[k]})

    forward(model, imgs[1])
    assert loop_graph.captured(model) == 1
    got, w_got, n_got = forward(model, imgs[2])
    forward(model, imgs[3])
    assert loop_graph.captured(model) == 1
    want, w_want, n_want = forward(twin, imgs[2])
    assert n_got == n_want
    assert n_got["local_corr_build"] == 1
    assert n_got["local_lookup_coords"] == cfg.iters + 1
    # the loop's route: G, H (its second launch by programmatic dependent
    # launch) and I in bf16; G's float32 form in 'highest'
    bf16 = precision == "bf16"
    assert n_got.get("fused_gru_update", 0) == (2 * cfg.iters if bf16 else 0)
    assert n_got.get("motion_encoder_tail", 0) == (cfg.iters if bf16 else 0)
    assert n_got.get("flow_head", 0) == (cfg.iters if bf16 else 0)
    assert n_got.get("fused_gru_update_f32", 0) == (0 if bf16
                                                     else 2 * cfg.iters)
    for key in ("flow", "flow_up", "up_mask", "mean_response"):
        assert torch.equal(got[key], want[key]), key
    assert torch.equal(w_got, w_want)
    assert got["flow"].abs().max().item() > 0


def test_block_local_loop_graph_keys(dev):
    """A new shape or new update-block weights capture a graph of their own
    (at most ``MAX_GRAPHS`` a model); a forward that records a gradient,
    and the all-pairs path, run eagerly."""
    cfg = traft.RaftConfig(corr_impl="local", precision="bf16", iters=2)
    model = traft.init_raft_params(cfg, seed=3, device=dev)
    g = torch.Generator().manual_seed(10)

    def pair(h, w):
        return [(torch.rand(1, h, w, 3, generator=g) * 255).to(dev)
                for _ in range(2)]

    for hw in [(64, 96), (64, 96), (96, 64)]:
        traft.weighted_raft_forward(model, cfg, *pair(*hw))
    assert loop_graph.captured(model) == 2
    with torch.no_grad():
        for p in model.update_block.parameters():
            p.data = p.data.clone()
    traft.weighted_raft_forward(model, cfg, *pair(64, 96))
    assert loop_graph.captured(model) == 3
    for hw in [(128, 96), (96, 128), (128, 128)]:
        traft.weighted_raft_forward(model, cfg, *pair(*hw))
    assert loop_graph.captured(model) == loop_graph.MAX_GRAPHS
    dense = traft.RaftConfig(precision="bf16", iters=2)
    dense_model = traft.init_raft_params(dense, seed=3, device=dev)
    traft.weighted_raft_forward(dense_model, dense, *pair(64, 96))
    assert loop_graph.captured(dense_model) == 0
    trained = traft.RaftConfig(corr_impl="local", iters=2)
    trained_model = traft.init_raft_params(trained, seed=3, device=dev)
    traft.train_forward(trained_model, trained, *pair(64, 96))
    assert loop_graph.captured(trained_model) == 0


# name: (RaftConfig overrides, frame pairs, training forward, G, H and I
# launches an iteration)
CARD_ROUTE_CASES = {
    "bf16-local": (dict(precision="bf16", corr_impl="local"), 1, False,
                   (2, 1, 1)),
    "bf16-dense": (dict(precision="bf16"), 1, False, (2, 1, 1)),
    "bf16-flags": (dict(precision="bf16", corr_impl="local",
                        gru_fused=True, tail_fused=True), 1, False,
                   (2, 1, 1)),
    "bf16-batch": (dict(precision="bf16"), 2, False, (0, 0, 0)),
    "bf16-train": (dict(precision="bf16"), 1, True, (0, 0, 0)),
    "highest": (dict(corr_impl="local"), 1, False, (0, 0, 0)),
    "default": (dict(precision="default"), 1, False, (0, 0, 0)),
    "small-bf16": (dict(precision="bf16", small=True), 1, False, (0, 0, 0)),
}


@pytest.mark.parametrize("case", list(CARD_ROUTE_CASES))
def test_card_route_launches(dev, case):
    """The bf16 loop's route on the card, by what a forward observes: one
    frame pair in bf16 mode with no gradient launches G twice, H and I
    once an iteration, with or without the flags, graphed (block-local) or
    eager (the pyramid); a batch, a training forward, float32, 'default'
    and RAFT-small launch none of them."""
    overrides, B, train, per_iter = CARD_ROUTE_CASES[case]
    cfg = traft.RaftConfig(iters=2, **overrides)
    model = traft.init_raft_params(cfg, seed=4, device=dev)
    g = torch.Generator().manual_seed(12)
    img1 = (torch.rand(B, 64, 96, 3, generator=g) * 255).to(dev)
    img2 = torch.roll(img1, shifts=(2, 3), dims=(1, 2))
    n0 = _launches()
    if train:
        traft.train_forward(model, cfg, img1, img2)["flow_up"].sum().backward()
    else:
        traft.weighted_raft_forward(model, cfg, img1, img2)
    torch.cuda.synchronize()
    n1 = _launches()
    assert tuple(n1[k] - n0[k] for k in UPDATE_KERNELS) == tuple(
        cfg.iters * n for n in per_iter)


def test_card_route_graph_1080p_matches_eager(dev):
    """The card's bf16 route at the 1080p loop grid (135 x 240 cells), 12
    iterations, block-local: replayed from its CUDA graph (H's second
    launch captured with its programmatic dependent launch) it equals, bit
    for bit, an eager forward of a copy of the model; 24 launches of G and
    12 each of H and I a flow, eager or replayed."""
    cfg = traft.RaftConfig(corr_impl="local", precision="bf16")
    model = traft.init_raft_params(cfg, seed=6, device=dev)
    twin = copy.deepcopy(model)
    g = torch.Generator().manual_seed(13)
    imgs = [(torch.rand(1, 1080, 1920, 3, generator=g) * 255).to(dev)
            for _ in range(3)]

    def forward(m, frame):
        n0 = _launches()
        out = traft.weighted_raft_forward(m, cfg, imgs[0], frame)
        torch.cuda.synchronize()
        n1 = _launches()
        return ({k: out[k].clone() for k in ("flow", "flow_up")},
                tuple(n1[k] - n0[k] for k in UPDATE_KERNELS))

    assert forward(model, imgs[1])[1] == (24, 12, 12)
    assert loop_graph.captured(model) == 1
    got, n_got = forward(model, imgs[2])
    want, n_want = forward(twin, imgs[2])
    assert n_got == n_want == (24, 12, 12)
    assert got["flow"].shape[1:3] == (135, 240)
    for key in got:
        assert torch.equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# kernel J: the bf16 weight head
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weight_head_case(dev):
    head = traft.init_raft_params(traft.RaftConfig(precision="bf16"), seed=0,
                                  device=dev).weight_head
    return head, whead.head_params(head)


def _head_rows(dev, M, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(M)
    corr = (2.0 * torch.randn(M, 324, device=dev, generator=g)).to(dtype)
    return corr, torch.randn(M, device=dev, generator=g)


# largest logit gap from float64: J's against the cuDNN chain's (read
# 1.05-1.38x; see the test below)
HEAD_MAX_GAP_RATIO = 2.0


@pytest.mark.parametrize("M,dtype", [(1, torch.bfloat16),
                                     (63, torch.bfloat16),
                                     (4500, torch.bfloat16),
                                     (4501, torch.float32),
                                     (32400, torch.bfloat16)],
                         ids=["1", "63", "4500", "4501-f32", "32400"])
def test_weight_head_kernel_against_float64(dev, weight_head_case, M, dtype):
    """Kernel J and the unfused cuDNN chain against a float64 evaluation at
    the same rounding points (``weight_head_plain(dtype=float64)``), on the
    seeded head: J's median logit gap is at most the chain's, and its
    largest at most twice the chain's. M = 4,501 (odd: the last pair holds
    one row) takes float32 rows, as the dense pyramid's lookup gives them.

    Readings on an H100, J / chain: M = 4,500 median 4.81e-9 / 3.54e-8,
    largest 1.55e-5 / 1.47e-5; M = 4,501 largest 1.46e-5 / 1.06e-5; M =
    32,400 median 4.79e-9 / 4.01e-8, largest 2.05e-5 / 1.96e-5 (logits up
    to 0.070). The largest gap is the row where some activation's sum lies
    within float32 rounding of a bf16 boundary: float64 rounds it one way,
    each float32 order its own way, and one flipped activation moves a
    logit by up to ~1e-5. Which rows flip is a matter of the order: the
    plain version summed in float32 by cuBLAS reads the chain's largest to
    the digit at 4,500 and 32,400, and J's reads 1.05-1.38x of it, so the
    largest gap is bounded at twice the chain's, while the median, which
    counts the flips, is held to the chain's. J without its float32
    promotion of the tensor cores' partial sums read a median of 2.12e-7,
    5x the chain's."""
    head, (taps, consts) = weight_head_case
    corr_rows, mean = _head_rows(dev, M, dtype)
    with torch.no_grad():
        n0 = kernels.weight_head.launches
        got = whead.weight_head(corr_rows, mean, taps, consts)
        torch.cuda.synchronize()
        assert kernels.weight_head.launches == n0 + 1
        f64 = whead.weight_head_plain(corr_rows, mean, taps, consts,
                                      dtype=torch.float64)
        with layers.precision_scope("bf16"):
            lib = traft.weight_head_chain(
                head, corr_rows.reshape(1, 1, M, 9, 9, 4),
                mean.reshape(1, 1, M)).reshape(M)
    assert got.shape == (M,) and got.dtype == torch.float32
    gap = (got.double() - f64).abs()
    gap_lib = (lib.double() - f64).abs()
    assert gap.median().item() <= gap_lib.median().item()
    assert gap.max().item() <= HEAD_MAX_GAP_RATIO * gap_lib.max().item()


def test_weight_head_kernel_reshape_quirk(dev, weight_head_case):
    """A row of 324 distinct values (exact in bf16): J reads the channels
    as (Kp, Kp, L), as the plain version does."""
    _, (taps, consts) = weight_head_case
    g = torch.Generator().manual_seed(3)
    corr_row = ((torch.randperm(324, generator=g) - 162).float() / 64.0)
    corr_row = corr_row[None].to(dev)
    mean = torch.tensor([3.3], device=dev)
    with torch.no_grad():
        got = whead.weight_head(corr_row, mean, taps, consts)
        want = whead.weight_head_plain(corr_row, mean, taps, consts)
    assert (got - want).abs().item() <= 1e-6 * want.abs().item() + 1e-9


def test_weight_head_route_on_the_card(dev, weight_head_case):
    """``weight_head_apply`` on the card: one launch of J a call in bf16
    mode; none in 'highest' and 'default', nor when a gradient flows into
    the head, where it returns the unfused chain bit for bit."""
    head, _ = weight_head_case
    corr_rows, mean = _head_rows(dev, 300)
    cs, mr = corr_rows.float().reshape(1, 3, 100, 9, 9, 4), mean.reshape(1, 3, 100)
    n0 = kernels.weight_head.launches
    with torch.no_grad(), layers.precision_scope("bf16"):
        got = traft.weight_head_apply(head, cs, mr)
    assert kernels.weight_head.launches == n0 + 1
    assert got.shape == (1, 3, 100, 1)
    for precision in ("highest", "default"):
        with torch.no_grad(), layers.precision_scope(precision):
            got = traft.weight_head_apply(head, cs, mr)
            want = traft.weight_head_chain(head, cs, mr)
        assert torch.equal(got, want)
    trained = copy.deepcopy(head).requires_grad_(True)
    with layers.precision_scope("bf16"):
        got = traft.weight_head_apply(trained, cs, mr)
        want = traft.weight_head_chain(trained, cs, mr)
    assert got.requires_grad and torch.equal(got, want)
    assert kernels.weight_head.launches == n0 + 1


def test_weight_head_kernel_raises_under_grad(dev, weight_head_case):
    """J has no backward: ``weight_head`` raises when autograd would record
    an input, before it launches."""
    _, (taps, consts) = weight_head_case
    corr_rows, mean = _head_rows(dev, 8, torch.float32)
    n0 = kernels.weight_head.launches
    with pytest.raises(RuntimeError, match="no backward"):
        whead.weight_head(corr_rows.requires_grad_(), mean, taps, consts)
    assert kernels.weight_head.launches == n0


def test_weight_head_wrapper_checks_inputs(dev, weight_head_case):
    _, (taps, consts) = weight_head_case
    corr_rows, mean = _head_rows(dev, 8, torch.float32)
    with pytest.raises(ValueError):
        kernels.weight_head(corr_rows[:, :300].contiguous(), mean, taps,
                            consts)
    with pytest.raises(TypeError):
        kernels.weight_head(corr_rows.half(), mean, taps, consts)
    with pytest.raises(ValueError):
        kernels.weight_head(corr_rows, mean[:4], taps, consts)
    with pytest.raises(ValueError):
        kernels.weight_head(corr_rows, mean, taps[:128], consts)
    with pytest.raises(ValueError):
        kernels.weight_head(corr_rows.t().contiguous().t(), mean, taps,
                            consts)


def test_shared_step_1080p_with_kernel_j(dev, monkeypatch):
    """``woft_fast_shared``'s program (``SharedMultiTracker`` on
    ``WOFT_fast.py`` and the trained v4 weights, eight targets) on two
    1080p frames of the walk: one launch of J a frame (the head over every
    cell), the same check flags as with the unfused head, and the median
    corner gap between the two within the shared cell's ``h_gap_median_px``
    limit, 0.02 px."""
    import sys

    import numpy as np

    sys.path.insert(0, str(kernels.CSRC.parents[1]))
    import chip_smoke
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.pipeline import SharedMultiTracker

    template, frames, _ = chip_smoke.walk(1080, 1920, dev, n=2)
    masks = chip_smoke.shared_masks(8, 1080, 1920)
    conf = load_config(str(kernels.CSRC.parent / "configs" / "WOFT_fast.py"))
    flower = RaftFlow(conf.flow_config, device=dev)

    def run():
        tracker = SharedMultiTracker(flower.model, flower.cfg,
                                     conf.tracker_params, device=dev)
        tracker.init(template, masks)
        n0 = kernels.weight_head.launches
        out = [tracker.track(f) for f in frames]
        torch.cuda.synchronize()
        return ([np.asarray(h) for h, _ in out],
                [np.asarray(m["global_H_success"]) for _, m in out],
                kernels.weight_head.launches - n0)

    hs, oks, n = run()
    assert n == len(frames)
    with monkeypatch.context() as m:
        m.setattr(whead, "fused_route", lambda *args: False)
        hs_chain, oks_chain, n_chain = run()
    assert n_chain == 0
    for ok, ok_chain in zip(oks, oks_chain):
        assert np.array_equal(ok, ok_chain)
    gaps = [chip_smoke.h_diff_px(h[t], hc[t], chip_smoke.mask_corners(masks[t]))
            for h, hc in zip(hs, hs_chain) for t in range(len(masks))]
    assert np.median(gaps) <= 0.02


def test_shared_step_1080p_card_route(dev, monkeypatch):
    """``woft_fast_shared``'s program (``SharedMultiTracker`` on
    ``WOFT_fast.py`` and the trained v4 weights, eight targets, no flag)
    on three 1080p frames of the walk (the first forward eager and
    captured, the others replayed): G 24, H 12 and I 12 launches a flow;
    against the unfused loop (the route's card predicate answering no:
    none of them), the same check flags and the median corner gap within
    the shared cell's ``h_gap_median_px`` limit, 0.02 px."""
    import sys

    import numpy as np

    sys.path.insert(0, str(kernels.CSRC.parents[1]))
    import chip_smoke
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.pipeline import SharedMultiTracker

    template, frames, _ = chip_smoke.walk(1080, 1920, dev, n=3)
    masks = chip_smoke.shared_masks(8, 1080, 1920)
    conf = load_config(str(kernels.CSRC.parent / "configs" / "WOFT_fast.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    assert not (flower.cfg.gru_fused or flower.cfg.tail_fused)

    def run():
        tracker = SharedMultiTracker(flower.model, flower.cfg,
                                     conf.tracker_params, device=dev)
        tracker.init(template, masks)
        n0 = _launches()
        out = [tracker.track(f) for f in frames]
        torch.cuda.synchronize()
        n1 = _launches()
        return ([np.asarray(h) for h, _ in out],
                [np.asarray(m["global_H_success"]) for _, m in out],
                tuple(n1[k] - n0[k] for k in UPDATE_KERNELS))

    hs, oks, n = run()
    T = len(frames)
    assert n == (24 * T, 12 * T, 12 * T)
    with monkeypatch.context() as m:
        m.setattr(update, "_on_card", lambda *tensors: False)
        hs_unfused, oks_unfused, n_unfused = run()
    assert n_unfused == (0, 0, 0)
    for ok, ok_unfused in zip(oks, oks_unfused):
        assert np.array_equal(ok, ok_unfused)
    gaps = [chip_smoke.h_diff_px(h[t], hu[t],
                                 chip_smoke.mask_corners(masks[t]))
            for h, hu in zip(hs, hs_unfused) for t in range(len(masks))]
    assert np.median(gaps) <= 0.02


# ---------------------------------------------------------------------------
# kernel K: the alternate (volume-free) lookup
# ---------------------------------------------------------------------------

# K and its plain version (``corr.corr_lookup_alternate_plain``) take the
# same float32 products and blend; K sums a tap's 256 products in channel
# order, the plain version's batched product in its own: 1e-5 of the
# largest value (the sums' rounding is ~1e-7 of it)
ALT_LOOKUP_REL = 1e-5


def _alt_inputs(dev, h1, w1, spread, seed, batch=1, dim=256):
    """Seeded features of both frames, fmap2's levels and level-0
    coordinates: the cell grid, a smooth shift of a few cells and
    ``spread`` cells of uniform noise."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = torch.randn(batch, h1, w1, dim, device=dev, generator=g)
    f2 = torch.randn(batch, h1, w1, dim, device=dev, generator=g)
    ys, xs = torch.meshgrid(torch.arange(h1, device=dev, dtype=torch.float32),
                            torch.arange(w1, device=dev, dtype=torch.float32),
                            indexing="ij")
    grid = torch.stack([xs + 2.5 + 1.5 * torch.sin(ys / 17.0),
                        ys - 1.25 + 1.5 * torch.cos(xs / 23.0)], -1)
    noise = torch.rand(batch, h1, w1, 2, device=dev, generator=g) - 0.5
    coords = (grid[None] + spread * noise).contiguous()
    return f1, corr.alternate_levels(f2), coords


def _alt_rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("hw,spread,batch,radius", [
    ((270, 480), 0.5, 1, 4),         # 3840x2160: the 4K cell's grid
    ((90, 160), 80.0, 1, 4),         # scattered windows: taps from memory
    ((21, 37), 3.0, 2, 4),           # ragged tiles, two batch elements
    ((21, 37), 3.0, 1, 3),           # RAFT-small's radius
], ids=["4k", "720p-scattered", "21x37-batch2", "21x37-r3"])
def test_alt_corr_kernel_dense(dev, hw, spread, batch, radius):
    """Every query of the grid, one launch, against the plain chain."""
    f1, levels, coords = _alt_inputs(dev, *hw, spread, seed=1, batch=batch)
    n0 = kernels.alt_corr_lookup.launches
    got = corr.corr_lookup_alternate_levels(f1, levels, coords, radius)
    torch.cuda.synchronize()
    assert kernels.alt_corr_lookup.launches == n0 + 1
    want = corr.corr_lookup_alternate_plain(f1, levels, coords, radius)
    assert got.shape == want.shape
    assert _alt_rel(got, want) <= ALT_LOOKUP_REL


@pytest.mark.parametrize("hw,batch,m", [((270, 480), 1, 4500),
                                        ((21, 37), 2, 301)],
                         ids=["4k-4500", "21x37-batch2"])
def test_alt_corr_kernel_indexed(dev, hw, batch, m):
    """The sparse head's rows (cells of every batch element, in no order,
    one twice) against the plain chain on the same cells, and equal to
    the dense launch's rows at those cells."""
    f1, levels, coords = _alt_inputs(dev, *hw, 0.5, seed=2, batch=batch)
    g = torch.Generator(device=dev).manual_seed(3)
    cells = torch.randperm(batch * hw[0] * hw[1], device=dev,
                           generator=g)[:m - 1]
    cells = torch.cat([cells, cells[:1]])
    n0 = kernels.alt_corr_lookup.launches
    got = corr.corr_lookup_alternate_levels(f1, levels, coords, 4,
                                            cells=cells)
    torch.cuda.synchronize()
    assert kernels.alt_corr_lookup.launches == n0 + 1
    D = f1.shape[3]
    want = corr.corr_lookup_alternate_plain(
        f1.reshape(-1, D)[cells][None, None], levels,
        coords.reshape(-1, 2)[cells][None, None], 4,
        batch=cells // (hw[0] * hw[1]))[0, 0]
    assert _alt_rel(got, want) <= ALT_LOOKUP_REL
    dense = corr.corr_lookup_alternate_levels(f1, levels, coords, 4)
    assert _alt_rel(got, dense.reshape(-1, got.shape[1])[cells]) <= \
        ALT_LOOKUP_REL


def test_alt_corr_wrapper_checks_inputs(dev):
    f1, levels, coords = _alt_inputs(dev, 16, 24, 1.0, seed=4)
    with pytest.raises(ValueError, match="radius 3 or 4"):
        kernels.alt_corr_lookup(f1, levels, coords, 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels.alt_corr_lookup(f1[..., :12].contiguous(),
                                [lv[..., :12].contiguous() for lv in levels],
                                coords, 4)
    with pytest.raises(ValueError, match="coords must be"):
        kernels.alt_corr_lookup(f1, levels, coords[:, :8].contiguous(), 4)
    with pytest.raises(TypeError):
        kernels.alt_corr_lookup(f1, levels, coords, 4,
                                torch.zeros(3, dtype=torch.int32,
                                            device=dev))


@pytest.mark.parametrize("indexed", [False, True], ids=["dense", "indexed"])
def test_alt_corr_grads_match_plain(dev, indexed):
    """Under grad K runs inside ``_AltLookup`` (one launch forward, the
    plain chain's VJP backward): its output is K's, its gradients for the
    query features, the features K's levels pool and the coordinates are
    autograd's through the plain chain, within ``ALT_LOOKUP_REL``."""
    f1, _, coords = _alt_inputs(dev, 21, 37, 3.0, seed=6, batch=2)
    f2 = torch.randn(f1.shape, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(7))
    cells = (torch.randperm(2 * 21 * 37, device=dev)[:301] if indexed
             else None)

    def grads(route):
        leaves = [x.clone().requires_grad_() for x in (f1, coords, f2)]
        out = route(leaves[0], corr.alternate_levels(leaves[2]), leaves[1])
        w = torch.sin(torch.arange(out.numel(), device=dev,
                                   dtype=torch.float32))
        (out * w.reshape(out.shape)).sum().backward()
        return out, [x.grad for x in leaves]

    n0 = kernels.alt_corr_lookup.launches
    out, got = grads(lambda a, lv, c: corr.corr_lookup_alternate_levels(
        a, lv, c, 4, cells=cells))
    assert kernels.alt_corr_lookup.launches == n0 + 1
    assert type(out.grad_fn).__name__ == "_AltLookupBackward"
    plain_out, want = grads(lambda a, lv, c: corr._alt_lookup_plain(
        a, lv, c, 4, 4096, cells))
    assert _alt_rel(out.detach(), plain_out.detach()) <= ALT_LOOKUP_REL
    for name, a, b in zip(("fmap1", "coords", "fmap2"), got, want):
        assert _alt_rel(a, b) <= ALT_LOOKUP_REL, name


def test_alt_corr_train_grads_equal_dense(dev):
    """A training forward's gradient at B = 1 on the card under
    ``alternate_corr`` (K forward, the plain chain's VJP backward) equals
    the dense path's (B, B'), as on the CPU
    (``test_torch_alt_corr.py::test_train_grads_equal_dense``: 1e-4 of
    each parameter's largest gradient, over those whose gradient reaches
    1e-4 of the largest)."""
    from dataclasses import replace

    import numpy as np

    cfg = traft.RaftConfig(iters=2, weight_head_structure=((32, 3),))
    model = traft.init_raft_params(cfg, seed=5, device=dev)
    rng = np.random.default_rng(5)
    img1 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3)).astype(
        np.float32)).to(dev)
    img2 = img1.roll((2, 3), (1, 2))

    def grads(c):
        model.zero_grad()
        out = traft.train_forward(model, c, img1, img2)
        (out["flow_up"].abs().mean() + out["weights_up"].mean()).backward()
        return [p.grad.clone() for p in model.parameters()]

    dense = grads(cfg)
    n0 = kernels.alt_corr_lookup.launches
    alt = grads(replace(cfg, alternate_corr=True))
    assert kernels.alt_corr_lookup.launches - n0 == 3   # 2 loop + the head
    top = max(b.abs().max().item() for b in dense)
    held = [(name, _alt_rel(a, b)) for (name, _), a, b in zip(
        model.named_parameters(), alt, dense) if b.abs().max() > 1e-4 * top]
    assert len(held) >= 90
    assert max(rel for _, rel in held) <= 1e-4, held


def _forward_launches(dev, cfg, sparse):
    """K's launches in one 64x96 forward of ``cfg`` on seeded weights (the
    sparse head's rows read once)."""
    model = traft.init_raft_params(cfg, seed=3, device=dev)
    g = torch.Generator().manual_seed(12)
    imgs = [(torch.rand(1, 64, 96, 3, generator=g) * 255).to(dev)
            for _ in range(2)]
    n0 = kernels.alt_corr_lookup.launches
    out = traft.weighted_raft_forward(model, cfg, *imgs,
                                      sparse_weight_head=sparse)
    if sparse:
        out["weight_head_at"](torch.arange(0, 96, 3, device=dev))
    torch.cuda.synchronize()
    return kernels.alt_corr_lookup.launches - n0


def test_alt_corr_launches_13_a_flow(dev):
    """``WOFT_alternate.py``'s forward launches K 13 times a flow (12 in
    the loop, one for the weight head, dense or sparse); ``WOFT.py``'s and
    ``WOFT_fast.py``'s forwards never."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow.wrapper import raft_config

    configs = kernels.CSRC.parent / "configs"
    cfgs = {name: raft_config(load_config(str(configs / name)).flow_config)
            for name in ("WOFT_alternate.py", "WOFT.py", "WOFT_fast.py")}
    assert cfgs["WOFT_alternate.py"].alternate_corr
    for sparse in (False, True):
        assert _forward_launches(dev, cfgs["WOFT_alternate.py"], sparse) == 13
        assert _forward_launches(dev, cfgs["WOFT.py"], sparse) == 0
        assert _forward_launches(dev, cfgs["WOFT_fast.py"], sparse) == 0


# ---------------------------------------------------------------------------
# kernel L: the feature encoder's instance norm with its ReLU and residual
# ---------------------------------------------------------------------------

# L sums each plane's statistics in another order than PyTorch's batch-norm
# kernels: in float32 a few ulps of the largest normalised value; in bf16
# each rounding (the normalised value, the shortcut's, the sum: one ulp each
# of the largest of them, at a tie to even) may fall the other way on a
# small share of the entries, and a value near 0, where x - mean cancels,
# may move by the float32 gap
NORM_F32_REL = 1e-5
NORM_BF16_ULPS = {"relu": 1, "residual": 2, "shortcut": 3}
NORM_BF16_SHARE = 1e-3
# the largest plane of each benchmark cell's feature encoder (the stem's
# output and layer1: 64 channels at half the frame), and an odd shape
NORM_SHAPES = {"720p-float32": ((1, 64, 360, 640), torch.float32),
               "1080p-bf16": ((1, 64, 540, 960), torch.bfloat16),
               "2160p-float32": ((1, 64, 1080, 1920), torch.float32),
               "odd-float32": ((2, 3, 37, 53), torch.float32),
               "odd-bf16": ((2, 3, 37, 53), torch.bfloat16)}


def _norm_inputs(dev, shape, dtype, seed):
    """A convolution-like map (each plane its own offset and scale), a
    second one for a shortcut, a block input (after a ReLU) and the two
    convolutions' biases."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, c = shape[:2]
    scale = torch.rand(n, c, 1, 1, device=dev, generator=g) * 2.8 + 0.2
    offset = torch.rand(n, c, 1, 1, device=dev, generator=g) * 6 - 3
    x = torch.randn(shape, device=dev, generator=g) * scale + offset
    sc = torch.randn(shape, device=dev, generator=g) * scale - offset
    r = torch.randn(shape, device=dev, generator=g).relu()
    b, sb = torch.randn(2, c, device=dev, generator=g)
    return tuple(t.to(dtype) for t in (x, sc, r, b, sb))


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("mode", ["relu", "residual", "shortcut"])
@pytest.mark.parametrize("case", list(NORM_SHAPES))
def test_instance_norm_kernel_matches_plain(dev, case, mode, bias):
    """L against its plain version (the encoder modules' own calls, the
    convolutions' bias adds first): float32 within NORM_F32_REL of the
    largest value; bf16 within NORM_BF16_ULPS ulps of the largest of the
    two values and the normalised x (plus the float32 gap) on every entry,
    differing on at most NORM_BF16_SHARE of them. Two launches a call."""
    shape, dtype = NORM_SHAPES[case]
    x, sc, r, b, sb = _norm_inputs(dev, shape, dtype, seed=len(case))
    if not bias:
        b = sb = None
    kw = {"relu": {}, "residual": {"residual": r},
          "shortcut": {"shortcut": sc, "shortcut_bias": sb}}[mode]
    kw["bias"] = b
    with torch.no_grad():
        n0 = kernels.instance_norm_act.launches
        got = kernels.instance_norm_act(x, **kw)
        torch.cuda.synchronize()
        assert kernels.instance_norm_act.launches == n0 + 2
        want = kernels.instance_norm_act_plain(x, **kw)
        y = kernels.instance_norm_act_plain(x, bias=b)
    assert got.dtype == dtype and got.shape == x.shape
    d = (got.float() - want.float()).abs()
    f32_gap = NORM_F32_REL * want.float().abs().max()
    if dtype == torch.float32:
        assert (d <= f32_gap).all()
    else:
        top = torch.ldexp(torch.ones_like(d), torch.frexp(torch.maximum(
            torch.maximum(got.float().abs(), want.float().abs()),
            y.float().abs()))[1])
        assert (d <= NORM_BF16_ULPS[mode] * ULP * top + f32_gap).all()
        assert (d > 0).float().mean().item() <= NORM_BF16_SHARE


# the stem's map (64 channels at half the frame; 32 for RAFT-small), as
# the convolution of an NHWC image leaves it: channels-last strides
NORM_STEMS = {"720p-float32": ((1, 64, 360, 640), torch.float32),
              "1080p-bf16": ((1, 64, 540, 960), torch.bfloat16),
              "2160p-float32": ((1, 64, 1080, 1920), torch.float32),
              "small-bf16": ((2, 32, 32, 48), torch.bfloat16),
              "odd-float32": ((2, 64, 37, 53), torch.float32),
              "odd-bf16": ((2, 64, 37, 53), torch.bfloat16)}


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("case", list(NORM_STEMS))
def test_instance_norm_stem_matches_plain(dev, case, bias):
    """L's channels-last form (the stem) against its plain version, to the
    tolerances above: three launches, the output contiguous NCHW; an odd
    H*W takes its scalar stores."""
    shape, dtype = NORM_STEMS[case]
    x, _, _, b, _ = _norm_inputs(dev, shape, dtype, seed=len(case))
    x = x.contiguous(memory_format=torch.channels_last)
    b = b if bias else None
    with torch.no_grad():
        n0 = kernels.instance_norm_act.launches
        got = kernels.instance_norm_act(x, bias=b)
        torch.cuda.synchronize()
        assert kernels.instance_norm_act.launches == n0 + 3
        want = kernels.instance_norm_act_plain(x, bias=b)
    assert got.is_contiguous() and got.dtype == dtype
    d = (got.float() - want.float()).abs()
    f32_gap = NORM_F32_REL * want.float().abs().max()
    if dtype == torch.float32:
        assert (d <= f32_gap).all()
    else:
        top = torch.ldexp(torch.ones_like(d), torch.frexp(torch.maximum(
            got.float().abs(), want.float().abs()))[1])
        assert (d <= ULP * top + f32_gap).all()
        assert (d > 0).float().mean().item() <= NORM_BF16_SHARE


def _norm_launches(model, x, grad=False):
    n0 = kernels.instance_norm_act.launches
    if grad:
        model.fnet(x).float().square().mean().backward()
    else:
        with torch.no_grad():
            model.fnet(x)
    torch.cuda.synchronize()
    return kernels.instance_norm_act.launches - n0


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("small", [False, True], ids=["large", "small"])
def test_instance_norm_launches_an_encoded_image(dev, monkeypatch, precision,
                                                 small):
    """One feature encoding with no grad: every instance norm goes through L,
    13 calls, 27 launches for RAFT-large (15 norms: each strided block's
    shortcut norm rides its last call; the stem reads its convolution's
    channels-last output in three launches), 19 calls, 39 launches for
    RAFT-small, for one
    image or a batch of two; the features within the float32 tolerance
    (bf16: a few ulps) of the modules' path on the card. With grad on, L
    launches 0 times."""
    cfg = traft.RaftConfig(precision=precision, small=small)
    model = traft.init_raft_params(cfg, seed=2, device=dev)
    g = torch.Generator().manual_seed(7)
    x = (torch.rand(2, 3, 64, 96, generator=g) * 2 - 1).to(dev)
    x = x.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)  # NHWC images
    per = 39 if small else 27
    with layers.precision_scope(precision):
        assert _norm_launches(model, x[:1]) == per
        assert _norm_launches(model, x) == per
        with torch.no_grad():
            got = model.fnet(x)
            with monkeypatch.context() as m:
                m.setattr(traft, "_norm_route", lambda module: False)
                want = model.fnet(x)
        assert _norm_launches(model, x, grad=True) == 0
    tol = 1e-4 if precision == "highest" else 0.05
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def test_instance_norm_wrapper_checks_inputs(dev):
    """L refuses what it does not take: another dtype, a non-contiguous map,
    a residual of another shape, a residual and a shortcut at once, a bias
    of another length or dtype, and a call that would record a gradient."""
    x, sc, r, b, _ = _norm_inputs(dev, (1, 4, 8, 16), torch.float32, seed=3)
    with torch.no_grad():
        with pytest.raises(TypeError):
            kernels.instance_norm_act(x.double())
        with pytest.raises(ValueError):
            kernels.instance_norm_act(x.transpose(2, 3))
        with pytest.raises(ValueError):   # 4 bf16 channels: 8 bytes a row
            kernels.instance_norm_act(
                x.bfloat16().contiguous(memory_format=torch.channels_last))
        with pytest.raises(ValueError):
            kernels.instance_norm_act(x, residual=r[:, :2].contiguous())
        with pytest.raises(ValueError):
            kernels.instance_norm_act(x, residual=r, shortcut=sc)
        with pytest.raises(ValueError):
            kernels.instance_norm_act(x, bias=b[:3])
        with pytest.raises(TypeError):
            kernels.instance_norm_act(x, bias=b.bfloat16())
    with pytest.raises(RuntimeError):
        kernels.instance_norm_act(x.requires_grad_())


# ---------------------------------------------------------------------------
# GMA: kernel M (the aggregation) and kernel G at 256 motion channels
# ---------------------------------------------------------------------------

GMA_SHAPES = [(135, 240), (90, 160), (19, 28), (1, 122), (122, 1)]
GMA_IDS = [f"{h}x{w}" for h, w in GMA_SHAPES]


@pytest.fixture(scope="module")
def gma_update_block(dev):
    cfg = traft.RaftConfig(precision="bf16", gma=True)
    return traft.init_raft_params(cfg, seed=1, device=dev).update_block


@pytest.mark.parametrize("hw", GMA_SHAPES, ids=GMA_IDS)
@pytest.mark.parametrize("axis", ["w", "h"])
def test_gru_kernel_gma_width_matches_plain(dev, gma_update_block, hw, axis):
    """Kernel G with GMA's 256-channel motion input (taps (5, 256, 384) and
    (5, 128, 384)) against its plain version, at the bound of
    ``test_gru_kernel_matches_plain``: 4 ulps of max(1, |h|), at most 2 %
    of the entries differing."""
    gru = gma_update_block.gru
    (h,) = _maps(dev, hw, 20, 128, dtype=torch.float32)
    x, pre_zr, pre_q = _maps(dev, hw, 21, 256, 256, 128)
    names = (("convz1", "convr1", "convq1") if axis == "w"
             else ("convz2", "convr2", "convq2"))
    wzr, bzr = update.gru_taps(gru, names[:2], 128, 128)
    wq, bq = update.gru_taps(gru, names[2:], 128, 128)
    assert wzr.shape == (5, 256, 384) and wq.shape == (5, 128, 384)
    wzr, wq = ((4.0 * w.float()).bfloat16() for w in (wzr, wq))
    n0 = kernels.fused_gru_update.launches
    got = update.gru_update(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis)
    want = update.gru_update_plain(h, x, pre_zr, pre_q, wzr, wq, bzr, bq, axis)
    torch.cuda.synchronize()
    assert kernels.fused_gru_update.launches == n0 + 1
    diff = (got - want).abs()
    assert (diff <= 4 * ULP * h.abs().clamp(min=1.0)).all(), diff.max().item()
    assert (diff > 1e-6).float().mean().item() <= 0.02


def _gma_case(dev, hw, seed):
    """Kernel M's operands at an (H1, W1) grid: the template's attention
    of random context features (bf16 mode), v transposed, motion features,
    gamma."""
    from woft_tpu_torch.models import gma

    g = torch.Generator(device=dev).manual_seed(seed)
    att, agg = gma.Attention().to(dev), gma.Aggregate().to(dev)
    with torch.no_grad():
        agg.gamma.fill_(3.0)
        inp = torch.relu(torch.randn(1, 128, *hw, device=dev, generator=g))
        mf = torch.relu(torch.randn(hw[0] * hw[1], 128, device=dev,
                                    generator=g)).bfloat16()
        with layers.precision_scope("bf16"):
            attn = gma.template_attention(att, inp)[0]
            vt = gma.value_t(agg, mf)
    return attn, vt, mf, agg.gamma.detach()


@pytest.mark.parametrize("hw", [(135, 240), (8, 12), (7, 9), (1, 1)],
                         ids=["135x240", "8x12", "7x9", "1x1"])
def test_gma_aggregate_matches_plain(dev, hw):
    """Kernel M against its plain version: the first 128 channels are mf
    bit for bit; the aggregated ones within one bf16 ulp of the result
    plus gamma times the largest |v| times (N / 16 + 1) 2^-23, and at most
    2 % of them differ. The second term is the sums': the tensor cores add
    each k16 product to the float32 accumulator with truncation (as kernel
    J's notes find), so M's sum of N terms drifts by up to a float32 ulp a
    step, which shows where mf + gamma * out cancels. 135 x 240 is the 1080p grid (127 CTAs, the last one ragged);
    7 x 9 and 1 x 1 read rows of an N that is no multiple of 8 (strided
    views)."""
    from woft_tpu_torch.models import gma

    attn, vt, mf, gamma = _gma_case(dev, hw, 30)
    n0 = kernels.gma_aggregate.launches
    got = gma.gma_aggregate(attn, vt, mf, gamma)
    want = gma.gma_aggregate_plain(attn, vt, mf, gamma)
    torch.cuda.synchronize()
    assert kernels.gma_aggregate.launches == n0 + 1
    assert got.shape == (hw[0] * hw[1], 256) and got.dtype == torch.bfloat16
    assert torch.equal(got[:, :128], mf)
    diff = (got[:, 128:].float() - want[:, 128:].float()).abs()
    # one bf16 ulp (2^-7 of the result's magnitude at most) and the sums'
    steps = hw[0] * hw[1] // 16 + 1
    allowed = (2 * ULP * want[:, 128:].float().abs()
               + steps * 2.0 ** -23 * gamma.abs() * vt.float().abs().max())
    assert (diff <= allowed).all(), (diff - allowed).max().item()
    assert (diff > 0).float().mean().item() <= 0.02


def test_gma_aggregate_checks_inputs(dev):
    """M refuses what it does not take: another dtype, a row stride that is
    no multiple of 8, a shape that does not match, and a gradient."""
    from woft_tpu_torch.models import gma

    attn, vt, mf, gamma = _gma_case(dev, (8, 12), 31)
    with torch.no_grad():
        with pytest.raises(ValueError):
            kernels.gma_aggregate(attn.float(), vt, mf, gamma)
        wide = torch.zeros(96, 100, dtype=attn.dtype, device=dev)
        with pytest.raises(ValueError):     # rows 100 elements apart
            kernels.gma_aggregate(wide[:, :96], vt, mf, gamma)
        with pytest.raises(ValueError):
            kernels.gma_aggregate(attn, vt[:, :48], mf, gamma)
        with pytest.raises(ValueError):
            kernels.gma_aggregate(attn, vt, mf[:, :64], gamma)
    with pytest.raises(RuntimeError):
        gma.gma_aggregate(attn, vt, mf, gamma.clone().requires_grad_())


def _m_launches(dev, cfg):
    """M's launches in one 64x96 forward of ``cfg`` on seeded weights, and
    in a second one (graphed where the loop is)."""
    model = traft.init_raft_params(cfg, seed=3, device=dev)
    g = torch.Generator().manual_seed(12)
    imgs = [(torch.rand(1, 64, 96, 3, generator=g) * 255).to(dev)
            for _ in range(2)]
    counts = []
    for _ in range(2):
        n0 = kernels.gma_aggregate.launches
        traft.weighted_raft_forward(model, cfg, *imgs,
                                    sparse_weight_head=True)
        torch.cuda.synchronize()
        counts.append(kernels.gma_aggregate.launches - n0)
    return counts


@pytest.mark.parametrize("config, gma_launches", [
    ("WOFT_gma_fast.py", 12), ("WOFT_fast.py", 0), ("WOFT.py", 0),
    ("WOFT_alternate.py", 0)])
def test_gma_launches_12_a_flow(dev, config, gma_launches):
    """A forward of ``WOFT_gma_fast.py``'s network launches M once an
    iteration, 12 a flow, eager and then replayed from the loop's graph
    (counted at the capture, added at each replay); the other configs'
    never."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow.wrapper import raft_config

    conf = load_config(str(kernels.CSRC.parent / "configs" / config))
    cfg = raft_config(conf.flow_config)
    assert cfg.gma == bool(gma_launches)
    assert _m_launches(dev, cfg) == [gma_launches] * 2


def test_gma_route_launches(dev):
    """GMA's other routes on the card run the aggregation in its plain
    form: a batch, a training forward, float32 and 'default' launch no M;
    one bf16 pair without grad launches M and G (2 an iteration), H, I."""
    base = dict(gma=True, iters=2, corr_impl="local")
    for overrides, B, train, m in (
            (dict(precision="bf16"), 1, False, 2),
            (dict(precision="bf16"), 2, False, 0),
            (dict(precision="bf16"), 1, True, 0),
            (dict(), 1, False, 0), (dict(precision="default"), 1, False, 0)):
        cfg = traft.RaftConfig(**base, **overrides)
        model = traft.init_raft_params(cfg, seed=4, device=dev)
        g = torch.Generator().manual_seed(12)
        img1 = (torch.rand(B, 64, 96, 3, generator=g) * 255).to(dev)
        img2 = torch.roll(img1, shifts=(2, 3), dims=(1, 2))
        n0 = _launches()
        if train:
            traft.train_forward(model, cfg, img1, img2)["flow_up"].sum() \
                .backward()
        else:
            traft.weighted_raft_forward(model, cfg, img1, img2)
        torch.cuda.synchronize()
        n1 = _launches()
        assert n1["gma_aggregate"] - n0["gma_aggregate"] == m, overrides
        assert n1["fused_gru_update"] - n0["fused_gru_update"] == 2 * m


def test_shared_step_1080p_gma(dev, monkeypatch):
    """``woft_gma_shared``'s program (``SharedMultiTracker`` on
    ``WOFT_gma_fast.py``: the trained v4 weights with GMA's additions,
    eight targets) on three 1080p frames of the walk: M 12, G 24, H 12 and
    I 12 launches a flow; against the route's card predicate answering no
    (the plain aggregation and the unfused loop: none of them), the same
    check flags and the median corner gap within the cell's
    ``h_gap_median_px`` limit, 0.03 px."""
    import sys

    import numpy as np

    sys.path.insert(0, str(kernels.CSRC.parents[1]))
    import chip_smoke
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.pipeline import SharedMultiTracker

    template, frames, _ = chip_smoke.walk(1080, 1920, dev, n=3)
    masks = chip_smoke.shared_masks(8, 1080, 1920)
    conf = load_config(str(kernels.CSRC.parent / "configs"
                           / "WOFT_gma_fast.py"))
    flower = RaftFlow(conf.flow_config, device=dev)
    assert flower.cfg.gma
    names = ("gma_aggregate",) + UPDATE_KERNELS

    def run():
        tracker = SharedMultiTracker(flower.model, flower.cfg,
                                     conf.tracker_params, device=dev)
        tracker.init(template, masks)
        n0 = _launches()
        out = [tracker.track(f) for f in frames]
        torch.cuda.synchronize()
        n1 = _launches()
        return ([np.asarray(h) for h, _ in out],
                [np.asarray(m["global_H_success"]) for _, m in out],
                tuple(n1[k] - n0[k] for k in names))

    hs, oks, n = run()
    T = len(frames)
    assert n == (12 * T, 24 * T, 12 * T, 12 * T)
    with monkeypatch.context() as m:
        m.setattr(update, "_on_card", lambda *tensors: False)
        hs_plain, oks_plain, n_plain = run()
    assert n_plain == (0, 0, 0, 0)
    for ok, ok_plain in zip(oks, oks_plain):
        assert np.array_equal(ok, ok_plain)
    gaps = [chip_smoke.h_diff_px(h[t], hp[t],
                                 chip_smoke.mask_corners(masks[t]))
            for h, hp in zip(hs, hs_plain) for t in range(len(masks))]
    assert np.median(gaps) <= 0.03


# ---------------------------------------------------------------------------
# kernel N: the Sobol-n selection of tentative correspondences
# ---------------------------------------------------------------------------

SOBOL_P = {"720p": 921_600, "1080p": 2_073_600, "2160p": 8_294_400}
SOBOL_FILLS = (0, 1, 499, 500, 501, 1003, "half", "all", "first", "last",
               "tile-edge", "mixed")
# (rows, P, n, fill, byte offset of the rows in their storage): the
# cells' shapes at one and eight targets, then the window batch's grid,
# training's sobol_n, a row length that is not a multiple of 16 and an
# unaligned row (both take the byte loads)
SOBOL_CASES = (
    [(rows, P, 500, fill, 0) for rows in (1, 8) for P in SOBOL_P.values()
     for fill in SOBOL_FILLS]
    + [(8, 192 * 344, 500, "mixed", 0), (8, 192 * 344, 500, "half", 0),
       (4, 288 * 384, 200, "mixed", 0), (8, 2_073_600, 1000, "mixed", 0),
       (3, 1001, 500, "mixed", 0), (8, 2_073_600, 500, "mixed", 3),
       (1, 921_600, 500, "tile-edge", 1)])
SOBOL_IDS = [f"{rows}x{P}-n{n}-{fill}" + (f"-offset{off}" if off else "")
             for rows, P, n, fill, off in SOBOL_CASES]


def _sobol_rows(dev, rows, P, fill, offset, seed):
    """(rows, P) bool on the card, a view ``offset`` bytes into its storage
    (contiguous). A count: that many valid slots at seeded places; 'half':
    each slot with probability 1/2; 'first', 'last': that slot alone;
    'tile-edge': 300 slots each side of every fourth of kernel N's tile
    boundaries; 'mixed': row r takes fill r of 0, 1, 499, 500, 501, 1003,
    'half', 'all' (501 to 1003 valid slots round n = 500 Sobol targets to
    duplicates)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    store = torch.zeros(rows * P + offset, dtype=torch.bool, device=dev)
    valid = store[offset:].view(rows, P)
    tile = kernels.sobol_select_plan(P)[0]
    for r in range(rows):
        f = (SOBOL_FILLS[r % 8] if fill == "mixed" else fill)
        if isinstance(f, int):
            valid[r, torch.randperm(P, generator=g, device=dev)[:f]] = True
        elif f == "half":
            valid[r] = torch.rand(P, generator=g, device=dev) < 0.5
        elif f == "all":
            valid[r] = True
        elif f in ("first", "last"):
            valid[r, 0 if f == "first" else P - 1] = True
        else:
            for edge in range(tile, P, 4 * tile):
                valid[r, max(edge - 300, 0):edge + 300] = True
    return valid


@pytest.mark.parametrize("rows,P,n,fill,offset", SOBOL_CASES, ids=SOBOL_IDS)
def test_sobol_select_matches_plain(dev, rows, P, n, fill, offset):
    """Kernel N through ``masked_sobol_gather`` equals the plain version at
    every slot, invalid targets included (their index is P - 1), two
    launches a call."""
    from woft_tpu_torch.ops import sampling

    valid = _sobol_rows(dev, rows, P, fill, offset, seed=rows + P + n)
    assert valid.is_contiguous() and (valid.data_ptr() % 16 == 0) == (
        offset == 0)
    n0 = kernels.masked_sobol_select.launches
    idx, sel = sampling.masked_sobol_gather(valid, n)
    torch.cuda.synchronize()
    assert kernels.masked_sobol_select.launches == n0 + 2
    want_idx, want_sel = sampling.masked_sobol_gather_plain(valid, n)
    assert idx.dtype == torch.int64 and sel.dtype == torch.bool
    assert idx.shape == sel.shape == (rows, n)
    assert torch.equal(sel, want_sel)
    assert torch.equal(idx, want_idx)
    if fill != "mixed":
        one_idx, one_sel = sampling.masked_sobol_gather(valid[-1], n)
        assert torch.equal(one_idx, want_idx[-1])
        assert torch.equal(one_sel, want_sel[-1])


def test_sobol_gather_on_the_card_is_kernel_n_alone(dev):
    """On a CUDA tensor the selection is N's two kernels and nothing else:
    no scan, sort, search or int64 widening of the mask."""
    from torch.profiler import ProfilerActivity, profile

    from woft_tpu_torch.ops import sampling

    valid = _sobol_rows(dev, 8, 2_073_600, "mixed", 0, seed=5)
    sampling.masked_sobol_gather(valid, 500)        # the table, made once
    # a first trace starts the tracer, which can miss kernels of the
    # window it is started in
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    # N's kernels queue behind a spin of ~10 ms, so they run well after
    # the trace has started; the spin is not counted
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        sampling.masked_sobol_gather(valid, 500)
        torch.cuda.synchronize()
    names = sorted(e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin" not in e.name)
    assert len(names) == 2, names
    assert "count" in names[0] and "select" in names[1], names
    assert all("sobol_gather" in name for name in names), names


def test_sobol_select_wrapper_checks_inputs(dev):
    """N refuses another dtype, a non-contiguous mask, a mask of another
    rank, and a table that is not float32 on the mask's card."""
    from woft_tpu_torch.ops import sampling

    valid = torch.ones(2, 4096, dtype=torch.bool, device=dev)
    table = sampling._sobol_sorted_on(500, valid.device)
    with pytest.raises(TypeError):
        kernels.masked_sobol_select(valid.to(torch.uint8), table)
    with pytest.raises(ValueError):
        kernels.masked_sobol_select(valid[:, ::2], table)
    with pytest.raises(ValueError):
        kernels.masked_sobol_select(valid[0], table)
    with pytest.raises(TypeError):
        kernels.masked_sobol_select(valid, table.double())
    with pytest.raises(ValueError):
        kernels.masked_sobol_select(valid, table.cpu())
