"""Parity of the PyTorch port's geometry, sampling, padding and warp ops
with ``woft_tpu`` on the CPU.

The same seeded numpy inputs go through both packages. Tolerances:
- geometry: 1e-4 relative (float32 QR of a 1000x8 system in two libraries);
- sampling: exact indices;
- warps on [0, 255] images: 1e-5 absolute against ``woft_tpu``'s gather
  warp where both packages invert H to the same bits (translations,
  90-degree rotations, power-of-two scales); 4 float32 ulps at 255
  (6.1e-5) against its Pallas block warp, whose one-hot matmul blend
  rounds in other places. For other poses the two LU inverses differ in
  the last bits, the back-projected coordinates by delta <= 1e-4 px, and a
  bilinear sample by at most delta times the image's largest step between
  neighbours.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.geometry import homography as jh
from woft_tpu.ops import pad as jpad
from woft_tpu.ops import sampling as jsamp
from woft_tpu.ops import warp as jwarp
from woft_tpu_torch.geometry import homography as th
from woft_tpu_torch.ops import pad as tpad
from woft_tpu_torch.ops import sampling as tsamp
from woft_tpu_torch.ops import warp as twarp


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


def _rel(a, b):
    return np.abs(_np(a) - _np(b)).max() / max(np.abs(_np(b)).max(), 1e-12)


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(0)
    h = np.array([[0.97, 0.05, 12.0], [-0.03, 1.04, -7.0],
                  [2e-5, -3e-5, 1.0]])
    p1 = rng.uniform(0, 640, (2, 500, 2))
    p2h = np.einsum("ij,bnj->bni", h, np.concatenate(
        [p1, np.ones((2, 500, 1))], -1))
    p2 = p2h[..., :2] / p2h[..., 2:] + rng.normal(0, 0.5, (2, 500, 2))
    w = rng.uniform(0, 1, (2, 500))
    w[:, ::7] = 0.0
    return (p1.astype(np.float32), p2.astype(np.float32),
            w.astype(np.float32))


def test_projective_helpers(points):
    p1, _, _ = points
    H = np.array([[[1.1, 0.02, 3.0], [0.01, 0.9, -2.0], [1e-4, 2e-4, 1.0]],
                  [[0.9, -0.1, 1.0], [0.1, 0.9, 4.0], [0.0, 0.0, 1.0]]],
                 np.float32)
    pts = np.swapaxes(p1, 1, 2)
    assert _rel(th.e2p(_t(pts)), jh.e2p(jnp.asarray(pts))) == 0
    assert _rel(th.h_proj(_t(H), _t(pts)),
                jh.h_proj(jnp.asarray(H), jnp.asarray(pts))) < 1e-4
    homo = np.concatenate([pts, np.zeros_like(pts[:, :1])], 1)
    assert _rel(th.p2e(_t(homo)), jh.p2e(jnp.asarray(homo))) == 0
    assert _rel(th.compose_h(_t(H[0]), _t(H[1])),
                jh.compose_h(jnp.asarray(H[0]), jnp.asarray(H[1]))) < 1e-4
    assert _rel(th.proj_errors(_t(H), _t(pts), _t(pts)),
                jh.proj_errors(jnp.asarray(H), jnp.asarray(pts),
                               jnp.asarray(pts))) < 1e-4


@pytest.mark.parametrize("weighted", [False, True])
def test_normalize_points(points, weighted):
    p1, _, w = points
    tw = _t(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    tn, tt = th.normalize_points(_t(p1), tw)
    jn, jt = jh.normalize_points(jnp.asarray(p1), jw)
    assert _rel(tn, jn) < 1e-4
    assert _rel(tt, jt) < 1e-4


@pytest.mark.parametrize("weighted", [False, True])
def test_find_homography_wls_qr(points, weighted):
    p1, p2, w = points
    tw = _t(w) if weighted else None
    jw = jnp.asarray(w) if weighted else None
    Ht = th.find_homography_wls_qr(_t(p1), _t(p2), tw)
    Hj = jh.find_homography_wls_qr(jnp.asarray(p1), jnp.asarray(p2), jw)
    assert _rel(Ht, Hj) < 1e-4
    A, b = th._build_nonhomogeneous_system(_t(p1), _t(p2), tw)
    Aj, bj = jh._build_nonhomogeneous_system(jnp.asarray(p1),
                                             jnp.asarray(p2), jw)
    assert _rel(A, Aj) == 0 and _rel(b, bj) == 0


def test_sobol_matches():
    np.testing.assert_array_equal(tsamp.sobol_1d(777), jsamp.sobol_1d(777))
    np.testing.assert_array_equal(
        tsamp.featuremap_coords((5, 7)).numpy(),
        _np(jsamp.featuremap_coords((5, 7))))


@pytest.mark.parametrize("density", [0.002, 0.05, 0.5, 1.0])
def test_masked_sobol_gather_same_indices(density):
    rng = np.random.default_rng(int(density * 1000))
    valid = rng.uniform(size=96 * 128) < density
    idx_t, ok_t = tsamp.masked_sobol_gather(torch.from_numpy(valid), 500)
    idx_j, ok_j = jsamp.masked_sobol_gather(jnp.asarray(valid), 500)
    np.testing.assert_array_equal(ok_t.numpy(), _np(ok_j))
    np.testing.assert_array_equal(idx_t.numpy()[ok_t.numpy()],
                                  _np(idx_j)[_np(ok_j)])


def test_nopad_padder():
    shape = (1, 64, 96, 3)
    x = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    tp = tpad.make_padder("nopad", shape)
    jp = jpad.make_padder("nopad", shape)
    (pt,) = tp.pad(_t(x))
    (pj,) = jp.pad(jnp.asarray(x))
    np.testing.assert_array_equal(pt.numpy(), _np(pj))
    np.testing.assert_array_equal(tp.unpad(pt).numpy(), _np(jp.unpad(pj)))
    with pytest.raises(ValueError):
        tpad.make_padder("nopad", (1, 60, 96, 3))
    with pytest.raises(ValueError):
        tpad.make_padder("reflect", shape)


def _img(seed, shape=(1, 96, 128, 3)):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def _max_step(img):
    return max(np.abs(np.diff(img, axis=1)).max(),
               np.abs(np.diff(img, axis=2)).max())


def test_grid_sample_matches():
    img = _img(0)
    coords = np.random.default_rng(1).uniform(-5, 140, (1, 40, 30, 2)).astype(
        np.float32)
    for mode in ("bilinear", "nearest"):
        got = twarp.grid_sample(_t(img), _t(coords), mode=mode)
        want = jwarp.grid_sample(jnp.asarray(img), jnp.asarray(coords),
                                 mode=mode)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)


_ULPS_255 = 4 * np.spacing(np.float32(255))

# (H, exact inverse in both packages)
_POSES = {
    "subpixel translation": (np.array([[1, 0, 0.5], [0, 1, -0.25],
                                       [0, 0, 1]]), True),
    "90 deg, 2x scale": (np.array([[0, -2, 150.0], [2, 0, -20.0],
                                   [0, 0, 1]]), True),
    "fully out of bounds": (np.array([[1, 0, 1e4], [0, 1, -3e3],
                                      [0, 0, 1]]), True),
    "30 deg, 1.5x, perspective": (np.array(
        [[1.299, -0.75, 40.0], [0.75, 1.299, -30.0], [1e-4, -2e-4, 1]]),
        False),
}


@pytest.mark.parametrize("name", list(_POSES))
def test_warp_perspective_fast_matches_jax(name):
    """The port's pre-warp (plain path on CPU) against the JAX pre-warp
    with its Pallas block warp in interpret mode (gather fallback outside
    the kernel's pose envelope)."""
    H, exact = _POSES[name]
    H = H.astype(np.float32)
    img = _img(2)
    got = twarp.warp_perspective_fast(_t(img), _t(H)).numpy()
    want = _np(jwarp.warp_perspective_fast(
        jnp.asarray(img), jnp.asarray(H), use_pallas=True, interpret=True))
    ct = twarp.perspective_coords(_t(H)[None], (96, 128)).numpy()
    cj = _np(jwarp.perspective_coords(jnp.asarray(H)[None], (96, 128)))
    delta = np.abs(ct - cj).max()
    assert delta <= 1e-4
    if exact:
        assert delta == 0
        np.testing.assert_allclose(got, want, atol=_ULPS_255, rtol=0)
        for mode in ("bilinear", "nearest"):
            np.testing.assert_allclose(
                twarp.warp_perspective(_t(img), _t(H), mode=mode).numpy(),
                _np(jwarp.warp_perspective(jnp.asarray(img), jnp.asarray(H),
                                           mode=mode)),
                atol=1e-5, rtol=0)
    else:
        assert np.abs(got - want).max() <= (_ULPS_255
                                            + 2 * delta * _max_step(img))
    if name == "fully out of bounds":
        assert np.abs(got).max() == 0


@pytest.mark.parametrize("name", ["subpixel translation", "90 deg, 2x scale"])
def test_warp_validity_at(name):
    H = _POSES[name][0].astype(np.float32)
    pts = np.random.default_rng(3).integers(-200, 300, (500, 2))
    got = twarp.warp_validity_at(_t(H), (96, 128), _t(pts)).numpy()
    want = _np(jwarp.warp_validity_at(jnp.asarray(H), (96, 128),
                                      jnp.asarray(pts)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_resampling_ops():
    x = _img(4, (2, 12, 16, 2))
    np.testing.assert_allclose(twarp.upflow8(_t(x)).numpy(),
                               _np(jwarp.upflow8(jnp.asarray(x))),
                               atol=1e-4, rtol=1e-6)
    np.testing.assert_allclose(
        twarp.avg_pool2d(_t(x)).numpy(),
        _np(jwarp.avg_pool2d(jnp.asarray(x))), atol=1e-4, rtol=1e-6)
    np.testing.assert_array_equal(twarp.coords_grid(2, 5, 7).numpy(),
                                  _np(jwarp.coords_grid(2, 5, 7)))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_warp_perspective_tile_cutting_shapes(channels):
    """``warp_perspective`` (what the card holds kernel A against) equals
    the JAX warp at the shapes that cut the kernel's 32 x 8 tiles and its
    channel templates: 1, 3 and 4 channels, a 37 x 45 output from a 41 x 53
    source, a batch of two, one pose general and one that puts part of the
    output outside the source. Tolerance as for general poses above: 1e-5
    plus the coordinate difference of the two inverses times the image's
    largest step."""
    img = _img(5, (2, 41, 53, channels))
    H = np.array([[[1.05, -0.12, 2.5], [0.10, 0.97, -1.75],
                   [2e-4, -1e-4, 1.0]],
                  [[0.80, 0.30, 24.0], [-0.25, 0.90, -14.0],
                   [-3e-4, 5e-4, 1.0]]], np.float32)
    got = twarp.warp_perspective(_t(img), _t(H), out_shape=(37, 45)).numpy()
    want = _np(jwarp.warp_perspective(jnp.asarray(img), jnp.asarray(H),
                                      out_shape=(37, 45)))
    ct = twarp.perspective_coords(_t(H), (37, 45)).numpy()
    cj = _np(jwarp.perspective_coords(jnp.asarray(H), (37, 45)))
    delta = np.abs(ct - cj).max()
    assert delta <= 1e-4
    assert got.shape == want.shape == (2, 37, 45, channels)
    assert np.abs(got - want).max() <= 1e-5 + 2 * delta * _max_step(img)
    # the second pose leaves part of the output without a source pixel
    outside = (ct[1, ..., 0] <= -1) | (ct[1, ..., 0] >= 53) | (
        ct[1, ..., 1] <= -1) | (ct[1, ..., 1] >= 41)
    assert 0.05 < outside.mean() < 0.95
    assert np.abs(got[1][outside]).max() == 0.0
    assert (np.abs(got).max(-1) > 0).mean(axis=(1, 2)).min() > 0.05
