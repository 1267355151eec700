"""Parity of the port's correlation pyramid and lookup (kernel B's plain
version, the path CPU tensors take) with ``woft_tpu`` on the CPU.

Tolerance 1e-5 absolute on correlation values of order 1: the pyramid is a
float32 matmul in two libraries (sums in another order), and the lookup is
a 4-corner bilinear blend of the same values. The indexed lookup must equal
the lookup of the gathered sub-pyramid exactly (same arithmetic).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.models import corr as jcorr
from woft_tpu_torch.models import corr as tcorr

TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    f1 = rng.normal(size=(1, 12, 20, 64)).astype(np.float32)
    f2 = rng.normal(size=(1, 12, 20, 64)).astype(np.float32)
    pyr_j, mean_j = jcorr.corr_pyramid_fused(jnp.asarray(f1),
                                             jnp.asarray(f2), 4)
    pyr_t, mean_t = tcorr.corr_pyramid_fused(torch.from_numpy(f1),
                                             torch.from_numpy(f2), 4)
    coords = rng.uniform(-30, 40, (1, 12, 20, 2)).astype(np.float32)
    coords[0, 0, :3] = [[-500.0, 3.0], [2e4, -7e3], [-5.0, -5.0]]
    return pyr_j, mean_j, pyr_t, mean_t, coords


def test_pyramid_and_mean_response(setup):
    pyr_j, mean_j, pyr_t, mean_t, _ = setup
    assert [tuple(p.shape) for p in pyr_t] == [p.shape for p in pyr_j]
    for pt, pj in zip(pyr_t, pyr_j):
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=TOL,
                                   rtol=0)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=TOL,
                               rtol=0)


def test_all_pairs_correlation():
    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(2, 6, 8, 32)).astype(np.float32)
    f2 = rng.normal(size=(2, 6, 8, 32)).astype(np.float32)
    np.testing.assert_allclose(
        tcorr.all_pairs_correlation(torch.from_numpy(f1),
                                    torch.from_numpy(f2)).numpy(),
        np.asarray(jcorr.all_pairs_correlation(jnp.asarray(f1),
                                               jnp.asarray(f2))),
        atol=TOL, rtol=0)


def test_lookup_matches_onehot(setup):
    pyr_j, _, pyr_t, _, coords = setup
    got = tcorr.corr_lookup(pyr_t, torch.from_numpy(coords), 4).numpy()
    want = np.asarray(jcorr.corr_lookup(pyr_j, jnp.asarray(coords), 4,
                                        impl="onehot"))
    assert got.shape == want.shape == (1, 12, 20, 324)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # windows entirely outside every level are exact zeros
    assert np.abs(got[0, 0, :2]).max() == 0.0


def test_lookup_matches_pallas_interpret():
    """Against the TPU kernel itself (``fused_corr_lookup``), run in
    interpret mode as the JAX package's own tests run it (a smaller
    pyramid: interpret mode runs the kernel op by op)."""
    from woft_tpu.ops.pallas import corr_lookup as pcl
    import jax.experimental.pallas as pl

    rng = np.random.default_rng(3)
    f1 = rng.normal(size=(1, 8, 8, 32)).astype(np.float32)
    f2 = rng.normal(size=(1, 8, 8, 32)).astype(np.float32)
    coords = rng.uniform(-15, 20, (1, 8, 8, 2)).astype(np.float32)
    pyr_j, _ = jcorr.corr_pyramid_fused(jnp.asarray(f1), jnp.asarray(f2), 4)
    orig = pl.pallas_call
    pcl.pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
    try:
        want = np.asarray(pcl.fused_corr_lookup(
            pcl.pad_pyramid(pyr_j, 4), jnp.asarray(coords), radius=4, tq=8))
    finally:
        pcl.pl.pallas_call = orig
    pyr_t = [torch.tensor(np.asarray(p)) for p in pyr_j]
    got = tcorr.corr_lookup(pyr_t, torch.from_numpy(coords), 4).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_indexed_lookup(setup):
    """The sparse weight head's form: M cells (with duplicates) read their
    pyramid rows in place."""
    pyr_j, _, pyr_t, _, coords = setup
    rng = np.random.default_rng(2)
    cells = rng.integers(0, 240, 45)
    cells[5:10] = cells[0]
    c = coords.reshape(240, 2)[cells][None, None]
    cells_t = torch.from_numpy(cells)
    got = tcorr.corr_lookup(pyr_t, torch.from_numpy(c), 4, rows=cells_t)
    sub = tcorr.corr_lookup([p[cells_t] for p in pyr_t], torch.from_numpy(c),
                            4)
    assert got.shape == (1, 1, 45, 324)
    np.testing.assert_array_equal(got.numpy(), sub.numpy())
    want = np.asarray(jcorr.corr_lookup([p[cells] for p in pyr_j],
                                        jnp.asarray(c), 4, impl="onehot"))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_channel_order_quirk():
    """Channel l*81 + i*9 + j samples (x + i - r, y + j - r): i offsets x."""
    corr_l = torch.zeros(1, 16, 16)
    corr_l[0, 5, 9] = 1.0                          # row y = 5, column x = 9
    out = tcorr.corr_lookup([corr_l], torch.tensor([[[[7.0, 4.0]]]]), 4)
    ch = int(out.reshape(-1).argmax())
    i, j = divmod(ch, 9)
    assert (7 + i - 4, 4 + j - 4) == (9, 5)


def _odd_pyramid(levels, seed):
    """A pyramid over an 11 x 13 level-0 map (143 queries): the deeper
    levels are 5 x 6, 2 x 3 and 1 x 1, none a multiple of a kernel tile."""
    rng = np.random.default_rng(seed)
    lv = rng.normal(size=(11 * 13, 11, 13)).astype(np.float32)
    pyr = [lv]
    for _ in range(levels - 1):
        h, w = lv.shape[1] // 2, lv.shape[2] // 2
        lv = lv[:, :2 * h, :2 * w].reshape(-1, h, 2, w, 2).mean(axis=(2, 4))
        pyr.append(lv)
    return pyr


def _border_coords(seed):
    """(1, 11, 13, 2) coordinates on the 11 x 13 map: exact integers, each
    of the four borders straddled, 1e4 outside, the rest random around and
    beyond the map."""
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.uniform(-8, 21, (11, 13)),
                       rng.uniform(-8, 19, (11, 13))], -1).astype(np.float32)
    coords[0, :11] = [[3.0, 4.0], [0.0, 0.0], [12.0, 10.0],      # integers
                      [-0.5, 5.25], [12.5, 5.25],                # left, right
                      [6.75, -0.5], [6.75, 10.5],                # top, bottom
                      [-0.25, -0.75], [12.25, 10.75],            # corners
                      [1e4, 3.0], [-1e4, -1e4]]                  # far outside
    return coords[None]


@pytest.mark.parametrize("levels", [1, 4])
@pytest.mark.parametrize("radius", [1, 3, 4])
def test_lookup_plain_odd_sizes_and_borders(radius, levels):
    """``corr_lookup_plain`` (what the card holds kernel B against) equals
    the JAX lookup to 1e-5 absolute at the shapes that cut the kernel's
    tiles: every template radius, one and four levels, odd level sizes down
    to 1 x 1, integer, border-straddling and far-out coordinates."""
    pyr = _odd_pyramid(levels, seed=10 + levels)
    coords = _border_coords(seed=20 + radius)
    got = tcorr.corr_lookup_plain([torch.from_numpy(p) for p in pyr],
                                  torch.from_numpy(coords), radius).numpy()
    want = np.asarray(jcorr.corr_lookup([jnp.asarray(p) for p in pyr],
                                        jnp.asarray(coords), radius,
                                        impl="onehot"))
    k = 2 * radius + 1
    assert got.shape == want.shape == (1, 11, 13, levels * k * k)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.abs(got[0, 0, 9:11]).max() == 0.0       # the far-out queries
    assert np.abs(got[0, 0, :9]).max() > 0.0


@pytest.mark.parametrize("levels", [1, 4])
@pytest.mark.parametrize("radius", [1, 3, 4])
def test_indexed_lookup_plain_equals_dense_at_cells(radius, levels):
    """The ``rows=`` form with duplicate cells equals the dense lookup's
    rows at those cells (same arithmetic: exact)."""
    pyr = [torch.from_numpy(p) for p in _odd_pyramid(levels, seed=30)]
    coords = torch.from_numpy(_border_coords(seed=31))
    rng = np.random.default_rng(32)
    cells = rng.integers(0, 143, 50)
    cells[:11] = np.arange(11)                 # the border cases
    cells[20:30] = cells[3]                    # duplicates
    cells_t = torch.from_numpy(cells)
    dense = tcorr.corr_lookup_plain(pyr, coords, radius).reshape(143, -1)
    got = tcorr.corr_lookup_plain(pyr, coords.reshape(143, 2)[cells_t],
                                  radius, rows=cells_t)
    assert got.shape == (50, dense.shape[1])
    np.testing.assert_allclose(got.numpy(), dense[cells_t].numpy(), atol=TOL,
                               rtol=0)
