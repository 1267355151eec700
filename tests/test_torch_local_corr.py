"""Parity of the port's block-local correlation (kernels C, D, E, F through
their plain versions, the path CPU tensors take) with ``woft_tpu`` on the
CPU. The JAX side's Pallas kernels run in interpret mode, patched by
``tests/test_corr_impls.py:_interpret_pallas``.

The port's lookups take each query's integer slab start and fraction; the
TPU kernels take them expanded into two-hot weight rows. The tests expand
the port's starts and fractions into those rows for the JAX kernels.

Tolerances: the volume is a float32 product in two libraries (atol 2e-5,
rtol 1e-5, as the JAX package's own p-layout test); bf16 volumes agree to
one bf16 ulp (2^-8 relative; 2^-7 covers every mantissa) because the
float32 sums differ in the last bits before the one rounding. The lookups
blend the same four taps in the same order: 1e-6 absolute on float32
outputs (XLA's CPU code may contract a multiply-add), one bf16 ulp on bf16
outputs.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_corr_impls import _interpret_pallas

from woft_tpu.models import corr as jcorr
from woft_tpu.ops.pallas import local_corr as plc
from woft_tpu.ops.pallas import local_lookup as pll
from woft_tpu_torch.models import corr as tcorr


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once, and torch's
    default of one intra-op thread a core makes this module's many small
    operations wait on each other's threads. Two threads while the module
    runs, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


K = 9
RADIUS = 4
VOL_ATOL, VOL_RTOL = 2e-5, 1e-5
LOOKUP_ATOL = 1e-6
BF16_ULP = 2.0 ** -7


def interpret_pallas():
    return _interpret_pallas(plc, pll)


def assert_bf16_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert (np.abs(got - want) <= 1e-6 + BF16_ULP * np.abs(want)).all()


def grid_coords(H1, W1):
    ys, xs = np.meshgrid(np.arange(H1, dtype=np.float32),
                         np.arange(W1, dtype=np.float32), indexing="ij")
    return np.stack([xs, ys], -1)[None]


def two_hot(start, frac, n):
    """(NB, BQ) starts and fractions -> (NB, n, BQ) two-hot weight rows."""
    ids = np.arange(n)[None, :, None]
    s, f = start[:, None, :], frac[:, None, :]
    return ((ids == s) * (1.0 - f) + (ids == s + 1) * f).astype(np.float32)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("margin", [8, 16])
@pytest.mark.parametrize("hw", [(16, 32), (90, 160), (135, 240), (21, 50),
                                (24, 43)])
def test_layout_matches_jax(hw, margin):
    want = jcorr._local_layout(*hw, RADIUS, 4, margin, (8, 16))
    got = tcorr._local_layout(*hw, RADIUS, 4, margin)
    for key in ("H1", "W1", "bh", "bw", "nbh", "nbw"):
        assert got[key] == want[key]
    assert list(got["levels"]) == [dict(lv) for lv in want["levels"]]
    for d, lv in zip(got["levels"], want["levels"]):
        assert tcorr._fine_extents(d, K) == jcorr._fine_extents(dict(lv), K)


def test_layout_720p():
    """The 1280x720 shapes the card's path runs (margin 16)."""
    meta = tcorr._local_layout(90, 160, RADIUS, 4, 16)
    assert (meta["nbh"], meta["nbw"]) == (12, 10)
    rows = [(d["sh"], d["sw"], d["pad"], d["wh"], d["ww"])
            + tcorr._fine_extents(d, K) for d in meta["levels"]]
    assert rows == [(8, 16, 21, 50, 64, 24, 40), (4, 8, 13, 30, 40, 20, 32),
                    (2, 4, 10, 22, 32, 18, 32), (1, 2, 10, 21, 32, 17, 32)]
    positions = sum(d["wh"] * d["ww"] for d in meta["levels"])
    assert positions == 3200 + 1200 + 704 + 672
    assert 2 * 120 * 128 * positions == 177_438_720      # bf16 volume bytes


def test_blocked_round_trip():
    meta = tcorr._local_layout(21, 50, RADIUS, 2, 8)
    x = np.random.default_rng(0).normal(size=(21 * 50, 3)).astype(np.float32)
    blocked = tcorr._to_blocked(torch.from_numpy(x), meta)
    jmeta = jcorr._local_layout(21, 50, RADIUS, 2, 8, (8, 16))
    np.testing.assert_array_equal(
        blocked.numpy(), np.asarray(jcorr._to_blocked(jnp.asarray(x), jmeta)))
    np.testing.assert_array_equal(tcorr._from_blocked(blocked, meta).numpy(),
                                  x)


# ---------------------------------------------------------------------------
# kernel C: construction
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(8)
    return (rng.normal(size=(1, 16, 32, 64)).astype(np.float32),
            rng.normal(size=(1, 16, 32, 64)).astype(np.float32))


@pytest.fixture(scope="module")
def volumes(features):
    """float32 volumes of both packages (3 levels, margin 8); the JAX one
    from the Pallas construction kernel in interpret mode."""
    f1, f2 = features
    with interpret_pallas():
        vj = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                    radius=RADIUS, num_levels=3, margin=8,
                                    use_pallas=True, layout="p")
    vt = tcorr.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                RADIUS, 3, 8)
    return vj, vt


def test_build_matches_pallas_and_q_layout(features, volumes):
    f1, f2 = features
    vj, vt = volumes
    vq = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                radius=RADIUS, num_levels=3, margin=8,
                                use_pallas=False, layout="q")
    nb, bq = 4, 128
    for got, want_p, want_q in zip(vt.volumes, vj.volumes, vq.volumes):
        assert got.dtype == torch.float32
        assert tuple(got.shape) == want_p.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want_p),
                                   atol=VOL_ATOL, rtol=VOL_RTOL)
        _, wh, ww, _ = got.shape
        want = np.asarray(want_q).reshape(nb, bq, wh, ww).transpose(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=VOL_ATOL,
                                   rtol=VOL_RTOL)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas"])
def test_build_bf16_matches_jax(features, use_pallas):
    f1, f2 = features
    with interpret_pallas():
        vj = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                    radius=RADIUS, num_levels=3, margin=8,
                                    out_dtype=jnp.bfloat16,
                                    use_pallas=use_pallas, layout="p")
    vt = tcorr.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                RADIUS, 3, 8, out_dtype=torch.bfloat16)
    for got, want in zip(vt.volumes, vj.volumes):
        assert got.dtype == torch.bfloat16
        assert_bf16_close(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


def test_build_pads_the_last_block_row():
    """H1 % 8 != 0: the padding queries of the last block row are zero
    features, so their volume entries are zero."""
    rng = np.random.default_rng(1)
    f1 = torch.from_numpy(rng.normal(size=(1, 12, 16, 32)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(1, 12, 16, 32)).astype(np.float32))
    v = tcorr.build_local_corr(f1, f2, RADIUS, 2, 8)
    vol = v.volumes[0].reshape(2, -1, 8, 16)       # block, window, qy, qx
    assert vol[1, :, 4:].abs().max() == 0.0
    assert vol[1, :, :4].abs().max() > 0.0


# ---------------------------------------------------------------------------
# kernels D, E, F: lookups
# ---------------------------------------------------------------------------

def smooth_coords(H1, W1, saturate_first_rows=8):
    """A global affine residual (up to ~6 cells) plus a far-out band over a
    whole block row: every block fits its fine window."""
    grid = grid_coords(H1, W1)
    xs, ys = grid[0, ..., 0], grid[0, ..., 1]
    res = np.stack([0.15 * ys - 0.1 * xs + 2.3,
                    0.12 * xs + 0.05 * ys - 3.1], -1)[None]
    coords = grid + res.astype(np.float32)
    coords[0, :saturate_first_rows] += 400.0
    return coords


def jitter_coords(H1, W1, seed=9):
    """Independent jitter of +-7 cells and a band pushed 300 cells out."""
    rng = np.random.default_rng(seed)
    grid = grid_coords(H1, W1)
    res = rng.uniform(-7.0, 7.0, grid.shape).astype(np.float32)
    res[0, :4] += 300.0
    return grid + res


def test_exact_lookup_matches_pallas(volumes):
    """E against ``block_local_lookup``: jitter and saturation."""
    vj, vt = volumes
    coords = jitter_coords(16, 32)
    starts, frac = tcorr._local_level_coords(vt, torch.from_numpy(coords))
    for lvl, (vol_t, vol_j) in enumerate(zip(vt.volumes, vj.volumes)):
        _, wh, ww, _ = vol_t.shape
        got = tcorr.block_local_lookup(vol_t, starts[lvl], frac[lvl], K)
        s, f = starts[lvl].numpy(), frac[lvl].numpy()
        assert s.min() >= 0 and s[0].max() <= wh - K - 1 \
            and s[1].max() <= ww - K - 1
        wy = two_hot(s[0], f[0], wh - K + 1)
        wx = two_hot(s[1], f[1], ww - K + 1)
        with interpret_pallas():
            want = pll.block_local_lookup(vol_j, jnp.asarray(wy),
                                          jnp.asarray(wx), K)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOOKUP_ATOL, rtol=0)


@pytest.mark.parametrize("out_bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("field", ["smooth", "violating"])
def test_fine_lookups_match_pallas(volumes, field, out_bf16):
    """D against ``block_local_lookup_fine_multi`` and F against
    ``block_local_lookup_fine``. On the violating field some blocks' starts
    exceed the fine window: both sides must saturate at its edge."""
    vj, vt = volumes
    coords = (smooth_coords(16, 32) if field == "smooth"
              else jitter_coords(16, 32))
    starts, frac = tcorr._local_level_coords(vt, torch.from_numpy(coords))
    rcs, rel, ok = tcorr._fine_anchor_starts(vt, starts)
    assert bool(ok.all()) == (field == "smooth")
    exts = vt.consts["exts"]
    wyfs = [jnp.asarray(two_hot(rel[l, 0].numpy(), frac[l, 0].numpy(),
                                exts[l][0] - K + 1)) for l in range(3)]
    wxfs = [jnp.asarray(two_hot(rel[l, 1].numpy(), frac[l, 1].numpy(),
                                exts[l][1] - K + 1)) for l in range(3)]
    od_t = torch.bfloat16 if out_bf16 else torch.float32
    od_j = jnp.bfloat16 if out_bf16 else None
    close = assert_bf16_close if out_bf16 else (
        lambda a, b: np.testing.assert_allclose(a, b, atol=LOOKUP_ATOL,
                                                rtol=0))

    got = tcorr.block_local_lookup_fine_multi(rcs, vt.volumes, rel, frac, K,
                                              od_t)
    with interpret_pallas():
        want = pll.block_local_lookup_fine_multi(
            jnp.asarray(rcs.numpy()), list(vj.volumes), wyfs, wxfs, K, exts,
            out_dtype=od_j)
    assert got.dtype == od_t and tuple(got.shape) == want.shape == (4, 243,
                                                                    128)
    close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))

    lvl = 1
    rc0 = rcs[:, lvl].contiguous()
    got_f = tcorr.block_local_lookup_fine(rc0, vt.volumes[lvl], rel[lvl],
                                          frac[lvl], K, od_t)
    with interpret_pallas():
        want_f = pll.block_local_lookup_fine(
            jnp.asarray(rc0.numpy()), vj.volumes[lvl], wyfs[lvl], wxfs[lvl],
            K, *exts[lvl], out_dtype=od_j)
    close(got_f.float().numpy(), np.asarray(want_f.astype(jnp.float32)))
    # F is D's level
    assert torch.equal(got_f, got[:, lvl * 81:(lvl + 1) * 81])


def test_fine_anchors_match_jax(volumes):
    """Anchors, relative starts, fractions and the per-block verdict equal
    ``_fine_anchor_weights`` (8-aligned column anchors included)."""
    vj, vt = volumes
    for coords in (smooth_coords(16, 32), jitter_coords(16, 32)):
        starts, frac = tcorr._local_level_coords(vt, torch.from_numpy(coords))
        rcs, rel, ok = tcorr._fine_anchor_starts(vt, starts)
        cb = jcorr._to_blocked(jnp.asarray(coords).reshape(16 * 32, 2),
                               vj.meta).reshape(4, 128, 2)
        ok_j = np.ones(4, bool)
        for lvl, (d, c) in enumerate(jcorr._local_level_coords(vj, cb,
                                                               RADIUS)):
            fr, fc = jcorr._fine_extents(d, K)
            r0, wy, oy = jcorr._fine_anchor_weights(c[..., 1], d["wh"],
                                                    RADIUS, fr)
            c0, wx, ox = jcorr._fine_anchor_weights(c[..., 0], d["ww"],
                                                    RADIUS, fc, align=8)
            ok_j &= np.asarray(oy) & np.asarray(ox)
            np.testing.assert_array_equal(rcs[:, lvl, 0].numpy(),
                                          np.asarray(r0))
            np.testing.assert_array_equal(rcs[:, lvl, 1].numpy(),
                                          np.asarray(c0))
            np.testing.assert_allclose(
                two_hot(rel[lvl, 0].numpy(), frac[lvl, 0].numpy(),
                        fr - K + 1), np.asarray(wy), atol=1e-6)
            np.testing.assert_allclose(
                two_hot(rel[lvl, 1].numpy(), frac[lvl, 1].numpy(),
                        fc - K + 1), np.asarray(wx), atol=1e-6)
        np.testing.assert_array_equal(ok.numpy(), ok_j)


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def big_volumes():
    """72 blocks (> 64): the JAX guard takes its scatter-correction
    branches. 2 levels, D = 32, as the JAX package's own test."""
    rng = np.random.default_rng(13)
    f1 = rng.normal(size=(1, 72, 128, 32)).astype(np.float32)
    f2 = rng.normal(size=(1, 72, 128, 32)).astype(np.float32)
    with interpret_pallas():
        vj = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                    radius=RADIUS, num_levels=2, margin=8,
                                    use_pallas=True, layout="p")
    vt = tcorr.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                RADIUS, 2, 8)
    return vj, vt


@pytest.mark.parametrize("violators", ["none", "few", "many"])
def test_guard_matches_jax(big_volumes, violators):
    """``check=True`` equals the JAX guard's result (its fine-only,
    scatter-correction and all-exact branches) and the exact lookup."""
    vj, vt = big_volumes
    rng = np.random.default_rng(14)
    grid = grid_coords(72, 128)
    res = rng.uniform(-1.5, 1.5, grid.shape).astype(np.float32)
    if violators == "few":
        for by, bx in ((0, 0), (4, 3), (8, 7)):
            res[0, by * 8:(by + 1) * 8, bx * 16:(bx + 1) * 16] += \
                rng.uniform(-25.0, 25.0, (8, 16, 2)).astype(np.float32)
    elif violators == "many":
        res += rng.uniform(-25.0, 25.0, grid.shape).astype(np.float32)
    coords = grid + res
    ct = torch.from_numpy(coords)
    starts, _ = tcorr._local_level_coords(vt, ct)
    n_bad = int((~tcorr._fine_anchor_starts(vt, starts)[2]).sum())
    assert {"none": n_bad == 0, "few": 0 < n_bad <= 32,
            "many": n_bad > 32}[violators]

    got = tcorr.corr_lookup_local_blocked(vt, ct, RADIUS).data
    exact = tcorr.corr_lookup_local_blocked(vt, ct, RADIUS, fine=False).data
    np.testing.assert_array_equal(got.numpy(), exact.numpy())
    with interpret_pallas():
        want = jcorr.corr_lookup_local_blocked(vj, jnp.asarray(coords),
                                               RADIUS).data
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    if violators != "none":
        unchecked = tcorr.corr_lookup_local_blocked(vt, ct, RADIUS,
                                                    check=False).data
        assert (unchecked - exact).abs().max() > 1e-3


def test_guard_with_padding_queries():
    """H1 % 8 != 0: the last block row's padding queries sit at coordinate
    (0, 0) in both packages. At margin 16 that is further from the real
    queries' starts than the fine window is tall, so those blocks violate
    on any field and the guard rewrites them (the 720p grid, 90 rows, is
    such a size). The real queries' rows
    equal the JAX guard's and the exact lookup."""
    rng = np.random.default_rng(21)
    H1, W1 = 20, 32
    f1 = rng.normal(size=(1, H1, W1, 32)).astype(np.float32)
    f2 = rng.normal(size=(1, H1, W1, 32)).astype(np.float32)
    coords = grid_coords(H1, W1) + rng.uniform(-1.5, 1.5, (1, H1, W1, 2)
                                               ).astype(np.float32)
    vt = tcorr.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                RADIUS, 2, 16)
    ct = torch.from_numpy(coords)
    starts, _ = tcorr._local_level_coords(vt, ct)
    ok = tcorr._fine_anchor_starts(vt, starts)[2].numpy()
    np.testing.assert_array_equal(ok, [True] * 4 + [False] * 2)
    got = tcorr.corr_lookup_local_blocked(vt, ct, RADIUS)
    exact = tcorr.corr_lookup_local_blocked(vt, ct, RADIUS, fine=False)
    np.testing.assert_array_equal(got.data.numpy(), exact.data.numpy())
    with interpret_pallas():
        vj = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                    radius=RADIUS, num_levels=2, margin=16,
                                    use_pallas=True, layout="p")
        want = jcorr.corr_lookup_local_blocked(vj, jnp.asarray(coords),
                                               RADIUS).to_natural()
    np.testing.assert_allclose(got.to_natural().numpy(), np.asarray(want),
                               atol=2e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the coordinate-driven pair (kernel D computing its starts, anchors and
# flags, kernel E its starts) through its plain composition
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def padded_volumes():
    """H1 % 8 != 0 (20 rows): the last block row holds padding queries at
    coordinate (0, 0). 2 levels, margin 16, D = 32."""
    rng = np.random.default_rng(22)
    f1 = rng.normal(size=(1, 20, 32, 32)).astype(np.float32)
    f2 = rng.normal(size=(1, 20, 32, 32)).astype(np.float32)
    with interpret_pallas():
        vj = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                    radius=RADIUS, num_levels=2, margin=16,
                                    use_pallas=True, layout="p")
    vt = tcorr.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                RADIUS, 2, 16)
    return vj, vt


def field(kind, volumes, padded_volumes):
    """(vj, vt, coords) of one field: 'smooth' (every block fits),
    'saturated' (the whole field beyond the margin), 'violating' (jitter
    beyond the fine windows), 'padding' (H1 % 8 != 0)."""
    if kind == "padding":
        vj, vt = padded_volumes
        rng = np.random.default_rng(23)
        coords = grid_coords(20, 32) + rng.uniform(
            -1.5, 1.5, (1, 20, 32, 2)).astype(np.float32)
        return vj, vt, coords
    vj, vt = volumes
    if kind == "smooth":
        return vj, vt, smooth_coords(16, 32)
    if kind == "violating":
        return vj, vt, jitter_coords(16, 32)
    rng = np.random.default_rng(24)
    coords = grid_coords(16, 32) + np.float32([40.0, -35.0])
    coords += rng.uniform(-3.0, 3.0, coords.shape).astype(np.float32)
    return vj, vt, coords.astype(np.float32)


_JAX_LOOKUPS = {}


@pytest.mark.parametrize("mode", ["guarded", "unchecked", "exact"])
@pytest.mark.parametrize("kind", ["smooth", "saturated", "violating",
                                  "padding"])
def test_coord_lookup_matches_jax(volumes, padded_volumes, kind, mode):
    """The plain composition of kernels D and E from coordinates (what a
    CPU tensor takes) equals JAX ``corr_lookup_local_blocked`` with
    ``fine=True, check=True``, ``check=False`` and ``fine=False``."""
    vj, vt, coords = field(kind, volumes, padded_volumes)
    kw = {"guarded": {}, "unchecked": {"check": False},
          "exact": {"fine": False}}[mode]
    got = tcorr.corr_lookup_local_blocked(vt, torch.from_numpy(coords),
                                          RADIUS, **kw).data
    key = (id(vj), mode)
    if key not in _JAX_LOOKUPS:     # one trace a volume and mode
        _JAX_LOOKUPS[key] = jax.jit(
            lambda c: jcorr.corr_lookup_local_blocked(vj, c, RADIUS,
                                                      **kw).data)
    with interpret_pallas():
        want = _JAX_LOOKUPS[key](jnp.asarray(coords))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kind", ["smooth", "saturated", "violating",
                                  "padding"])
def test_coord_lookup_flags_match_jax(volumes, padded_volumes, kind):
    """The (NB, L) flags of kernel D's plain version are the per-level
    negation of JAX ``_fine_anchor_weights``' ``ok``; its data equals the
    explicit-operand lookup, and kernel E's plain version from coordinates
    equals the one from explicit starts."""
    vj, vt, coords = field(kind, volumes, padded_volumes)
    ct = torch.from_numpy(coords)
    data, bad = tcorr.block_local_lookup_coords(vt, ct, K, torch.float32)
    meta = vj.meta
    nb = meta["nbh"] * meta["nbw"]
    cb = jcorr._to_blocked(jnp.asarray(coords).reshape(
        meta["H1"] * meta["W1"], 2), meta).reshape(nb, 128, 2)
    want = []
    for d, c in jcorr._local_level_coords(vj, cb, RADIUS):
        fr, fc = jcorr._fine_extents(d, K)
        oy = jcorr._fine_anchor_weights(c[..., 1], d["wh"], RADIUS, fr)[2]
        ox = jcorr._fine_anchor_weights(c[..., 0], d["ww"], RADIUS, fc,
                                        align=8)[2]
        want.append(~(np.asarray(oy) & np.asarray(ox)))
    assert bad.dtype == torch.uint8
    np.testing.assert_array_equal(bad.numpy(), np.stack(want, 1))
    assert bool(bad.any()) == (kind in ("violating", "padding"))

    starts, frac = tcorr._local_level_coords(vt, ct)
    rcs, rel, ok = tcorr._fine_anchor_starts(vt, starts)
    np.testing.assert_array_equal(ok.numpy(), ~bad.bool().any(1).numpy())
    assert torch.equal(data, tcorr.block_local_lookup_fine_multi(
        rcs, vt.volumes, rel, frac, K))
    flag = bad.bool().any(1).to(torch.uint8)
    out_c, out_s = data.clone(), data.clone()
    tcorr.block_local_lookup_exact_coords(vt, ct, K, bad=bad, out=out_c)
    tcorr.block_local_lookup_levels(vt.volumes, starts, frac, K, flag=flag,
                                    out=out_s)
    assert torch.equal(out_c, out_s)
    assert torch.equal(tcorr.block_local_lookup_exact_coords(vt, ct, K),
                       tcorr.block_local_lookup_levels(vt.volumes, starts,
                                                       frac, K))


# ---------------------------------------------------------------------------
# layouts: to_natural, the dense lookup, blocked convc1
# ---------------------------------------------------------------------------

def test_to_natural_matches_q_layout_and_dense(features, volumes):
    """``to_natural`` undoes the y-major order: it equals the JAX q-layout
    one-hot lookup everywhere and, for centroids within the margin, the
    port's dense pyramid lookup."""
    f1, f2 = features
    _, vt = volumes
    rng = np.random.default_rng(5)
    coords = grid_coords(16, 32) + rng.uniform(-7.0, 7.0, (1, 16, 32, 2)
                                               ).astype(np.float32)
    got = tcorr.corr_lookup_local(vt, torch.from_numpy(coords), RADIUS,
                                  fine=False)
    vq = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                radius=RADIUS, num_levels=3, margin=8,
                                use_pallas=False, layout="q")
    want = np.asarray(jcorr.corr_lookup_local(vq, jnp.asarray(coords),
                                              RADIUS))
    assert tuple(got.shape) == want.shape == (1, 16, 32, 243)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)

    pyramid, _ = tcorr.corr_pyramid_fused(torch.from_numpy(f1),
                                          torch.from_numpy(f2), 3)
    dense = tcorr.corr_lookup(pyramid, torch.from_numpy(coords), RADIUS)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5,
                               rtol=1e-5)
    # the guarded fine path gives the same
    np.testing.assert_array_equal(
        tcorr.corr_lookup_local(vt, torch.from_numpy(coords), RADIUS).numpy(),
        got.numpy())


def test_blocked_convc1_equals_natural_conv(volumes):
    _, vt = volumes
    gen = torch.Generator().manual_seed(0)
    convc1 = torch.nn.Conv2d(243, 256, 1)
    with torch.no_grad():
        convc1.weight.copy_(torch.randn(convc1.weight.shape, generator=gen)
                            * 0.05)
        convc1.bias.copy_(torch.randn(256, generator=gen))
        blocked = tcorr.corr_lookup_local_blocked(
            vt, torch.from_numpy(smooth_coords(16, 32)), RADIUS)
        got = tcorr.lookup_conv1x1(blocked, convc1.weight, convc1.bias)
        want = tcorr.lookup_conv1x1(blocked.to_natural().permute(0, 3, 1, 2),
                                    convc1.weight, convc1.bias)
    assert tuple(got.shape) == (1, 256, 16, 32)
    # one 243-term float32 sum in two orders
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
