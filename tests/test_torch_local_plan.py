"""The Python side of the redesigned block-local kernels, on the CPU.

Kernel C (one launch a flow) walks each query block's window tiles on
every level from a level table that ``ops/kernels.py:local_corr_table``
builds from ``_local_layout``; the tests check that table's tiles cover
every (block, level, position) exactly once in whole window rows of at most
128 positions, that their TMA box origins are the windows' origins, and
that executing the tiles as the kernel does (boxes cut from the UNPADDED
level, zero outside it) gives the plain version's volume. Kernel E (one
launch a lookup) is held through its multi-level plain path against the
JAX ``block_local_lookup`` per level, and ``build_local_corr``'s one-call
route against the JAX ``build_local_corr``; the JAX side's Pallas kernels
run in interpret mode, as in ``tests/test_torch_local_corr.py``, whose
tolerances apply (float32 volumes atol 2e-5 + rtol 1e-5, bf16 volumes one
bf16 ulp, float32 lookups 1e-6).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_local_corr import (assert_bf16_close, interpret_pallas,
                                   jitter_coords, two_hot)

from woft_tpu.models import corr as jcorr
from woft_tpu.ops.pallas import local_lookup as pll
from woft_tpu_torch.models import corr as tcorr
from woft_tpu_torch.ops import kernels
from woft_tpu_torch.ops.warp import avg_pool2d

K = 9
RADIUS = 4
VOL_ATOL, VOL_RTOL = 2e-5, 1e-5
LOOKUP_ATOL = 1e-6


def level_table(meta):
    shapes = [(d["hl"], d["wl"]) for d in meta["levels"]]
    geoms = [(d["pad"], d["sh"], d["sw"], d["wh"], d["ww"])
             for d in meta["levels"]]
    return kernels.local_corr_table(shapes, geoms)


def tiles(table, nb, nbw):
    """The tiles of one launch in the order a CTA walks them: (block,
    level, first position, stored positions, box row, box column, box
    rows, box columns)."""
    for b in range(nb):
        by, bx = divmod(b, nbw)
        for lvl, (hl, wl, pad, sh, sw, wh, ww, rows, n) in enumerate(table):
            for t in range(n):
                p0 = t * rows * ww
                yield (b, lvl, p0, min(rows * ww, wh * ww - p0),
                       by * sh - pad + t * rows, bx * sw // 8 * 8 - pad,
                       rows, ww)


@pytest.mark.parametrize("margin", [4, 8, 16])
@pytest.mark.parametrize("hw", [(90, 160), (64, 96), (37, 53)],
                         ids=["90x160", "64x96", "37x53"])
def test_tile_plan_covers_every_position_once(hw, margin):
    meta = tcorr._local_layout(*hw, RADIUS, 4, margin)
    nbh, nbw = meta["nbh"], meta["nbw"]
    table = level_table(meta)
    consts = tcorr._lookup_constants(*hw, RADIUS, 4, margin,
                                     torch.device("cpu"))
    seen = [np.zeros((nbh * nbw, d["wh"] * d["ww"]), np.int64)
            for d in meta["levels"]]
    for b, lvl, p0, n, y, x, rows, ww in tiles(table, nbh * nbw, nbw):
        d = meta["levels"][lvl]
        assert ww == d["ww"] and 1 <= rows * ww <= 128
        assert p0 % ww == 0 and (n == rows * ww or p0 + n == d["wh"] * ww)
        seen[lvl][b, p0:p0 + n] += 1
        # the box origin is the window's origin in the unpadded level
        if p0 == 0:
            oy, ox = consts["origin"][lvl, :, b, 0].tolist()
            assert (y, x) == (oy - d["pad"], ox - d["pad"])
    assert all((s == 1).all() for s in seen)
    if hw == (90, 160) and margin == 16:
        assert [row[7:] for row in table] == [(2, 25), (3, 10), (4, 6),
                                              (4, 6)]


def run_plan(f1b, levels, meta):
    """Kernel C's tiles executed in plain PyTorch: each box cut from the
    unpadded level with zeros outside it, one float32 product, scaled,
    rounded once, its stored rows written."""
    nbh, nbw = meta["nbh"], meta["nbw"]
    D = f1b.shape[2]
    outs = [torch.full((nbh * nbw, d["wh"] * d["ww"], 128), float("nan"))
            for d in meta["levels"]]
    for b, lvl, p0, n, y, x, rows, ww in tiles(level_table(meta),
                                               nbh * nbw, nbw):
        lv = levels[lvl]
        hl, wl = lv.shape[:2]
        box = torch.zeros(rows, ww, D)
        ys = slice(max(y, 0), min(y + rows, hl))
        xs = slice(max(x, 0), min(x + ww, wl))
        if ys.start < ys.stop and xs.start < xs.stop:
            box[ys.start - y:ys.stop - y, xs.start - x:xs.stop - x] = \
                lv[ys, xs].float()
        prod = box.reshape(rows * ww, D) @ f1b[b].float().T
        outs[lvl][b, p0:p0 + n] = prod[:n] * (1.0 / math.sqrt(D))
    return [o.reshape(nbh * nbw, d["wh"], d["ww"], 128)
            for o, d in zip(outs, meta["levels"])]


@pytest.mark.parametrize("hw,margin", [((64, 96), 8), ((37, 53), 16)],
                         ids=["64x96m8", "37x53m16"])
def test_tile_plan_reproduces_the_volume(hw, margin):
    rng = np.random.default_rng(3)
    D = 32
    f1 = torch.from_numpy(rng.normal(size=(1, *hw, D)).astype(np.float32))
    f2 = torch.from_numpy(rng.normal(size=(1, *hw, D)).astype(np.float32))
    meta = tcorr._local_layout(*hw, RADIUS, 4, margin)
    nb = meta["nbh"] * meta["nbw"]
    f1b = tcorr._to_blocked(f1.reshape(-1, D), meta).reshape(nb, 128, D)
    levels = [f2]
    while len(levels) < 4:
        levels.append(avg_pool2d(levels[-1]))
    levels = [lv[0] for lv in levels]
    want = tcorr.block_local_corr_levels(f1b, levels, meta["levels"],
                                         meta["nbh"], meta["nbw"],
                                         torch.float32)
    for got, w in zip(run_plan(f1b, levels, meta), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), atol=VOL_ATOL,
                                   rtol=VOL_RTOL)


# ---------------------------------------------------------------------------
# build_local_corr through the one-call route, and kernel E over all levels
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def features_64x96():
    rng = np.random.default_rng(17)
    return (rng.normal(size=(1, 64, 96, 64)).astype(np.float32),
            rng.normal(size=(1, 64, 96, 64)).astype(np.float32))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_build_local_corr_one_call_matches_jax(features_64x96, bf16):
    f1, f2 = features_64x96
    with interpret_pallas():
        vj = jcorr.build_local_corr(
            jnp.asarray(f1), jnp.asarray(f2), radius=RADIUS, num_levels=4,
            margin=8, out_dtype=jnp.bfloat16 if bf16 else None,
            use_pallas=True, layout="p")
    vt = tcorr.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                RADIUS, 4, 8,
                                out_dtype=torch.bfloat16 if bf16 else None)
    assert len(vt.volumes) == len(vj.volumes) == 4
    for got, want in zip(vt.volumes, vj.volumes):
        assert tuple(got.shape) == want.shape
        if bf16:
            assert got.dtype == torch.bfloat16
            assert_bf16_close(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=VOL_ATOL, rtol=VOL_RTOL)


@pytest.fixture(scope="module")
def volumes_64x96(features_64x96):
    f1, f2 = features_64x96
    with interpret_pallas():
        vj = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                    radius=RADIUS, num_levels=4, margin=8,
                                    use_pallas=True, layout="p")
    vt = tcorr.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                RADIUS, 4, 8)
    return vj, vt


def jax_exact(vj, starts, frac):
    """The JAX ``block_local_lookup`` of every level, level-major."""
    outs = []
    for lvl, vol in enumerate(vj.volumes):
        _, wh, ww, _ = vol.shape
        s, f = starts[lvl].numpy(), frac[lvl].numpy()
        wy = two_hot(s[0], f[0], wh - K + 1)
        wx = two_hot(s[1], f[1], ww - K + 1)
        with interpret_pallas():
            outs.append(np.asarray(pll.block_local_lookup(
                vol, jnp.asarray(wy), jnp.asarray(wx), K)))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("mode", ["all blocks", "flagged", "fine=False"])
def test_exact_lookup_levels_match_pallas(volumes_64x96, mode):
    """One call over all levels (kernel E's plain path) equals the JAX
    lookup of each level; with a flag only the flagged blocks change."""
    vj, vt = volumes_64x96
    coords = torch.from_numpy(jitter_coords(64, 96))
    starts, frac = tcorr._local_level_coords(vt, coords)
    want = jax_exact(vj, starts, frac)
    nb = vt.volumes[0].shape[0]
    if mode == "all blocks":
        got = tcorr.block_local_lookup_levels(vt.volumes, starts, frac, K)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=LOOKUP_ATOL,
                                   rtol=0)
    elif mode == "flagged":
        flag = torch.zeros(nb, dtype=torch.uint8)
        flag[1::4] = 1
        base = torch.from_numpy(np.random.default_rng(2).normal(
            size=want.shape).astype(np.float32))
        got = tcorr.block_local_lookup_levels(vt.volumes, starts, frac, K,
                                              flag=flag, out=base.clone())
        on = flag.bool().numpy()
        np.testing.assert_allclose(got.numpy()[on], want[on],
                                   atol=LOOKUP_ATOL, rtol=0)
        np.testing.assert_array_equal(got.numpy()[~on], base.numpy()[~on])
    else:
        got = tcorr.corr_lookup_local_blocked(vt, coords, RADIUS,
                                              fine=False).data
        np.testing.assert_allclose(got.numpy(), want, atol=LOOKUP_ATOL,
                                   rtol=0)
        # the guarded fine path gives the same result
        guarded = tcorr.corr_lookup_local_blocked(vt, coords, RADIUS).data
        np.testing.assert_array_equal(guarded.numpy(), got.numpy())
