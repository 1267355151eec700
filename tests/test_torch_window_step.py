"""The port's device-resident window step against ``woft_tpu``'s on the
CPU: ``build_window_track_step`` (the path ``bench.py`` measures) with
oracle flow, with WeightedRAFT dense in float32 (with and without the local
fallback) and block-local in bf16, and the block-local volume and guarded
lookup at the feature grid of ``bench.py``'s window. The JAX side's Pallas
kernels run in interpret mode. Helpers and the shared seeded weights come
from ``test_torch_window.py``.

Tolerances: per-frame H within 0.05 px at the template box's corners;
block-local volumes and lookups as ``test_torch_local_corr.py`` holds them
(atol 2e-5, rtol 1e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from test_torch_window import (CORNER_TOL, corner_err, textured, walk,
                               weights)  # noqa: F401  (fixture)

from woft_tpu.models import raft as jraft
from woft_tpu.tracker import woft as jw
from woft_tpu.tracker import window_step as jws
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.ops import warp as twarp
from woft_tpu_torch.tracker import window_step as tws
from woft_tpu_torch.tracker import woft as tw


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


@pytest.fixture(scope="module")
def window_grid():
    """Block-local volumes of both packages at the feature grid of
    ``bench.py``'s window (192 x 344 pixels, 24 x 43 cells, margin 16, 4
    levels, D = 64; the JAX one from its Pallas kernel in interpret mode),
    the smooth field and the jitter that makes blocks violate."""
    from test_corr_impls import _interpret_pallas
    from woft_tpu.models import corr as jcorr
    from woft_tpu.ops.pallas import local_corr as plc
    from woft_tpu_torch.models import corr as tcorr

    H1, W1, D = 24, 43, 64
    rng = np.random.default_rng(31)
    f1 = rng.normal(size=(1, H1, W1, D)).astype(np.float32)
    f2 = rng.normal(size=(1, H1, W1, D)).astype(np.float32)
    ys, xs = np.meshgrid(np.arange(H1, dtype=np.float32),
                         np.arange(W1, dtype=np.float32), indexing="ij")
    smooth = np.stack([xs + 0.1 * ys - 1.7, ys - 0.05 * xs + 2.2], -1)[None]
    fields = {"smooth": smooth.astype(np.float32),
              "violating": (smooth + rng.uniform(-7.0, 7.0, smooth.shape)
                            ).astype(np.float32)}
    vt = tcorr.build_local_corr(torch.from_numpy(f1), torch.from_numpy(f2),
                                4, 4, 16)
    with _interpret_pallas(plc):
        vj = jcorr.build_local_corr(jnp.asarray(f1), jnp.asarray(f2),
                                    radius=4, num_levels=4, margin=16,
                                    use_pallas=True, layout="p")
    return vt, vj, fields


def test_window_grid_local_volume_matches_jax(window_grid):
    """The volume at the window grid: 3 x 3 query blocks, every level's
    window within kernel C's 128 columns, each level equal to the JAX
    package's."""
    from woft_tpu_torch.ops import kernels

    vt, vj, _ = window_grid
    meta = vt.meta
    assert (meta["nbh"], meta["nbw"]) == (3, 3)
    kernels.local_corr_table(
        [(d["hl"], d["wl"]) for d in meta["levels"]],
        [(d["pad"], d["sh"], d["sw"], d["wh"], d["ww"])
         for d in meta["levels"]])          # raises beyond 128 columns
    for a, b in zip(vt.volumes, vj.volumes):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["smooth", "violating"])
def test_window_grid_local_lookup_matches_jax(window_grid, kind):
    """The guarded lookup at the window grid: W1 = 43 leaves 5 padding
    columns in the last column of 16-wide query blocks, whose queries sit
    at coordinate (0, 0) as in the JAX package. The plain versions
    (kernels D and E's arithmetic) against the JAX package's Pallas kernels
    in interpret mode, and the flags."""
    from test_corr_impls import _interpret_pallas
    from woft_tpu.models import corr as jcorr
    from woft_tpu.ops.pallas import local_corr as plc
    from woft_tpu.ops.pallas import local_lookup as pll
    from woft_tpu_torch.models import corr as tcorr

    vt, vj, fields = window_grid
    coords = fields[kind]
    ct = torch.from_numpy(coords)
    _, bad = tcorr.block_local_lookup_coords(vt, ct, 9, torch.float32)
    got = tcorr.corr_lookup_local_blocked(vt, ct, 4).to_natural()
    exact = tcorr.corr_lookup_local_blocked(vt, ct, 4, fine=False)
    np.testing.assert_array_equal(got.numpy(),
                                  exact.to_natural().numpy())
    with _interpret_pallas(plc, pll):
        want = jcorr.corr_lookup_local_blocked(vj, jnp.asarray(coords),
                                               4).to_natural()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)
    # on the smooth field only blocks of the last column, which holds the
    # padding queries, are flagged, and only in block rows 1 and 2: there
    # the padding's y = 0 lies more than the fine window's 24 rows from the
    # real queries' rows (in row 0 it lies among them, and its x = 0
    # saturates at the stored window's edge); kernel E rewrites them
    flagged = bad.bool().any(1).reshape(3, 3).numpy()
    if kind == "smooth":
        np.testing.assert_array_equal(flagged, [[False, False, False],
                                                [False, False, True],
                                                [False, False, True]])
    else:
        assert flagged.sum() > 2


def test_window_step_oracle_flow_matches_jax():
    """The step's geometry on controlled flow (``flow_fn``): the flow a
    true translation implies in window coordinates (from the crops the
    step chooses) recovers it in both packages, and zero flow returns the
    identity through the crop conjugations."""
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 255, (1, 96, 128, 3)).astype(np.float32)
    mask = np.zeros((96, 128), bool)
    mask[30:70, 40:100] = True
    h_true = np.array([[1, 0, 3.0], [0, 1, -2.0], [0, 0, 1]], np.float32)
    frame2 = twarp.warp_perspective(torch.from_numpy(frame),
                                    torch.from_numpy(np.linalg.inv(h_true)))
    S = 64
    cfg_t, cfg_j = traft.RaftConfig(iters=1), jraft.RaftConfig(
        variant="weighted", iters=1)
    twp = tws.WindowParams(size=S, margin=0.4, min_px=20)
    jwp = jws.WindowParams(size=S, margin=0.4, min_px=20)
    tstate = tws.window_init_state(None, cfg_t, tw.TrackerParams(), twp,
                                   torch.from_numpy(frame), mask,
                                   encode=False)
    h_tmpl_crop = tstate["h_tmpl_crop"].numpy().astype(np.float64)
    h_crop = tws._search_crop_h(torch.eye(3), tstate["tmpl_corners"],
                                (96, 128), twp).numpy().astype(np.float64)
    h_prior = h_tmpl_crop @ np.linalg.inv(h_crop)
    h_res = h_tmpl_crop @ h_true @ np.linalg.inv(h_crop) @ np.linalg.inv(
        h_prior)
    h_res = (h_res / h_res[2, 2]).astype(np.float32)
    ys, xs = np.divmod(np.arange(S * S), S)
    pts = np.stack([xs, ys, np.ones(S * S)]).astype(np.float32)

    def oracle(xp, residual):
        def flow_fn(params, img1, img2, template_feats=None):
            proj = xp.asarray(np.linalg.inv(residual)) @ xp.asarray(pts)
            flow = (proj[:2] / proj[2:] - xp.asarray(pts[:2])).T
            return flow.reshape(1, S, S, 2), xp.ones((1, S, S, 1))
        return flow_fn

    for residual, frm, want in ((np.eye(3, dtype=np.float32), frame,
                                 np.eye(3)), (h_res, frame2.numpy(), h_true)):
        tstep = tws.build_window_track_step(cfg_t, tw.TrackerParams(), twp,
                                            flow_fn=oracle(torch, residual))
        jstep = jws.build_window_track_step(cfg_j, jw.TrackerParams(), jwp,
                                            flow_fn=oracle(jnp, residual))
        tst = tws.window_init_state(None, cfg_t, tw.TrackerParams(), twp,
                                    torch.from_numpy(frame), mask,
                                    encode=False)
        jst = jws.window_init_state({}, cfg_j, jw.TrackerParams(), jwp,
                                    jnp.asarray(frame), jnp.asarray(mask),
                                    encode=False)
        corners = np.array([[40, 30], [99, 30], [99, 69], [40, 69]],
                           float).T
        _, Ht, mt = tstep(None, tst, torch.from_numpy(frm))
        _, Hj, mj = jstep({}, jst, jnp.asarray(frm))
        assert mt["global_H_success"] and bool(mj["global_H_success"])
        assert corner_err(Ht.numpy(), Hj, corners) < CORNER_TOL
        assert corner_err(Ht.numpy(), want, corners) < CORNER_TOL


# bf16 mode: the two packages' flows differ by bf16 rounding noise; the fit
# passes it on at the corners at about the size test_torch_tracker.py's
# WOFT_fast walk measured, inside the float32 bound.
BF16_CORNER_TOL = 0.05


@pytest.mark.parametrize("impl,size,redetection", [
    ("dense", 64, "inliers"),
    ("dense", 64, "never"),
    ("local", (72, 88), "inliers"),
], ids=["dense-float32", "dense-float32-fallback", "local-bf16-9x11"])
def test_window_step_matches_jax(weights, impl, size, redetection):
    """``build_window_track_step`` against the JAX step (the device-
    resident path ``bench.py`` measures), over a 3-frame walk: dense
    float32 with the sparse weight head (and, with ``never``, the sparse
    local fallback every frame), and block-local bf16 (the JAX side's
    Pallas kernels in interpret mode) at a 72 x 88 window, whose 9 x 11
    feature grid leaves 5 padding columns in its 16-wide query blocks and
    7 padding rows in its second row of 8-high blocks."""
    from test_corr_impls import _interpret_pallas
    from woft_tpu.ops.pallas import local_corr as plc
    from woft_tpu.ops.pallas import local_lookup as pll

    state_dict, jp, _ = weights
    local = impl == "local"
    precision = "bf16" if local else "highest"
    tcfg = traft.RaftConfig(iters=2, corr_impl=impl, precision=precision)
    jcfg = jraft.RaftConfig(variant="weighted", iters=2,
                            corr_impl="local" if local else "onehot",
                            local_margin=tcfg.local_margin, local_pallas=local,
                            precision=precision)
    model = traft.init_raft_params(tcfg)
    model.load_state_dict(state_dict)
    ttp = tw.TrackerParams(redetection=redetection)
    jtp = jw.TrackerParams(redetection=redetection)
    twp = tws.WindowParams(size=size, margin=0.4, min_px=20)
    jwp = jws.WindowParams(size=size, margin=0.4, min_px=20)

    template = textured(96, 128, seed=2)
    mask = np.zeros((96, 128), bool)
    mask[30:70, 40:100] = True
    frames, truths = walk(template, 3)
    rgb = [f[..., ::-1].astype(np.float32)[None] for f in [template] + frames]
    corners = np.array([[40, 30], [99, 30], [99, 69], [40, 69]], float).T

    tstep = tws.build_window_track_step(tcfg, ttp, twp)
    tstate = tws.window_init_state(model, tcfg, ttp, twp,
                                   torch.from_numpy(rgb[0]), mask)
    with _interpret_pallas(plc, pll):
        jstep = jws.build_window_track_step(jcfg, jtp, jwp)
        jstate = jws.window_init_state(jp, jcfg, jtp, jwp, jnp.asarray(rgb[0]),
                                       jnp.asarray(mask))
        np.testing.assert_array_equal(tstate["tmpl_mask_window"].numpy(),
                                      np.asarray(jstate["tmpl_mask_window"]))
        np.testing.assert_allclose(tstate["h_tmpl_crop"].numpy(),
                                   np.asarray(jstate["h_tmpl_crop"]))
        for t, f in enumerate(rgb[1:]):
            tstate, Ht, mt = tstep(model, tstate, torch.from_numpy(f))
            jstate, Hj, mj = jstep(jp, jstate, jnp.asarray(f))
            assert bool(mt["global_H_success"]) == bool(
                mj["global_H_success"]) == (redetection == "inliers")
            assert mt["N_lost"] == int(mj["N_lost"])
            np.testing.assert_allclose(mt["h_crop"].numpy(),
                                       np.asarray(mj["h_crop"]),
                                       rtol=1e-4, atol=1e-4)
            assert np.isfinite(Ht.numpy()).all()
            tol = BF16_CORNER_TOL if local else CORNER_TOL
            assert corner_err(Ht.numpy(), Hj, corners) < tol
