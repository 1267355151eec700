"""The port's ablation family against ``woft_tpu`` on the CPU: padders,
estimators, the dense-head gate of the steps, and the config files.

The same seeded numpy inputs go through both packages. Tolerances:
- padders: ``crop`` and ``RAFT`` exact; ``Michal`` 5e-5 absolute on a
  [0, 255] image (3 float32 ulps at 255: ``F.interpolate`` lerps where
  ``jax.image.resize`` sums normalised kernel weights) and on flow;
- device estimators: 1e-4 relative, the bound of
  ``test_torch_ops.py::test_find_homography_wls_qr`` (float32 solves of
  a 1000x8 or 9x9 system in two libraries); batched fits against single
  fits to the same bound (another QR order: the two-level tall-skinny QR).
  IRLS with its L1 default weights rows by 1/sqrt(|r| + 1e-8), up to 1e4,
  which amplifies each library's float32 rounding: both packages land
  0.009-0.075 px from a float64 run of the same iterations at the corners
  of a 640x480 frame, so the port is held to 0.1 px of JAX there and to
  no more than twice JAX's distance from the float64 run;
- host estimators: equal (the same OpenCV call on the same float64
  points, its RNG seeded by ``cv2.setRNGSeed(0)`` before each call);
- steps: projected template corners within 0.05 px (``CORNER_TOL``) of
  the JAX step, as in ``test_torch_tracker.py``; the window step's
  ``RAFT`` run against its ``nopad`` run (the same network, the dense
  head against the sparse one: the same logits, other summation orders)
  within 1e-4 px.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.geometry import homography as jh
from woft_tpu.models import raft as jraft
from woft_tpu.ops import pad as jpad
from woft_tpu.tracker import woft as jw
from woft_tpu_torch.config import load_config
from woft_tpu_torch.geometry import homography as th
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_to_jax_numpy
from woft_tpu_torch.ops import pad as tpad
from woft_tpu_torch.ops.warp import warp_perspective
from woft_tpu_torch.tracker import window_step as tws
from woft_tpu_torch.tracker import woft as tw

from test_torch_tracker import (CORNER_TOL, corner_err, homography_flow,
                                run_both, template_frame)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "woft_tpu_torch" / "configs"
REL_TOL = 1e-4
MICHAL_TOL = 5e-5
WINDOW_TOL_PX = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once, and torch's
    default of one intra-op thread a core makes this module's many small
    operations wait on each other's threads (measured 10-40x slower than
    alone, under six workers). Two threads while the module runs, the
    previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def corner_err_at(Ha, Hb, corners):
    """Largest distance between the (2, 4) ``corners`` projected by Ha and
    by Hb."""
    def proj(H, pts):
        p = np.asarray(H, np.float64) @ np.vstack([pts, np.ones(4)])
        return p[:2] / p[2:]
    return np.linalg.norm(proj(Ha, corners) - proj(Hb, corners),
                          axis=0).max()


# --------------------------------------------------------------------------
# padders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["nopad", "crop", "RAFT", "Michal"])
def test_padder_matches_jax(mode):
    """Pad a 68x100 image (64x96 for ``nopad``), unpad a 2-channel flow and
    a 1-channel map of the padded size; ``Michal`` rescales the flow."""
    rng = np.random.default_rng(4)
    shape = (1, 64, 96, 3) if mode == "nopad" else (1, 68, 100, 3)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    tpd, jpd = tpad.make_padder(mode, shape), jpad.make_padder(mode, shape)
    (pt,) = tpd.pad(torch.from_numpy(img))
    (pj,) = jpd.pad(jnp.asarray(img))
    tol = MICHAL_TOL if mode == "Michal" else 0.0
    assert pt.shape == pj.shape
    assert np.abs(pt.numpy() - np.asarray(pj)).max() <= tol
    for c in (2, 1):
        x = rng.normal(0, 3, pt.shape[:3] + (c,)).astype(np.float32)
        ut = tpd.unpad(torch.from_numpy(x)).numpy()
        uj = np.asarray(jpd.unpad(jnp.asarray(x)))
        assert ut.shape == uj.shape
        assert np.abs(ut - uj).max() <= tol
    if mode == "RAFT":
        assert pt.shape[1:3] == (72, 104)


# --------------------------------------------------------------------------
# estimators
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def points():
    """Two 500-point sets under a homography, 0.5 px noise, 5 % gross
    outliers, weights in [0, 1] with every 7th zero."""
    rng = np.random.default_rng(0)
    h = np.array([[0.97, 0.05, 12.0], [-0.03, 1.04, -7.0],
                  [2e-5, -3e-5, 1.0]])
    p1 = rng.uniform(0, 640, (3, 500, 2))
    p2h = np.einsum("ij,bnj->bni", h, np.concatenate(
        [p1, np.ones((3, 500, 1))], -1))
    p2 = p2h[..., :2] / p2h[..., 2:] + rng.normal(0, 0.5, (3, 500, 2))
    p2[:, ::20] += rng.uniform(-40, 40, (3, 25, 2))
    w = rng.uniform(0, 1, (3, 500))
    w[:, ::7] = 0.0
    return (p1.astype(np.float32), p2.astype(np.float32),
            w.astype(np.float32))


# Huber's threshold in normalised units (the points' mean distance from
# their centroid is sqrt(2)): 0.005 puts the outliers and part of the
# 0.5 px noise on its L1 side (the tracker's default 2.0 keeps every point
# of this set on the L2 side, where IRLS equals the QR fit)
HUBER_K = 0.005
IRLS_L1_TOL_PX = 0.1
FRAME_CORNERS = np.array([[0, 640, 640, 0], [0, 0, 480, 480]], float)


def _fits(name):
    """(port fit, JAX fit) of one device estimator: fn(p1, p2, w)."""
    if name == "irls_huber":
        return (lambda a, b, w: th.find_homography_irls_qr(
                    a, b, w, reweighting_fn=lambda r: th.irls_huber(
                        r, k=HUBER_K)),
                lambda a, b, w: jh.find_homography_irls_qr(
                    a, b, w, reweighting_fn=lambda r: jh.irls_huber(
                        r, k=HUBER_K)))
    return (getattr(th, f"find_homography_{name}"),
            getattr(jh, f"find_homography_{name}"))


def _both(name, points, weighted, dtype=np.float32):
    p1, p2, w = (x[:1].astype(dtype) for x in points)
    tfit, jfit = _fits(name)
    Ht = tfit(torch.from_numpy(p1), torch.from_numpy(p2),
              torch.from_numpy(w) if weighted else None)
    Hj = None if dtype != np.float32 else jfit(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(w) if weighted else None)
    return Ht.numpy(), Hj


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["irls_huber", "wls_normal", "dlt_svd"])
def test_device_estimator_matches_jax(points, name, weighted):
    """One system (B = 1)."""
    Ht, Hj = _both(name, points, weighted)
    assert _rel(Ht, Hj) < REL_TOL


@pytest.mark.parametrize("weighted", [False, True])
def test_irls_l1_matches_jax(points, weighted):
    """IRLS with its default L1 weights: ill-conditioned in float32 (see
    the module's docstring), so held at the frame's corners."""
    Ht, Hj = _both("irls_qr", points, weighted)
    H64, _ = _both("irls_qr", points, weighted, np.float64)
    assert corner_err_at(Ht[0], Hj[0], FRAME_CORNERS) < IRLS_L1_TOL_PX
    assert (corner_err_at(Ht[0], H64[0], FRAME_CORNERS)
            <= 2 * corner_err_at(Hj[0], H64[0], FRAME_CORNERS))


def test_irls_weights_match_jax():
    r = np.random.default_rng(1).normal(0, 3, (2, 64, 1)).astype(np.float32)
    r[0, :3] = 0.0
    np.testing.assert_allclose(th.irls_l1(torch.from_numpy(r)).numpy(),
                               np.asarray(jh.irls_l1(jnp.asarray(r))),
                               rtol=1e-6)
    np.testing.assert_array_equal(
        th.irls_huber(torch.from_numpy(r), k=2.0).numpy(),
        np.asarray(jh.irls_huber(jnp.asarray(r), k=2.0)))


@pytest.mark.parametrize("name", ["irls_huber", "wls_normal", "dlt_svd"])
def test_batched_estimator_matches_single_fits(points, name):
    """B = 3 in one call (IRLS through the two-level tall-skinny QR)
    against three B = 1 fits."""
    p1, p2, w = (torch.from_numpy(x) for x in points)
    fit = _fits(name)[0]
    batch = fit(p1, p2, w)
    for i in range(3):
        assert _rel(batch[i:i + 1], fit(p1[i:i + 1], p2[i:i + 1],
                                        w[i:i + 1])) < REL_TOL


@pytest.mark.parametrize("name", ["cvransac", "trs"])
def test_host_estimator_matches_jax(points, name):
    cv2 = pytest.importorskip("cv2")
    p1, p2, _ = points
    tfit = getattr(th, f"find_homography_{name}")
    jfit = getattr(jh, f"find_homography_{name}")
    kw = {"max_iters": 500, "thr": 3.0} if name == "cvransac" else {}
    cv2.setRNGSeed(0)
    Ht = tfit(torch.from_numpy(p1), torch.from_numpy(p2), **kw)
    cv2.setRNGSeed(0)
    Hj = jfit(p1, p2, **kw)
    np.testing.assert_array_equal(Ht, Hj)


@pytest.mark.parametrize("name", ["cvransac", "trs"])
def test_host_fit_dispatch_matches_jax(points, name):
    """The steps' host fit: valid rows only, a row of fewer than 4 valid
    points NaN, against the JAX package's ``pure_callback`` body."""
    cv2 = pytest.importorskip("cv2")
    p1, p2, w = points
    valid = (w > 0.3).astype(np.float32)
    valid[2, 3:] = 0.0                       # 3 valid points: no fit
    tp = tw.TrackerParams(estimator=name, ransac_iters=500)
    cv2.setRNGSeed(0)
    Ht = tw._estimate_h(tp, torch.from_numpy(p1), torch.from_numpy(p2),
                        torch.from_numpy(w), torch.from_numpy(valid))
    cv2.setRNGSeed(0)
    Hj = jw._host_robust_fit(name, tp.ransac_thr, tp.ransac_iters)(
        p1, p2, valid)
    assert Ht.dtype == torch.float32 and Ht.shape == (3, 3, 3)
    np.testing.assert_array_equal(Ht.numpy(), Hj)
    assert np.isnan(Hj[2]).all() and np.isfinite(Hj[:2]).all()


def test_host_estimator_names_itself_without_cv2(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    pts = torch.zeros(1, 8, 2)
    for name in ("cvransac", "trs"):
        with pytest.raises(ImportError, match=name):
            getattr(th, f"find_homography_{name}")(pts, pts)
        with pytest.raises(ImportError, match=name):
            tw._estimate_h(tw.TrackerParams(estimator=name), pts, pts,
                           torch.ones(1, 8), torch.ones(1, 8))


# --------------------------------------------------------------------------
# the steps: the dense-head gate, IRLS, the pre-warp mask
# --------------------------------------------------------------------------

def _walk_frame(template, h):
    return warp_perspective(torch.from_numpy(template)[None],
                            torch.from_numpy(h))


def _raft_step_pair(tp_kwargs, hw):
    """One frame through both packages' real-network steps (seeded
    weights, 2 iterations) with ``redetection='never'``, so the local
    fallback runs too. Returns ((H, H_global) port, (H, H_global) JAX)."""
    h_img, w_img = hw
    jcfg = jraft.RaftConfig(variant="weighted", iters=2)
    tcfg = traft.RaftConfig(iters=2)
    model = traft.init_raft_params(tcfg, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                params_to_jax_numpy(model.state_dict()))
    template = template_frame()[:h_img, :w_img].copy()
    mask = np.zeros((h_img, w_img), bool)
    mask[16:56, 24:80] = True
    h = np.array([[1.0, 0.01, 1.5], [0.0, 1.0, -0.8], [0, 0, 1.0]],
                 np.float32)
    frame = _walk_frame(template, h)
    kw = dict(redetection="never", **tp_kwargs)

    jtp = jw.TrackerParams(**kw)
    jstep = jw.build_track_step(jcfg, jtp)
    jstate = jw.tracker_init_state(jp, jcfg, jtp, jnp.asarray(template)[None],
                                   jnp.asarray(mask))
    _, Hj, mj = jstep(jp, jstate, jnp.asarray(frame.numpy()))

    ttp = tw.TrackerParams(**kw)
    tstep = tw.build_track_step(tcfg, ttp)
    tstate = tw.tracker_init_state(model, tcfg, ttp,
                                   torch.from_numpy(template)[None],
                                   torch.from_numpy(mask))
    _, Ht, mt = tstep(model, tstate, frame)
    return ((Ht.numpy(), mt["H_global_cur2init"].numpy()),
            (np.asarray(Hj), np.asarray(mj["H_global_cur2init"])))


CORNERS_68 = np.array([[24, 16], [79, 16], [79, 55], [24, 55]], float).T


def test_raft_padded_step_matches_jax():
    """A non-/8 frame under ``RAFT`` padding: 68x100, padded 72x104 (grid
    9x13, levels 9x13, 4x6, 2x3, 1x1); the main flow on the padded frame
    with the dense head, unpadded before the TC selection, and the padded
    fallback flow."""
    (Ht, Hgt), (Hj, Hgj) = _raft_step_pair({"padding_mode": "RAFT"},
                                           (68, 100))
    assert np.isfinite(Ht).all() and np.isfinite(Hgt).all()
    assert corner_err_at(Hgt, Hgj, CORNERS_68) < CORNER_TOL
    assert corner_err_at(Ht, Hj, CORNERS_68) < CORNER_TOL


def test_dense_head_step_matches_jax():
    """``sparse_weights=False`` at ``nopad`` (64x96): the dense head on the
    main flow, in both packages."""
    (Ht, Hgt), (Hj, Hgj) = _raft_step_pair({"sparse_weights": False},
                                           (64, 96))
    assert corner_err_at(Hgt, Hgj, CORNERS_68) < CORNER_TOL
    assert corner_err_at(Ht, Hj, CORNERS_68) < CORNER_TOL


def test_dense_head_equals_sparse_head_port():
    """Port only: the full-frame step's dense-head path against its
    sparse-head path on the same frame (the head is per cell, so the
    logits are the same): 1e-4 px at the corners."""
    tcfg = traft.RaftConfig(iters=2)
    model = traft.init_raft_params(tcfg, seed=3)
    template = template_frame()
    mask = np.zeros(template.shape[:2], bool)
    mask[24:72, 32:96] = True
    frame = _walk_frame(template, np.array(
        [[1.0, 0.01, 1.5], [0.0, 1.0, -0.8], [0, 0, 1.0]], np.float32))
    hs = []
    for sparse in (True, False):
        tp = tw.TrackerParams(sparse_weights=sparse)
        state = tw.tracker_init_state(model, tcfg, tp,
                                      torch.from_numpy(template)[None],
                                      torch.from_numpy(mask))
        hs.append(tw.build_track_step(tcfg, tp)(model, state, frame)[1])
    assert corner_err(hs[0].numpy(), hs[1].numpy()) < WINDOW_TOL_PX


def _walk_oracle():
    truths = []
    for t in range(1, 4):
        c, s = np.cos(0.01 * t) * (1 + 0.01 * t), np.sin(0.01 * t)
        truths.append(np.array([[c, -s, 1.5 * t], [s, c, -1.0 * t],
                                [1e-5 * t, 0, 1]], np.float32))  # cur->tmpl
    template = torch.from_numpy(template_frame())[None]
    frames = [warp_perspective(template, torch.from_numpy(
        np.linalg.inv(h).astype(np.float32)))[0].numpy() for h in truths]

    def params_of(t, state):
        lg = np.asarray(state.last_good_h2init, np.float32)
        return {"h": (lg @ np.linalg.inv(truths[t])).astype(np.float32)}

    def flow_of(xp, params):
        # the oracle flow, off by up to 12 px on every 9th column: outliers
        # the Huber weights damp
        flow, weights = homography_flow(params["h"], xp)
        col = xp.arange(flow.shape[2]) % 9 == 0
        bump = xp.where(col[None, None, :, None], 12.0, 0.0)
        return flow + bump, weights

    return truths, frames, params_of, flow_of


@pytest.mark.parametrize("tp_kwargs", [
    {"estimator": "irls_huber"},
    {"estimator": "irls_huber", "irls_k": 0.05, "irls_iters": 3},
    {"use_pw_mask": False},
], ids=["irls_huber", "irls_huber-k0.05-3iters", "no-pw-mask"])
def test_step_options_match_jax(tp_kwargs):
    """The step on oracle flow with outliers (``run_both``): IRLS-Huber
    and the step without the pre-warp mask, per-frame H of both packages
    over a 3-frame walk."""
    truths, frames, params_of, flow_of = _walk_oracle()
    jres, tres = run_both(tp_kwargs, flow_of, frames, params_of)
    for (Hj, mj), (Ht, mt) in zip(jres, tres):
        assert bool(mt["global_H_success"]) == bool(mj["global_H_success"])
        assert corner_err(Ht, Hj) < CORNER_TOL


def test_shared_step_host_fit_loops_targets():
    """The shared-flow step with a host estimator: each target's fit is the
    single-target step's (one flow, the targets fitted on the host one by
    one); oracle flow, two targets."""
    pytest.importorskip("cv2")
    import cv2

    h = np.array([[1.0, 0.0, 2.0], [0.0, 1.0, -1.5], [0, 0, 1.0]],
                 np.float32)
    template = template_frame()
    frame = torch.from_numpy(template)[None]
    masks = np.zeros((2,) + template.shape[:2], bool)
    masks[0, 24:72, 32:96] = True
    masks[1, 10:50, 10:60] = True

    def flow_fn(model, img1, img2, template_feats=None):
        return homography_flow(torch.from_numpy(h), torch)

    tp = tw.TrackerParams(estimator="trs", no_local_h=True)
    cfg = traft.RaftConfig(iters=2)
    state = tw.tracker_init_state(None, cfg, tp, frame,
                                  torch.from_numpy(masks[0]), encode=False)
    step = tw.build_shared_multi_step(cfg, tp, flow_fn=flow_fn)
    cv2.setRNGSeed(0)
    _, _, hs, meta = step(None, state, torch.from_numpy(masks),
                          torch.eye(3).expand(2, 3, 3), frame)
    single = tw.build_track_step(cfg, tp, flow_fn=flow_fn)
    for i in range(2):
        st = tw.tracker_init_state(None, cfg, tp, frame,
                                   torch.from_numpy(masks[i]), encode=False)
        cv2.setRNGSeed(0)
        _, Hs, _ = single(None, st, frame)
        assert corner_err(hs[i].numpy(), Hs.numpy()) < CORNER_TOL
    assert bool(meta["global_H_success"].all())


# --------------------------------------------------------------------------
# the window step
# --------------------------------------------------------------------------

def test_window_step_raft_padding_equals_nopad():
    """Port only: windows are /8, so ``RAFT`` padding is the identity there
    and only the weight head changes (dense instead of sparse); over a
    2-frame walk with ``redetection='never'``, so that both flows of a
    frame run, the main one and the local fallback's."""
    tcfg = traft.RaftConfig(iters=2)
    model = traft.init_raft_params(tcfg, seed=3)
    template = template_frame()
    mask = np.zeros(template.shape[:2], bool)
    mask[30:70, 40:100] = True
    wp = tws.WindowParams(size=64, margin=0.4, min_px=20)
    frames = [_walk_frame(template, np.array(
        [[1.0, 0.005 * t, 1.0 * t], [0.0, 1.0, -0.6 * t], [0, 0, 1.0]],
        np.float32)) for t in range(1, 3)]
    corners = np.array([[40, 30], [99, 30], [99, 69], [40, 69]], float).T
    hs = {}
    for mode in ("nopad", "RAFT"):
        tp = tw.TrackerParams(padding_mode=mode, redetection="never")
        step = tws.build_window_track_step(tcfg, tp, wp)
        state = tws.window_init_state(model, tcfg, tp, wp,
                                      torch.from_numpy(template)[None], mask)
        hs[mode] = []
        for f in frames:
            state, H, meta = step(model, state, f)
            assert not meta["global_H_success"]
            hs[mode].append(H.numpy())
    for a, b in zip(hs["nopad"], hs["RAFT"]):
        assert corner_err_at(a, b, corners) < WINDOW_TOL_PX


# --------------------------------------------------------------------------
# the config files
# --------------------------------------------------------------------------

NEW_CONFIGS = {
    "WOFT_downscale_2x.py": ("wls_qr", "inliers", 2),
    "WOFT_downscale_3x.py": ("wls_qr", "inliers", 3),
    "WOFT_downscale_4x.py": ("wls_qr", "inliers", 4),
    "WOFT_plainLSq.py": ("plain_qr", "inliers", 0),
    "WOFT_alwayswarp.py": ("wls_qr", "always", 0),
    "WOFT_alwayswarp_plainLSq.py": ("plain_qr", "always", 0),
    "WOFT_neverwarp.py": ("wls_qr", "never", 0),
    "WOFT_neverwarp_plainLSq.py": ("plain_qr", "never", 0),
    "WOFT_wIRLSq.py": ("irls_huber", "inliers", 0),
    "WOFT_cvransac.py": ("cvransac", "inliers", 0),
    "WOFT_trs.py": ("trs", "inliers", 0),
    "ablation_01.py": ("plain_qr", "never", 0),
    "ablation_02.py": ("wls_qr", "never", 0),
    "ablation_03.py": ("plain_qr", "always", 0),
    "ablation_04.py": ("wls_qr", "always", 0),
    "ablation_05.py": ("plain_qr", "inliers", 0),
    "ablation_06-WOFT.py": ("wls_qr", "inliers", 0),
    "ablation_08.py": ("irls_huber", "inliers", 0),
    "ablation_09.py": ("cvransac", "inliers", 0),
}


@pytest.mark.parametrize("name", sorted(NEW_CONFIGS))
def test_config_loads_and_matches_jax(name):
    """Each config loads, builds a ``WOFTTracker`` on the CPU, and carries
    the JAX twin's tracker parameters and padding."""
    from woft_tpu.config import load_config as jload_config

    conf = load_config(CONFIGS / name)
    tracker = tw.WOFTTracker(conf, device="cpu")
    jconf = jload_config(ROOT / "woft_tpu" / "configs" / name)
    estimator, redetection, downscale = NEW_CONFIGS[name]
    for tp in (tracker.tp, jconf.tracker_params):
        assert (tp.estimator, tp.redetection, tp.downscale) == (
            estimator, redetection, downscale)
    for field in ("subsample_n", "inlier_px", "min_inlier_frac",
                  "no_prewarp_after_n", "irls_k", "irls_iters", "ransac_thr",
                  "ransac_iters", "use_pw_mask", "no_local_h", "padding_mode",
                  "sparse_weights"):
        assert getattr(tracker.tp, field) == getattr(jconf.tracker_params,
                                                     field), field
    assert conf.flow_config.padding_mode == jconf.flow_config.padding_mode
    assert (conf.downscale_inputs or 0) == (jconf.downscale_inputs or 0)


@pytest.mark.parametrize("flow_config", ["wraft_large_rep.py",
                                         "orig_raft.py", "liteflownet2.py"])
def test_unported_flow_config_raises(flow_config):
    """The flow configs that were left to port now build, each with its
    JAX twin's network and iterations; a flow config the port does not
    have still raises, naming it."""
    from woft_tpu.config import load_config as jload_config
    from woft_tpu_torch.configs._ablation_base import build_config

    conf = build_config(flow_config=flow_config).flow_config
    jconf = jload_config(ROOT / "woft_tpu" / "configs" / "flow"
                         / flow_config)
    assert conf.of_class.__name__ == jconf.of_class.__name__
    assert (conf.raft_type or None) == (jconf.raft_type or None)
    assert conf.iters == jconf.iters
    missing = flow_config.replace(".py", "_small.py")
    with pytest.raises(NotImplementedError, match=missing):
        build_config(flow_config=missing)


def test_tracker_params_defaults_match_jax():
    import dataclasses

    tfields = {f.name: f.default for f in dataclasses.fields(tw.TrackerParams)}
    jfields = {f.name: f.default for f in dataclasses.fields(jw.TrackerParams)}
    assert tfields == jfields
    with pytest.raises(ValueError):
        tw.TrackerParams(downscale=5)
