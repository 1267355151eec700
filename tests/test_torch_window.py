"""The port's search-window tracker against ``woft_tpu``'s on the CPU.

The host pieces (``Bbox``, ``h_bbox2bbox``, ``project_bbox``, the numpy
homography helpers), the device pieces (``_search_crop_h``,
``window_params_for_mask``, ``warp_axis_aligned``), the template mask's
nearest warp against ``cv2``, and ``WOFTWindowTracker`` in its three crop
modes, each against its JAX twin, on seeded inputs and one set of seeded
``init_raft_params`` weights both packages load from one file. The
device-resident step (``build_window_track_step``) has its own file,
``test_torch_window_step.py``, which takes its helpers from here.

Tolerances: host float64 pieces equal to 1e-12; crop homographies
(float32 on both sides, inverses in two libraries) to 1e-5 relative;
per-frame H within 0.05 px at the template box's corners, as in
``test_torch_tracker.py``.
"""

from pathlib import Path

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from woft_tpu.geometry import bbox as jbbox
from woft_tpu.geometry import homography as jhom
from woft_tpu.ops import warp as jwarp
from woft_tpu.tracker import woft as jw
from woft_tpu.tracker import window_step as jws
from woft_tpu_torch.config import load_config
from woft_tpu_torch.geometry import bbox as tbbox
from woft_tpu_torch.geometry import homography as thom
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_to_jax_numpy
from woft_tpu_torch.ops import warp as twarp
from woft_tpu_torch.tracker import window as twin
from woft_tpu_torch.tracker import window_step as tws
from woft_tpu_torch.tracker import woft as tw

ROOT = Path(__file__).resolve().parent.parent
CORNER_TOL = 0.05
CROP_RTOL = 1e-5


def textured(h, w, seed):
    """(h, w, 3) uint8 frame of smooth seeded noise."""
    rng = np.random.default_rng(seed)
    img = np.zeros((1, 3, h, w), np.float32)
    for scale, amp in ((16, 1.0), (4, 0.5)):
        noise = torch.from_numpy(rng.uniform(
            0, 1, (1, 3, h // scale + 2, w // scale + 2)).astype(np.float32))
        img += amp * F.interpolate(noise, size=(h, w), mode="bilinear",
                                   align_corners=False).numpy()
    img = (img - img.min()) / (img.max() - img.min()) * 255.0
    return np.ascontiguousarray(img[0].transpose(1, 2, 0).round()
                                .astype(np.uint8))


def corner_err(Ha, Hb, corners):
    return np.linalg.norm(
        jhom.np_h_proj(np.asarray(Ha, np.float64), corners)
        - jhom.np_h_proj(np.asarray(Hb, np.float64), corners), axis=0).max()


def same_box(a, b):
    for key in ("tl_x", "tl_y", "w", "h", "br_x", "br_y"):
        np.testing.assert_allclose(getattr(a, key), getattr(b, key),
                                   rtol=0, atol=1e-12, err_msg=key)


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

BOXES = {
    "float": (10.5, 20.25, 100.0, 40.0),
    "tall": (0, 0, 30, 90),
    "square": (5, 5, 64, 64),
    "off-frame": (-300.0, 150.0, 120.5, 60.0),
}
FRAME = (0, 0, 224, 160)


@pytest.mark.parametrize("name", BOXES)
def test_bbox_methods_match_jax(name):
    """Every method the window shell uses, including ``with_aspect``'s
    grow-only rule and intersections with a frame the box leaves."""
    j = jbbox.Bbox.from_xywh(BOXES[name])
    t = tbbox.Bbox.from_xywh(BOXES[name])
    same_box(t, j)
    assert t.as_xywh() == j.as_xywh()
    assert t.get_center() == j.get_center()
    for margin in (0.0, 0.35, 0.5):
        same_box(t.with_margins(margin), j.with_margins(margin))
    for min_px in (20, 160, 400):
        same_box(t.with_margins_min_size(min_px),
                 j.with_margins_min_size(min_px))
    for aspect in (0.5, 1.0, 344 / 192):
        grown = t.with_aspect(aspect)
        same_box(grown, j.with_aspect(aspect))
        assert grown.w >= t.w - 1e-9 and grown.h >= t.h - 1e-9
        np.testing.assert_allclose(grown.w / grown.h, aspect)
    frame_j = jbbox.Bbox.from_xywh(FRAME)
    frame_t = tbbox.Bbox.from_xywh(FRAME)
    same_box(t.intersection(frame_t), j.intersection(frame_j))
    if name == "off-frame":
        assert t.intersection(frame_t).w < 8        # the shell's lost rule


def test_bbox_from_mask_matches_jax():
    mask = np.zeros((96, 128), bool)
    mask[30:71, 40:101] = True
    same_box(tbbox.Bbox.from_mask(mask), jbbox.Bbox.from_mask(mask))
    empty = np.zeros((8, 8), bool)
    same_box(tbbox.Bbox.from_mask(empty), jbbox.Bbox.from_mask(empty))


PROJECTIONS = {
    "identity": np.eye(3),
    "similarity": np.array([[0.97, -0.12, 14.0], [0.11, 1.02, -9.0],
                            [0, 0, 1.0]]),
    "perspective": np.array([[1.1, 0.05, -20.0], [-0.03, 0.95, 12.0],
                             [2e-4, -1e-4, 1.0]]),
    "off-frame": np.array([[1.0, 0.0, 900.0], [0.0, 1.0, -700.0],
                           [0, 0, 1.0]]),
}


@pytest.mark.parametrize("name", PROJECTIONS)
def test_bbox_homographies_match_jax(name):
    """``h_bbox2bbox``, ``project_bbox`` (boxes projected off the frame
    too) and the numpy helpers the shell composes crops with."""
    H = PROJECTIONS[name]
    src = (10.5, 20.25, 100.0, 40.0)
    j, t = jbbox.Bbox.from_xywh(src), tbbox.Bbox.from_xywh(src)
    same_box(tbbox.project_bbox(t, H), jbbox.project_bbox(j, H))
    dst = (0, 0, 344, 192)
    np.testing.assert_array_equal(
        tbbox.h_bbox2bbox(tbbox.project_bbox(t, H), tbbox.Bbox.from_xywh(dst)),
        jbbox.h_bbox2bbox(jbbox.project_bbox(j, H), jbbox.Bbox.from_xywh(dst)))
    pts = np.array([[0.0, 50.5, 223.0], [0.0, 80.25, 159.0]])
    np.testing.assert_array_equal(thom.np_e2p(pts), jhom.np_e2p(pts))
    np.testing.assert_array_equal(thom.np_h_proj(H, pts),
                                  jhom.np_h_proj(H, pts))
    np.testing.assert_array_equal(
        thom.np_p2e(H @ thom.np_e2p(pts)), jhom.np_p2e(H @ jhom.np_e2p(pts)))
    G = PROJECTIONS["similarity"]
    np.testing.assert_array_equal(thom.np_compose_h(G, H, G),
                                  jhom.np_compose_h(G, H, G))
    assert thom.np_compose_h(G, None) is None


# ---------------------------------------------------------------------------
# device pieces
# ---------------------------------------------------------------------------

LAST_GOOD = {
    "identity": np.eye(3),
    "moved": np.array([[0.98, 0.03, 6.0], [-0.02, 1.01, -4.0],
                       [1e-4, -5e-5, 1.0]]),
    "partly off": np.array([[1.0, 0.0, 60.0], [0.0, 1.0, 45.0], [0, 0, 1.0]]),
    "escaped (bad)": np.array([[1.0, 0.0, 5e3], [0.0, 1.0, -4e3],
                               [0, 0, 1.0]]),
    "non-finite (bad)": np.full((3, 3), np.nan),
}


@pytest.mark.parametrize("square", [True, False], ids=["square", "aniso"])
@pytest.mark.parametrize("name", LAST_GOOD)
def test_search_crop_h_matches_jax(name, square):
    """The device search box's crop homography, including the ``bad``
    branch (a box that left the frame, which ``square`` shifts back into
    it, or a non-finite estimate: the whole frame is searched) and
    ``square`` on and off."""
    h = LAST_GOOD[name].astype(np.float32)
    corners = np.array([[40.0, 30.0], [100.0, 30.0], [100.0, 70.0],
                        [40.0, 70.0]], np.float32)
    jwp = jws.WindowParams(size=(48, 80), margin=0.4, min_px=20,
                           square=square)
    twp = tws.WindowParams(size=(48, 80), margin=0.4, min_px=20,
                           square=square)
    want = np.asarray(jws._search_crop_h(jnp.asarray(h), jnp.asarray(corners),
                                         (96, 128), jwp))
    got = tws._search_crop_h(torch.from_numpy(h), torch.from_numpy(corners),
                             (96, 128), twp).numpy()
    np.testing.assert_allclose(got, want, rtol=CROP_RTOL, atol=1e-6)
    if "non-finite" in name or ("escaped" in name and not square):
        # the whole 96 x 128 frame into the window
        np.testing.assert_allclose(got[[0, 1], [0, 1]], [80 / 128, 48 / 96],
                                   rtol=1e-6)


@pytest.mark.parametrize("box,want", [
    ((360, 720, 360, 640), (192, 344)),     # bench.py's centred W/3 x H/3
    ((30, 40, 40, 60), None),               # wide
    ((10, 50, 90, 20), None),               # tall
    ((0, 0, 100, 5), None),                 # aspect clipped at 1/2.5
], ids=["bench-1080p", "wide", "tall", "clipped"])
def test_window_params_for_mask_matches_jax(box, want):
    y0, x0, h, w = box
    mask = np.zeros((1080, 1920) if want else (128, 160), bool)
    mask[y0:y0 + h, x0:x0 + w] = True
    got = tws.window_params_for_mask(mask, size=256)
    ref = jws.window_params_for_mask(mask, size=256)
    assert got.shape == ref.shape
    assert (got.margin, got.min_px, got.square) == (ref.margin, ref.min_px,
                                                    ref.square)
    assert got.shape[0] % 8 == 0 and got.shape[1] % 8 == 0
    if want:
        assert got.shape == want
    got_t = tws.window_params_for_mask(torch.from_numpy(mask), size=256)
    assert got_t.shape == ref.shape


# JAX resamples with one-hot matmuls from (x - t) / s, the port through the
# float32 inverse homography (kernel A's arithmetic): the source coordinates
# differ in their last bits, so the pixels differ by at most the image's
# gradient times that, a few 1e-3 of [0, 255].
WARP_ATOL = 2e-2


@pytest.mark.parametrize("scale,t,out_hw", [
    ((0.3, 0.3), (-20.0, -12.5), (32, 56)),     # a window crop, partly off
    ((1.0, 1.0), (-17.0, -9.0), (48, 80)),      # native scale
    ((2.5, 1.75), (-100.0, 10.0), (64, 64)),    # up-scaled, anisotropic
], ids=["down-partly-off", "native", "up-aniso"])
def test_warp_axis_aligned_matches_jax(scale, t, out_hw):
    img = textured(108, 192, seed=4).astype(np.float32)[None]
    H = np.array([[scale[0], 0, t[0]], [0, scale[1], t[1]], [0, 0, 1]],
                 np.float32)
    want = np.asarray(jwarp.warp_axis_aligned(jnp.asarray(img),
                                              jnp.asarray(H), out_hw))
    got = twarp.warp_axis_aligned(torch.from_numpy(img), torch.from_numpy(H),
                                  out_hw)
    assert got.shape == want.shape == (1, *out_hw, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=WARP_ATOL, rtol=0)
    # on the CPU it is the plain warp, the function kernel A computes
    np.testing.assert_array_equal(
        got, twarp.warp_perspective(torch.from_numpy(img),
                                    torch.from_numpy(H), out_hw))


def test_nearest_mask_warp_against_cv2():
    """The template mask's warp into the window (``warp_mask_nearest``:
    the port's float32 ``warp_perspective(mode='nearest')``) against the
    reference's ``cv2.warpPerspective(..., INTER_NEAREST)``.

    They agree bit for bit except where a pixel's source coordinate lies
    at a half-pixel tie: OpenCV rounds it to even in float64, the port
    rounds it up (``floor(x + 0.5)``) in float32, whose inverse and
    products can also put a coordinate within ~1e-4 of a tie on the other
    side. Such pixels sit on whole rows or columns of the mask's edge.
    Below: crops of the kind the window tracker makes, with every
    disagreement pinned to a tie, and one crop made of ties, where half of
    the edge columns differ."""
    rng = np.random.default_rng(0)
    n_diff = 0
    for _ in range(40):
        H_img, W_img = rng.integers(100, 400), rng.integers(100, 600)
        y0, x0 = rng.integers(0, H_img - 20), rng.integers(0, W_img - 20)
        y1, x1 = rng.integers(y0 + 8, H_img), rng.integers(x0 + 8, W_img)
        mask = np.zeros((H_img, W_img), np.uint8)
        mask[y0:y1, x0:x1] = 1
        box = tbbox.Bbox.from_mask(mask > 0).with_margins(0.5)
        out_hw = tuple(int(v) for v in rng.choice([48, 64, 80, 96], 2))
        if rng.random() < 0.5:
            box = box.with_aspect(out_hw[1] / out_hw[0])
        H = tbbox.h_bbox2bbox(box, tbbox.Bbox.from_xywh(
            (0, 0, out_hw[1], out_hw[0])))
        want = cv2.warpPerspective(mask, H, out_hw[::-1],
                                   flags=cv2.INTER_NEAREST) > 0
        got = twin.warp_mask_nearest(mask, H, out_hw)
        diff = got != want
        n_diff += int(diff.sum())
        # the float64 source coordinate of every disagreeing pixel is a tie
        ys, xs = np.nonzero(diff)
        src = thom.np_h_proj(np.linalg.inv(H), np.stack([xs, ys]).astype(
            np.float64))
        tie = np.abs(src - np.floor(src) - 0.5) < 1e-4
        assert tie.any(axis=0).all()
    # a crop made of ties: source x = (x + 1) / 2 at scale 2 lands on
    # k + 0.5 for every even x
    mask = np.zeros((40, 60), np.uint8)
    mask[10:30, 15:45] = 1
    H = np.array([[2.0, 0, -1.0], [0, 2.0, 0], [0, 0, 1]])
    want = cv2.warpPerspective(mask, H, (64, 48), flags=cv2.INTER_NEAREST) > 0
    got = twin.warp_mask_nearest(mask, H, (48, 64))
    cols = np.nonzero((got != want).any(axis=0))[0]
    assert len(cols) > 0 and all(c % 2 == 0 for c in cols)
    assert (got != want).sum() <= 2 * 40      # the two edge columns at most
    assert n_diff < 0.01 * 40 * 96 * 96


# ---------------------------------------------------------------------------
# the trackers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """One set of seeded weights for both packages: the state dict, its
    JAX tree, and a ``torch.save`` file both packages' ``RaftFlow`` load
    (the JAX package through its reference-checkpoint loader)."""
    model = traft.init_raft_params(traft.RaftConfig(iters=2), seed=3)
    path = tmp_path_factory.mktemp("weights") / "wraft_seed3.pt"
    torch.save(model.state_dict(), path)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                params_to_jax_numpy(model.state_dict()))
    return model.state_dict(), jp, path


def walk(template, n, step=(1.5, -1.0), rot=0.01, persp=1e-5):
    """(frames as BGR uint8, truths cur -> template) of a homography walk
    rendered by the plain warp."""
    frames, truths = [], []
    for t in range(1, n + 1):
        c, s = np.cos(rot * t) * (1 + 0.01 * t), np.sin(rot * t)
        h = np.array([[c, -s, step[0] * t], [s, c, step[1] * t],
                      [persp * t, 0, 1]], np.float32)
        f = twarp.warp_perspective(
            torch.from_numpy(template.astype(np.float32))[None],
            torch.from_numpy(np.linalg.inv(h)))[0]
        frames.append(f.round().clamp(0, 255).numpy().astype(np.uint8))
        truths.append(h)
    return frames, truths


WINDOW_MODES = {
    "aniso": dict(window_aniso_crop=True),
    "iso": {},
    "native": dict(window_native_scale=True, window_max_px=128,
                   window_snap_px=32),
}


def _window_trackers(mode, weights, redetection="inliers"):
    """The port's and the JAX ``WOFTWindowTracker`` under their
    ``configs/WOFT_window.py``, 64-px window, 2 iterations, the same
    seeded weights, loaded from one file."""
    from woft_tpu.config import load_config as jload_config
    path = weights[2]
    trackers = []
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            conf = load_config(ROOT / "woft_tpu_torch" / "configs"
                               / "WOFT_window.py")
            tp = tw.TrackerParams(redetection=redetection)
        else:
            conf = jload_config(ROOT / "woft_tpu" / "configs"
                                / "WOFT_window.py")
            tp = jw.TrackerParams(redetection=redetection)
        conf.flow_config.iters = 2
        conf.flow_config.model = path
        conf.window_size = 64
        conf.tracker_params = tp
        for key, value in WINDOW_MODES[mode].items():
            setattr(conf, key, value)
        trackers.append(twin.WOFTWindowTracker(conf, device="cpu")
                        if pkg == "torch" else conf.tracker_class(conf))
    return trackers


@pytest.mark.parametrize("mode,redetection", [
    ("aniso", "inliers"), ("iso", "inliers"), ("native", "inliers"),
    ("iso", "never")], ids=["aniso", "iso", "native", "iso-lost-fallback"])
def test_window_tracker_matches_jax(weights, mode, redetection):
    """``WOFTWindowTracker`` against the JAX package's, frame by frame on a
    4-frame walk: the window shape, the template crop, the search boxes and
    the per-frame H. ``never`` fails every check: the local-flow fallback
    runs each frame and the lost counter climbs."""
    template = textured(160, 224, seed=1)
    mask = np.zeros((160, 224), np.uint8)
    mask[60:100, 80:140] = 1
    frames, truths = walk(template, 4)
    tt, jt = _window_trackers(mode, weights, redetection)
    tt.init(template, mask)
    jt.init(template, mask)
    assert tt.win_hw == jt.win_hw
    np.testing.assert_allclose(tt.h_tmpl_crop, jt.h_tmpl_crop, rtol=1e-12)
    # the crops' masks agree here (no half-pixel ties, see the cv2 test)
    np.testing.assert_array_equal(tt.state.template_mask.numpy(),
                                  np.asarray(jt.state.template_mask))
    corners = np.array([[80, 60], [139, 60], [139, 99], [80, 99]], float).T
    for t, f in enumerate(frames):
        Ht, mt = tt.track(f)
        Hj, mj = jt.track(f)
        # the boxes follow the two packages' estimates
        np.testing.assert_allclose(mt.search_bbox, mj.search_bbox,
                                   rtol=0, atol=CORNER_TOL)
        assert bool(mt.global_H_success) == bool(mj.global_H_success)
        assert int(mt.N_lost) == int(mj.N_lost)
        if redetection == "never":
            assert int(mt.N_lost) == t + 1
        assert np.isfinite(Ht).all() and Ht.dtype == np.float64
        assert corner_err(Ht, Hj, corners) < CORNER_TOL
        np.testing.assert_array_equal(mt.estim_H_current2template, Ht)
    if redetection == "inliers":
        assert bool(mt.global_H_success)


def test_window_max_px_must_be_a_multiple_of_8():
    """The reference's caveat (``woft_tpu/tracker/window.py:78``) guarded
    in the port, beside the ``window_snap_px`` check it already has."""
    conf = load_config(ROOT / "woft_tpu_torch" / "configs"
                       / "WOFT_window_native.py")
    conf.flow_config.model = None
    conf.window_max_px = 300
    with pytest.raises(ValueError, match="window_max_px"):
        twin.WOFTWindowTracker(conf, device="cpu")
    conf.window_max_px = 512
    conf.window_snap_px = 20
    with pytest.raises(ValueError, match="window_snap_px"):
        twin.WOFTWindowTracker(conf, device="cpu")
