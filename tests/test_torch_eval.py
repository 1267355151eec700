"""The port's evaluation (``woft_tpu_torch/eval``) against ``woft_tpu``'s on
the CPU.

Held bit for bit: ``synth_trajectory`` under both protocols of
``eval_woft.py`` (the default walk and ``--stress``), the metrics, the POT
reader, mask, corner projection and scoring. Held within stated bounds:
the port's render against ``cv2.warpPerspective`` (``RENDER_BOUND_LEVELS``)
and the slice as a whole, the port's ``evaluate_tracker_synthetic`` on its
``WOFTTracker`` against ``woft_tpu``'s on its own, with ``render_sequence``
patched to the port's CPU render so both track the same pixels: per-frame
corners and every metric within 0.05 px (``CORNER_TOL``); the resume
(``set_fast_meta``) the same way. Both trackers run
``configs/WOFT.py`` with one set of seeded weights loaded from one file, 2
iterations, on 96x128 frames.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from woft_tpu.eval import metrics as jmetrics
from woft_tpu.eval import pot as jpot
from woft_tpu.eval import synth_eval as jsynth
from woft_tpu_torch.config import load_config
from woft_tpu_torch.eval import metrics as tmetrics
from woft_tpu_torch.eval import pot as tpot
from woft_tpu_torch.eval import synth_eval as tsynth
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.tracker import woft as tw

from test_torch_tracker import CORNER_TOL
from test_torch_window import textured

ROOT = Path(__file__).resolve().parent.parent
H_IMG, W_IMG = 96, 128

# The port's render against cv2.warpPerspective(INTER_LINEAR), uint8: the
# port blends the float32 source coordinate in float32 and rounds once;
# OpenCV blends in its own fixed point. Measured with OpenCV 5.0.0 on
# eval_woft.py's two protocols (12 frames at 96x128, 6 at 1280x720): at
# most 1 level, on 0.004-0.04 % of the values of textured frames and
# 0.04-0.05 % of uniform noise frames.
RENDER_BOUND_LEVELS = 1
RENDER_DIFF_SHARE = 1e-3

# eval_woft.py's trajectory arguments, per protocol
PROTOCOLS = {
    "default": dict(max_step_px=3.0),
    "stress": dict(max_step_px=8.0, max_rot=0.02, max_scale=0.01,
                   max_persp=1e-5, jump_every=10, jump_px=30.0),
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several worker processes run the suite at once; torch's default of
    one intra-op thread a core makes this module's small operations wait
    on each other. Two threads while it runs, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_synth_trajectory_is_bit_equal(protocol):
    """Both packages draw from the caller's generator in one order: the
    walks are equal, and so is the generator's state after them (the noise
    drawn next)."""
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    hj = jsynth.synth_trajectory(rj, 23, 720, 1280, **PROTOCOLS[protocol])
    ht = tsynth.synth_trajectory(rt, 23, 720, 1280, **PROTOCOLS[protocol])
    assert hj.shape == (23, 3, 3)
    assert np.array_equal(hj, ht)
    assert np.array_equal(rj.normal(0, 3, 16), rt.normal(0, 3, 16))


def test_metrics_are_bit_equal():
    rng = np.random.default_rng(1)
    h_gt = jsynth.synth_trajectory(rng, 12, H_IMG, W_IMG, max_step_px=4.0)
    h_pred = h_gt + rng.normal(0, 3e-3, h_gt.shape) * np.array(
        [1, 1, 300, 1, 1, 300, 1e-3, 1e-3, 0]).reshape(3, 3)
    corners = np.array([[32, 95, 95, 32], [24, 24, 71, 71]], float)
    assert np.array_equal(tmetrics.corner_errors(h_pred, h_gt, corners),
                          jmetrics.corner_errors(h_pred, h_gt, corners))
    for fn in ("alignment_error", "success_rates"):
        assert (getattr(tmetrics, fn)(h_pred, h_gt, corners)
                == getattr(jmetrics, fn)(h_pred, h_gt, corners))
    assert (tmetrics.success_rates(h_pred, h_gt, corners, (0.5, 1))
            == jmetrics.success_rates(h_pred, h_gt, corners, (0.5, 1)))


def test_pot_helpers_are_bit_equal(cv2, tmp_path):
    """The annotation reader (commas, comments, short and unparseable
    lines), the init mask's rasterisation, corner projection and the
    corner statistics."""
    ann = tmp_path / "seq.txt"
    ann.write_text("# x1 y1 ... x4 y4\n"
                   "10.5,20 60.25 21 59 70.5 11 69\n"
                   "\n"
                   "12 22 61 23 60 72 13 70 extra\n"
                   "nan nan nan nan nan nan nan nan\n"
                   "1 2 3\n"
                   "a b c d e f g h\n"
                   "13.5 23 62 24 61 73 14 71\n")
    gt = tpot.read_pot_annotations(ann)
    np.testing.assert_array_equal(gt, jpot.read_pot_annotations(ann))
    assert gt.shape == (6, 4, 2) and np.isnan(gt[2:5]).all()
    np.testing.assert_array_equal(tpot.mask_from_corners((96, 128), gt[0]),
                                  jpot.mask_from_corners((96, 128), gt[0]))
    hs = jsynth.synth_trajectory(np.random.default_rng(2), 6, 96, 128)
    est = tpot.corners_from_homographies(hs, gt[0])
    np.testing.assert_array_equal(
        est, jpot.corners_from_homographies(hs, gt[0]))
    assert (tpot.corner_error_stats(est, gt)
            == jpot.corner_error_stats(est, gt))
    assert tpot.corner_error_stats(est, gt)["frames"] == 3
    assert tpot.corner_error_stats(est[2:5], gt[2:5]) == {"frames": 0}


class _Replay:
    """A reference-API tracker that returns a fixed homography sequence
    and records the frames it was given."""

    def __init__(self, hs):
        self.hs = list(hs)
        self.seen = []

    def init(self, img, mask):
        self.seen.append((img.copy(), mask.copy()))

    def track(self, img):
        self.seen.append(img.copy())
        return self.hs.pop(0), SimpleNamespace()


def test_evaluate_pot_sequence_matches_jax(cv2, tmp_path):
    """The POT evaluation loop: decode order, init mask, the scored frames
    (``max_frames``), on a replayed homography sequence."""
    base = textured(H_IMG, W_IMG, seed=4)
    rng = np.random.default_rng(3)
    h_gt = jsynth.synth_trajectory(rng, 7, H_IMG, W_IMG)
    paths = []
    for i, f in enumerate(tsynth.render_sequence(base, h_gt, device="cpu")):
        paths.append(tmp_path / f"{i:03d}.png")
        cv2.imwrite(str(paths[-1]), f)
    quad = np.array([[30.0, 20.0], [97.0, 22.0], [95.0, 75.0], [31.0, 73.0]])
    gt = np.concatenate([quad[None],
                         jpot.corners_from_homographies(h_gt[1:], quad)])
    h_est = h_gt[1:] + 1e-3
    for max_frames in (0, 4):
        rt, rj = _Replay(h_est), _Replay(h_est)
        mt, et, ht = tpot.evaluate_pot_sequence(rt, paths, gt, quad,
                                                max_frames)
        mj, ej, hj = jpot.evaluate_pot_sequence(rj, paths, gt, quad,
                                                max_frames)
        assert mt == mj and mt["frames"] == (max_frames or 6)
        np.testing.assert_array_equal(et, ej)
        np.testing.assert_array_equal(ht, hj)
        for a, b in zip(rt.seen, rj.seen):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_render_against_cv2(cv2, protocol, monkeypatch):
    """The port's render (kernel A's plain version here) against
    ``cv2.warpPerspective``: within ``RENDER_BOUND_LEVELS`` everywhere and
    different on few pixels; rendering in chunks of 3 frames equals one
    chunk."""
    base = textured(H_IMG, W_IMG, seed=5)
    h_gt = jsynth.synth_trajectory(np.random.default_rng(11), 12, H_IMG,
                                   W_IMG, **PROTOCOLS[protocol])
    got = tsynth.render_sequence(base, h_gt, device="cpu")
    want = jsynth.render_sequence(base, h_gt)
    assert len(got) == len(want) == 12
    diff = np.abs(np.stack(got).astype(int) - np.stack(want))
    assert diff.max() <= RENDER_BOUND_LEVELS
    assert (diff > 0).mean() < RENDER_DIFF_SHARE
    monkeypatch.setattr(tsynth, "RENDER_CHUNK_BYTES", 3 * H_IMG * W_IMG * 12)
    chunked = tsynth.render_sequence(base, h_gt, device="cpu")
    np.testing.assert_array_equal(np.stack(chunked), np.stack(got))


def test_render_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = np.zeros((8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsynth.render_sequence(base, np.eye(3)[None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsynth.evaluate_tracker_synthetic(_Replay([]), base,
                                          np.ones((8, 8), np.uint8),
                                          n_frames=2)


# ---------------------------------------------------------------------------
# the slice as a whole: both packages' trackers on the same frames
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trackers(tmp_path_factory):
    """The port's and the JAX ``WOFTTracker`` under their
    ``configs/WOFT.py``, 2 iterations, one set of seeded weights loaded
    from one file (the JAX package through its reference-checkpoint
    loader). Module-scoped: each ``init`` restarts a tracker, and the JAX
    tracker compiles its step once."""
    from woft_tpu.config import load_config as jload_config

    model = traft.init_raft_params(traft.RaftConfig(iters=2), seed=3)
    path = tmp_path_factory.mktemp("weights") / "wraft_seed3.pt"
    torch.save(model.state_dict(), path)
    out = {}
    for pkg in ("torch", "jax"):
        load = load_config if pkg == "torch" else jload_config
        root = "woft_tpu_torch" if pkg == "torch" else "woft_tpu"
        conf = load(ROOT / root / "configs" / "WOFT.py")
        conf.flow_config.iters = 2
        conf.flow_config.model = path
        out[pkg] = (tw.WOFTTracker(conf, device="cpu") if pkg == "torch"
                    else conf.tracker_class(conf))
    return out


def _corners(hs, corners):
    from woft_tpu.geometry import np_h_proj
    return np.stack([np_h_proj(np.linalg.inv(h), corners) for h in hs])


def test_synthetic_eval_matches_jax(trackers, monkeypatch):
    """``evaluate_tracker_synthetic`` in both packages, 6 frames with
    sensor noise (the truncating cast after the trajectory's draws): the
    same ground truth bit for bit, per-frame corners and every metric
    within ``CORNER_TOL``."""
    base = textured(H_IMG, W_IMG, seed=6)
    mask = np.zeros((H_IMG, W_IMG), np.uint8)
    mask[H_IMG // 4:3 * H_IMG // 4, W_IMG // 4:3 * W_IMG // 4] = 255
    monkeypatch.setattr(jsynth, "render_sequence",
                        lambda b, h: tsynth.render_sequence(b, h, "cpu"))
    kw = dict(n_frames=6, seed=4, noise=3.0, max_step_px=3.0)
    mt, ht, gt = tsynth.evaluate_tracker_synthetic(trackers["torch"], base,
                                                   mask, **kw)
    mj, hj, gj = jsynth.evaluate_tracker_synthetic(trackers["jax"], base,
                                                   mask, **kw)
    assert np.array_equal(gt, gj)
    corners = np.array([[32, 95, 95, 32], [24, 24, 71, 71]], float)
    err = np.linalg.norm(_corners(ht, corners) - _corners(hj, corners),
                         axis=1)
    assert err.max() < CORNER_TOL, err
    assert mt.keys() == mj.keys()
    for k in mt:
        assert abs(mt[k] - mj[k]) < CORNER_TOL, (k, mt[k], mj[k])


def test_set_fast_meta_matches_jax(trackers):
    """Resume: the frame after ``set_fast_meta`` returns the injected H,
    the next is tracked from the state rebuilt on it; both within
    ``CORNER_TOL`` of the JAX shell's."""
    base = textured(H_IMG, W_IMG, seed=8)
    h_gt = jsynth.synth_trajectory(np.random.default_rng(5), 4, H_IMG,
                                   W_IMG, max_step_px=2.0)
    frames = tsynth.render_sequence(base, h_gt, device="cpu")
    mask = np.zeros((H_IMG, W_IMG), np.uint8)
    mask[24:72, 32:96] = 1
    corners = np.array([[32, 95, 95, 32], [24, 24, 71, 71]], float)
    hs = {}
    for pkg, tracker in trackers.items():
        tracker.init(frames[0], mask)
        h1, _ = tracker.track(frames[1])
        injected = SimpleNamespace(estim_H_current2template=h_gt[2])
        tracker.set_fast_meta(injected)
        h2, meta2 = tracker.track(frames[2])
        assert meta2 is injected
        np.testing.assert_array_equal(h2, h_gt[2])
        h3, _ = tracker.track(frames[3])
        hs[pkg] = [h1, h2, h3]
    err = np.linalg.norm(_corners(hs["torch"], corners)
                         - _corners(hs["jax"], corners), axis=1)
    assert err.max() < CORNER_TOL, err


def test_set_fast_meta_keeps_device_counters_under_no_local_h():
    """Under ``no_local_h`` the rebuilt lost counters stay 0-d tensors, the
    types the step takes; a tracker with ``downscale`` refuses to resume."""
    conf = load_config(ROOT / "woft_tpu_torch" / "configs" / "WOFT.py")
    conf.flow_config.iters = 1
    conf.tracker_params = tw.TrackerParams(no_local_h=True)
    tracker = tw.WOFTTracker(conf, device="cpu")
    img = textured(64, 96, seed=9)
    mask = np.zeros((64, 96), np.uint8)
    mask[16:48, 24:72] = 1
    tracker.init(img, mask)
    H = np.diag([1.0, 1.0, 1.0]) + np.array([[0, 0, 1.5], [0, 0, -1],
                                             [0, 0, 0]])
    tracker.set_fast_meta(SimpleNamespace(estim_H_current2template=H))
    tracker.track(img)
    st = tracker.state
    assert isinstance(st.lost, torch.Tensor) and st.lost.dtype == torch.bool
    assert isinstance(st.n_lost, torch.Tensor)
    assert st.n_lost.dtype == torch.int32 and st.n_lost.dim() == 0
    np.testing.assert_array_equal(st.last_good_h2init.numpy(),
                                  H.astype(np.float32))
    tracker.track(img)               # the step takes the rebuilt state
    assert not bool(tracker.state.lost)

    conf.tracker_params = tw.TrackerParams(downscale=2)
    with pytest.raises(NotImplementedError):
        tw.WOFTTracker(conf, device="cpu").set_fast_meta(SimpleNamespace())
