"""The port's ``downscale`` option against ``cv2`` and ``woft_tpu`` on the
CPU: the resize twin of ``cv2.resize(INTER_LINEAR)`` (``ops/resize.py``),
the shell's mask handling and output-H compensation, and the shell under
``configs/WOFT_downscale_3x.py`` against the JAX shell under its twin.

Bounds:
- the resize equals ``cv2.resize`` exactly (0 levels), frames and masks,
  at 1280x720, 1920x1080, 481x641 and at the sizes whose 2x output rounds
  up (721x1283, 599x799), where OpenCV's area path averages the pixels of
  the partial last column and row and rounds the mean half to even;
- the shells: the projected template corners, in full-resolution pixels
  after the compensation, within 0.05 px (``CORNER_TOL``) of the JAX
  shell's, as the step parity tests hold them; the compensation itself to
  float64 rounding.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from woft_tpu_torch.config import Config, load_config
from woft_tpu_torch.geometry.homography import np_compose_h
from woft_tpu_torch.ops.resize import downscaled_size, resize_down
from woft_tpu_torch.tracker import woft as tw

from test_torch_tracker import CORNER_TOL
from test_torch_window import textured, walk

ROOT = Path(__file__).resolve().parent.parent


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


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.mark.parametrize("hw", [(720, 1280), (1080, 1920), (481, 641),
                                (721, 1283), (599, 799)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_resize_matches_cv2(cv2, hw):
    img = np.random.default_rng(hw[1]).integers(0, 256, hw + (3,),
                                                dtype=np.uint8)
    for s in (2, 3, 4):
        want = cv2.resize(img, None, fx=1 / s, fy=1 / s)
        got = resize_down(torch.from_numpy(img), s).numpy()
        assert got.shape == want.shape == downscaled_size(*hw, s) + (3,)
        np.testing.assert_array_equal(got, want)


def test_resize_masks_in_both_encodings(cv2):
    """A box at odd offsets in a 721x1283 mask, resized in its 0/1 and its
    0/255 encoding and thresholded > 0: each equals ``cv2`` in its own
    encoding, and at 2x the two encodings differ (the rounding of a
    quarter-covered block's mean)."""
    mask = np.zeros((721, 1283), np.uint8)
    mask[101:500, 203:900] = 1
    counts = {}
    for s in (2, 3, 4):
        for enc in (1, 255):
            want = cv2.resize(mask * enc, None, fx=1 / s, fy=1 / s) > 0
            got = resize_down(torch.from_numpy(mask * enc), s).numpy() > 0
            np.testing.assert_array_equal(got, want)
            counts[s, enc] = int(got.sum())
    assert counts[2, 1] != counts[2, 255]


def test_downscaled_size_rounds_half_to_even():
    assert downscaled_size(720, 1280, 3) == (240, 427)
    assert downscaled_size(721, 1283, 2) == (360, 642)
    assert downscaled_size(599, 799, 2) == (300, 400)
    with pytest.raises(ValueError):
        resize_down(torch.zeros(8, 8, dtype=torch.uint8), 5)
    with pytest.raises(ValueError):
        resize_down(torch.zeros(8, 8), 2)


def test_compensation_of_a_known_h():
    """The shell returns diag(s, s, 1) @ H @ diag(1/s, 1/s, 1) of the
    step's H (the reference's ``np_compose_h(H_down, H, H_up)``) and keeps
    the step's H in ``meta``; the step sees the resized frame."""
    from woft_tpu_torch.configs._ablation_base import build_config

    tracker = tw.WOFTTracker(build_config(downscale=2), device="cpu")
    H_small = np.array([[1.02, 0.01, 3.5], [-0.02, 0.99, -2.25],
                        [1e-4, -2e-4, 1.0]], np.float32)
    seen = []

    def step(model, state, frame):
        seen.append(tuple(frame.shape))
        return state, torch.from_numpy(H_small), {}

    img = textured(96, 130, seed=1)
    mask = np.zeros((96, 130), bool)
    mask[20:70, 30:100] = True
    tracker.init(img, mask)
    tracker._step = step
    H, meta = tracker.track(img)
    assert seen == [(1, 48, 65, 3)]
    np.testing.assert_array_equal(meta.estim_H_current2template,
                                  H_small.astype(np.float64))
    want = np.diag([2.0, 2.0, 1.0]) @ H_small.astype(np.float64) @ np.diag(
        [0.5, 0.5, 1.0])
    np.testing.assert_allclose(H, want / want[2, 2], rtol=1e-12)
    np.testing.assert_allclose(H, np_compose_h(
        np.diag([0.5, 0.5, 1.0]), H_small.astype(np.float64),
        np.diag([2.0, 2.0, 1.0])), rtol=1e-12)


def test_downscale_inputs_beside_tracker_params():
    """``config.downscale_inputs`` is honoured beside explicit tracker
    params that leave ``downscale`` at 0, as in the JAX package; the mask
    is resized before its one-blob check."""
    conf = Config()
    conf.flow_config = load_config(ROOT / "woft_tpu_torch" / "configs"
                                   / "flow" / "wraft_large.py")
    conf.flow_config.iters = 2
    conf.tracker_params = tw.TrackerParams(padding_mode="RAFT")
    conf.downscale_inputs = 4
    tracker = tw.WOFTTracker(conf, device="cpu")
    assert tracker.tp.downscale == 4
    img = textured(96, 128, seed=1)
    mask = np.zeros((96, 128), np.uint8)
    mask[20:70, 30:100] = 255
    mask[83:85, 3:5] = 255          # a speck the 4x resize drops
    tracker.init(img, mask)
    assert tuple(tracker.state.template_mask.shape) == (24, 32)


def test_shell_matches_jax_downscale_3x(cv2):
    """``WOFTTracker`` under the port's ``configs/WOFT_downscale_3x.py``
    against the JAX ``WOFTTracker`` under ``woft_tpu/configs/
    WOFT_downscale_3x.py``: both on the trained v4 weights (the torch
    export and the orbax checkpoint), 2 iterations, 3 frames of a 204x300
    walk resized to 68x100 (padded 72x104), full-resolution corners after
    the compensation."""
    from woft_tpu.config import load_config as jload_config
    from woft_tpu.geometry import np_h_proj

    template = textured(204, 300, seed=2)
    frames, _ = walk(template, 3, step=(3.0, -2.0))
    mask = np.zeros((204, 300), np.uint8)
    mask[51:150, 75:226] = 1
    corners = np.array([[75, 51], [225, 51], [225, 149], [75, 149]],
                       float).T

    jconf = jload_config(ROOT / "woft_tpu" / "configs"
                         / "WOFT_downscale_3x.py")
    jconf.flow_config.iters = 2
    jtracker = jconf.tracker_class(jconf)
    conf = load_config(ROOT / "woft_tpu_torch" / "configs"
                       / "WOFT_downscale_3x.py")
    conf.flow_config.iters = 2
    tracker = tw.WOFTTracker(conf, device="cpu")
    assert str(conf.flow_config.model).endswith("wraft_tpu_v4_torch.pt")
    assert "wraft_tpu_v4" in str(jconf.flow_config.model)

    jtracker.init(template, mask)
    tracker.init(template, mask)
    np.testing.assert_array_equal(tracker.state.template_mask.numpy(),
                                  np.asarray(jtracker.state.template_mask))
    for f in frames:
        Hj, mj = jtracker.track(f)
        Ht, mt = tracker.track(f)
        assert bool(mt.global_H_success) == bool(mj.global_H_success)
        err = np.linalg.norm(np_h_proj(Ht, corners) - np_h_proj(Hj, corners),
                             axis=0).max()
        assert err < CORNER_TOL
