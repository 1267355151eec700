"""Synthetic-sequence tracker evaluation.

PyTorch twin of ``woft_tpu/eval/synth_eval.py``: a video made by warping
one base frame along a smooth random homography trajectory (exact ground
truth a frame), a tracker run over it, and POT-style alignment metrics. It
needs no benchmark data and exercises the whole tracker (pre-warp, flow,
fit, fallback ladder).

The trajectory and the noise are numpy, drawn from the caller's
``np.random.Generator`` in the JAX package's order, so both packages score
a seed on the same ground truth. The frames are rendered on the tracker's
device by the port's bilinear warp (kernel A on the card, a chunk of
frames a launch) where the JAX package calls ``cv2.warpPerspective``.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..geometry.bbox import Bbox
from ..geometry.homography import np_compose_h
from ..ops.warp import warp_perspective_fast
from .metrics import alignment_error, success_rates

#: bytes of float32 output one render launch may hold (about 40 frames of
#: 1920x1080, 90 of 1280x720)
RENDER_CHUNK_BYTES = 1 << 30


def synth_trajectory(rng, n_frames, height, width, *, max_step_px=4.0,
                     max_rot=0.004, max_scale=0.003, max_persp=2e-6,
                     jump_every=0, jump_px=0.0):
    """Smooth random homography walk.

    ``jump_every > 0`` injects a large translation jolt every that many
    frames (breaking the trajectory's smoothness): the stress mode that
    trips the inlier check and exercises the redetection and fallback
    ladder with a real network.

    Returns (T, 3, 3) H_cur2init: frame t pixels -> frame 0 pixels."""
    hs = [np.eye(3)]
    step = np.eye(3)
    for t in range(n_frames - 1):
        jitter = np.eye(3)
        ang = rng.uniform(-max_rot, max_rot)
        scale = 1.0 + rng.uniform(-max_scale, max_scale)
        c, s = np.cos(ang), np.sin(ang)
        jitter[:2, :2] = scale * np.array([[c, -s], [s, c]])
        jitter[0, 2] = rng.uniform(-max_step_px, max_step_px)
        jitter[1, 2] = rng.uniform(-max_step_px, max_step_px)
        jitter[2, 0] = rng.uniform(-max_persp, max_persp)
        jitter[2, 1] = rng.uniform(-max_persp, max_persp)
        # smooth: blend the per-frame step towards the new jitter
        step = 0.8 * step + 0.2 * jitter
        step /= step[2, 2]
        inst = step
        if jump_every and (t + 1) % jump_every == 0:
            jolt = np.eye(3)
            jolt[0, 2] = rng.choice([-1, 1]) * jump_px
            jolt[1, 2] = rng.choice([-1, 1]) * jump_px * 0.5
            inst = jolt @ step
        hs.append(np_compose_h(np.linalg.inv(inst), hs[-1]))
    return np.stack(hs)


def render_sequence(base_frame, h_cur2init, device=None):
    """Render frames: frame_t(x) = base(H_cur2init_t(x)), 0 outside.

    base_frame: (H, W, 3) uint8; h_cur2init: (T, 3, 3). Returns T (H, W, 3)
    uint8 numpy frames. ``warp_perspective_fast(base, inv(H))`` on
    ``device`` (default ``cuda``): on the card kernel A, one launch for
    each chunk of frames whose float32 output fits ``RENDER_CHUNK_BYTES``;
    rounded to uint8 there and downloaded. ``cv2.warpPerspective``
    (INTER_LINEAR) blends uint8 in fixed point, this warp in float32: with
    OpenCV 5.0.0 the two differ by at most 1 level, on under 0.1 % of the
    values (``tests/test_torch_eval.py:RENDER_BOUND_LEVELS``)."""
    dev = resolve_device(device)
    H, W = base_frame.shape[:2]
    base = torch.from_numpy(np.ascontiguousarray(base_frame)).to(dev)
    base = base.to(torch.float32)[None]
    fwd = torch.from_numpy(np.linalg.inv(h_cur2init)).to(
        dev, torch.float32)
    chunk = max(1, RENDER_CHUNK_BYTES // (H * W * base.shape[-1] * 4))
    frames = []
    for hs in fwd.split(chunk):
        out = warp_perspective_fast(base, hs, (H, W))
        frames.extend(out.round_().clamp_(0, 255).to(torch.uint8).cpu()
                      .numpy())
    return frames


def evaluate_tracker_synthetic(tracker, base_frame, mask, *, n_frames=30,
                               seed=0, noise=0.0, device=None,
                               **traj_kwargs):
    """Track a synthetic sequence; return (metrics, h_pred, h_gt).

    tracker: object with the reference init/track API (e.g. WOFTTracker).
    base_frame: (H, W, 3) uint8 BGR; mask: (H, W) uint8. The frames render
    on ``device``, by default the tracker's (``tracker.device``), else
    ``cuda``. Noise is added on the host after the trajectory has drawn,
    and cast back with ``astype(uint8)``, which truncates, as in the JAX
    package.
    """
    if device is None:
        device = getattr(tracker, "device", None)
    rng = np.random.default_rng(seed)
    H, W = base_frame.shape[:2]
    h_gt = synth_trajectory(rng, n_frames, H, W, **traj_kwargs)
    frames = render_sequence(base_frame, h_gt, device=device)
    if noise:
        frames = [np.clip(f + rng.normal(0, noise, f.shape), 0,
                          255).astype(f.dtype) for f in frames]

    tracker.init(frames[0], mask)
    h_pred = [np.eye(3)]
    for frame in frames[1:]:
        h, _ = tracker.track(frame)
        h_pred.append(h)
    h_pred = np.stack(h_pred)

    box = Bbox.from_mask(mask > 0)
    corners = np.asarray(box.as_points(), float).T       # (2, 4)

    metrics = alignment_error(h_pred, h_gt, corners)
    metrics.update(success_rates(h_pred, h_gt, corners))
    return metrics, h_pred, h_gt
