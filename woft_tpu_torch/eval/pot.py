"""POT-benchmark real-data evaluation: annotation reader and corner scoring.

The port's own copy of ``woft_tpu/eval/pot.py``:

- ``read_pot_annotations``: the POT ground-truth format, one line a frame
  of 8 whitespace- or comma-separated numbers ``x1 y1 x2 y2 x3 y3 x4 y4``
  (the target's 4 corners in frame coordinates; short or unparseable
  lines mark unlabeled frames);
- ``evaluate_pot_sequence``: drive a tracker over the frames (decoded with
  ``cv2.imread``), project the first frame's corners through the estimated
  homographies and score them (``corner_error_stats``);
- ``corners_from_homographies``: a stored homography run (the demo's
  ``homographies.npz``) as per-frame corners, a regression anchor on
  footage without manual ground truth;
- ``mask_from_corners``: the init mask, rasterised by ``cv2.fillPoly``,
  whose edge rules define which pixels the target holds.

``cv2`` is loaded inside the two functions that need it
(``geometry/homography.py:_cv2``).
"""

import numpy as np

from ..geometry.homography import _cv2, np_h_proj


def read_pot_annotations(path):
    """Parse a POT annotation file -> (T, 4, 2) corner array.

    Lines: 8 numbers a frame (4 corners, x y interleaved), separated by
    whitespace or commas. Short or unparseable lines yield NaN rows (frames
    without ground truth, skipped by the metrics)."""
    rows = []
    with open(path) as fin:
        for line in fin:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            vals = line.split()
            if len(vals) < 8:
                rows.append(np.full((4, 2), np.nan, np.float64))
                continue
            try:
                nums = np.asarray([float(v) for v in vals[:8]], np.float64)
            except ValueError:
                rows.append(np.full((4, 2), np.nan, np.float64))
                continue
            rows.append(nums.reshape(4, 2))
    return np.stack(rows) if rows else np.zeros((0, 4, 2))


def mask_from_corners(shape_hw, corners):
    """Rasterise a 4-corner quad into a binary (0/255 uint8) init mask."""
    cv2 = _cv2("mask_from_corners")
    mask = np.zeros(shape_hw, np.uint8)
    cv2.fillPoly(mask, [np.round(corners).astype(np.int32)], 255)
    return mask


def corners_from_homographies(hs, init_corners):
    """Project template-frame corners (4, 2) through per-frame H_cur2init
    inverses -> (T, 4, 2) current-frame corners."""
    out = []
    for h in hs:
        out.append(np_h_proj(np.linalg.inv(h), init_corners.T).T)
    return np.stack(out)


def corner_error_stats(est_corners, gt_corners,
                       thresholds=(2, 5, 10, 15, 20)):
    """POT metrics from per-frame corner sets: alignment error (mean
    corner distance) median/mean/p90 and precision@thresholds. NaN ground
    truth rows (unlabeled frames) are excluded."""
    est = np.asarray(est_corners, np.float64)
    gt = np.asarray(gt_corners, np.float64)
    n = min(len(est), len(gt))
    est, gt = est[:n], gt[:n]
    labeled = np.isfinite(gt).all(axis=(1, 2))
    if not labeled.any():
        return {"frames": 0}
    errs = np.linalg.norm(est[labeled] - gt[labeled], axis=-1).mean(axis=-1)
    out = {"frames": int(labeled.sum()),
           "median_px": float(np.median(errs)),
           "mean_px": float(np.mean(errs)),
           "p90_px": float(np.percentile(errs, 90))}
    out.update({f"p@{t}px": float(np.mean(errs <= t)) for t in thresholds})
    return out


def evaluate_pot_sequence(tracker, frame_paths, gt_corners,
                          init_corners=None, max_frames=0):
    """Track a POT sequence and score it against ground-truth corners.

    Args:
        tracker: reference-API tracker (init/track, numpy BGR).
        frame_paths: ordered frame files.
        gt_corners: (T, 4, 2) ground truth (frame 0 included).
        init_corners: optional explicit init quad (defaults to
            ``gt_corners[0]``).
    Returns:
        (metrics dict, est_corners (T', 4, 2), hs (T', 3, 3)); frame 0 is
        the init frame and is not scored, the benchmark's convention.
    """
    cv2 = _cv2("evaluate_pot_sequence")
    first = cv2.imread(str(frame_paths[0]))
    if first is None:
        raise OSError(f"cannot decode {frame_paths[0]}")
    quad = np.asarray(init_corners if init_corners is not None
                      else gt_corners[0], np.float64)
    tracker.init(first, mask_from_corners(first.shape[:2], quad))

    est, hs = [], []
    for i, path in enumerate(frame_paths[1:], start=1):
        if max_frames and i > max_frames:
            break
        frame = cv2.imread(str(path))
        if frame is None:
            break
        h, _meta = tracker.track(frame)
        hs.append(h.copy())
        est.append(np_h_proj(np.linalg.inv(h), quad.T).T)
    est = np.stack(est) if est else np.zeros((0, 4, 2))
    metrics = corner_error_stats(est, gt_corners[1:])
    return metrics, est, np.stack(hs) if hs else np.zeros((0, 3, 3))
