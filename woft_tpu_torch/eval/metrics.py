"""Planar-tracking evaluation metrics (POT-benchmark style).

The port's own copy of ``woft_tpu/eval/metrics.py``: the per-frame
alignment error (mean corner distance between the predicted and the
ground-truth warps) and precision samples over error thresholds. numpy,
float64, on the port's ``np_h_proj``.
"""

import numpy as np

from ..geometry.homography import np_h_proj


def corner_errors(h_pred, h_gt, corners):
    """Per-frame mean corner distance.

    Args:
        h_pred, h_gt: (T, 3, 3) homography sequences (cur -> template).
        corners: (2, 4) template-frame corner points.
    Returns:
        (T,) mean corner alignment error in template pixels.
    """
    errs = []
    for hp, hg in zip(h_pred, h_gt):
        # compare the warp of template corners into the current frame
        p = np_h_proj(np.linalg.inv(hp), corners)
        g = np_h_proj(np.linalg.inv(hg), corners)
        errs.append(np.linalg.norm(p - g, axis=0).mean())
    return np.asarray(errs)


def alignment_error(h_pred, h_gt, corners):
    """Median, mean and 90th percentile corner alignment error over a
    sequence."""
    errs = corner_errors(h_pred, h_gt, corners)
    return {"median_px": float(np.median(errs)),
            "mean_px": float(np.mean(errs)),
            "p90_px": float(np.percentile(errs, 90))}


def success_rates(h_pred, h_gt, corners, thresholds=(2, 5, 10, 20)):
    """Fraction of frames with alignment error below each threshold
    (POT precision-plot samples)."""
    errs = corner_errors(h_pred, h_gt, corners)
    return {f"p@{t}px": float(np.mean(errs <= t)) for t in thresholds}
