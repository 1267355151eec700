"""The plain shared-flow multi-target step: N targets on one plane, one flow
a frame (WOFT's tracker, Serych & Matas, WACV 2023, run for several
targets of one template).

One step: pre-warp the frame by the control target's (target 0's) last
good homography, one flow from the template to the pre-warped frame
(``raft.py``), the template pixels whose destination lies in the frame and
in the region the pre-warp filled; then, for each target, its pixels among
those, subsampled to at most ``subsample_n`` by the 1-D Sobol draw, the
weights at those points, the weighted fit (float64), the inlier check, and
the fit composed with the pre-warp (``tracker.py``'s pieces). A target
whose check fails keeps its previous homography. Target 0's check drives
the pre-warp's ladder (``advance``): its last good homography, reset to the
identity after ``no_prewarp_after_n`` lost frames in a row.

The step is stateless: the caller passes the state it follows (the
pre-warp's H and each target's previous H). Departures from the
single-target step of ``tracker.py``, each the shared step's own:

- every target is pre-warped by target 0's last good H, not its own;
- no local fallback: a target whose check fails keeps its last H;
- no visibility mask joins the TC validity (the program's shared step
  drops it, ``woft_tpu_torch/tracker/woft.py:_flow_fits``).

Float32 with TF32 off, the fits in float64 (``plain_fp32``, set while a
step runs); nothing of the program is imported.
"""

import contextlib

import numpy as np
import torch

from . import tracker as rtracker
from . import warp as rwarp


@contextlib.contextmanager
def plain_fp32():
    """TF32 off for matrix products and cuDNN convolutions, and cuDNN's
    float32 algorithms chosen by timing them (``cudnn.benchmark``: at
    1080p its heuristics give one of the update block's convolutions a
    path of one small launch a cell, about 3 s a frame); restored after."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (flags[0].allow_tf32, flags[1].allow_tf32, flags[1].benchmark)
    flags[0].allow_tf32 = flags[1].allow_tf32 = False
    flags[1].benchmark = True
    try:
        yield
    finally:
        flags[0].allow_tf32, flags[1].allow_tf32, flags[1].benchmark = prev


def prewarp_h(last_good, n_lost, no_prewarp_after_n):
    """The H a frame is pre-warped by: the control target's last good one,
    or the identity once it was lost more than ``no_prewarp_after_n``
    frames in a row."""
    if n_lost > no_prewarp_after_n:
        return np.eye(3, dtype=np.asarray(last_good).dtype)
    return last_good


def advance(used, n_lost, H0, ok0):
    """The ladder after a frame pre-warped by ``used``: (last good H, lost
    counter), from target 0's answer ``H0`` and check ``ok0``."""
    return (H0, 0) if ok0 else (used, n_lost + 1)


class SharedTracker:
    """The step over a reference network (``raft.WeightedRaft``) for one
    template and N target masks ((N, H, W) bool tensor). ``tp``: the
    configuration's tracker parameters."""

    def __init__(self, net, template, masks, tp):
        with plain_fp32():                # the template's features
            self.one = rtracker.Tracker(net, template, masks[0], tp)
        self.masks = masks
        self.tp = tp

    @torch.no_grad()
    def step(self, frame, prewarp, h_last):
        """One frame given the state the program reported for it.

        ``prewarp``: (3, 3) float32 tensor, the H the frame is pre-warped by
        (target 0's last good H, after the ladder's reset); ``h_last``: (N,
        3, 3) array, each target's previous H. Returns a dict of numpy arrays:
        ``H`` (N, 3, 3) float64 (a passed check's fit composed with the
        pre-warp, else the target's previous H), ``ok`` (N,) and
        ``inlier_frac`` (N,)."""
        tp, one = self.tp, self.one
        with plain_fp32():
            prewarped = rwarp.warp(frame, prewarp)
            flow, weights = one.net.flow(one.first, prewarped)
            in_frame = one._in_frame(flow, prewarp)
        lg = prewarp.double().cpu().numpy()
        hs, oks, fracs = [], [], []
        for t, mask in enumerate(self.masks):
            src, dst, wt, keep = one._tcs(flow, weights,
                                          mask.reshape(-1) & in_frame)
            H_pw = rtracker.fit_homography(dst, src, wt)
            ok, frac = rtracker.inlier_check(H_pw, dst, src, keep,
                                             tp["inlier_px"],
                                             tp["min_inlier_frac"])
            H = H_pw @ lg
            H = H / H[2, 2]
            hs.append(H if ok else np.asarray(h_last[t], np.float64))
            oks.append(ok)
            fracs.append(frac)
        return {"H": np.stack(hs), "ok": np.array(oks),
                "inlier_frac": np.array(fracs)}
