"""The plain WOFT tracker step, frame by frame (Serych & Matas, WACV 2023).

One step: pre-warp the frame by the last good homography, flow from the
template to the pre-warped frame (``raft.py``), keep the template pixels
inside the target whose destination lies in the frame and in the region
the pre-warp filled, subsample them to at most ``subsample_n`` by a 1-D
Sobol draw, fit the pre-warped -> template homography by weighted least
squares (Hartley-normalised, H33 = 1, float64), check that more than
``min_inlier_frac`` of the points lie within ``inlier_px``, and compose
with the pre-warp. When the check fails, the local fallback: flow from
the previous frame to this one, fit on the target's pixels as the previous
homography places them, chained onto the previous homography.

The step is stateless: the caller passes the state it follows (the last
good and the previous homography). Images are (1, H, W, 3) float RGB.
"""

import numpy as np
import torch

from . import warp as rwarp


def sobol_1d(n):
    """First ``n`` points of the 1-D Sobol sequence (Gray-code order) as
    float32."""
    k = np.arange(n, dtype=np.uint64)
    gray = k ^ (k >> np.uint64(1))
    out = np.zeros(n, np.float64)
    scale = 0.5
    while gray.any():
        out += (gray & np.uint64(1)).astype(np.float64) * scale
        gray >>= np.uint64(1)
        scale *= 0.5
    return out.astype(np.float32)


def sobol_select(valid, n):
    """Indices (n,) into the slots of a (P,) bool validity and whether each
    gather slot holds a point. More than ``n`` valid slots: the valid ones
    at positions ``round(n_valid * sobol)`` (float32, half to even) of the
    compacted list, duplicates dropped; otherwise all of them."""
    valid = np.asarray(valid, bool)
    n_valid = int(valid.sum())
    cs = np.cumsum(valid)
    if n_valid > n:
        t = np.sort(np.round(np.float32(n_valid) * sobol_1d(n)).astype(
            np.int64))
        keep = np.concatenate([[True], t[1:] != t[:-1]])
    else:
        t = np.arange(n)
        keep = t < n_valid
    keep &= t < n_valid
    idx = np.searchsorted(cs, t + 1, side="left")
    return np.clip(idx, 0, valid.size - 1), keep


def _normalise(p, w):
    """Hartley normalisation with weighted statistics: (normed, T)."""
    ws = w.sum()
    mean = (p * w[:, None]).sum(0) / (ws + 1e-8)
    dist = np.linalg.norm(p - mean, axis=1)
    s = np.sqrt(2.0) / ((dist * w).sum() / (ws + 1e-8) + 1e-8)
    T = np.array([[s, 0, -s * mean[0]], [0, s, -s * mean[1]], [0, 0, 1.0]])
    return (p - mean) * s, T


def fit_homography(a, b, w):
    """Weighted least-squares H mapping points a -> b (N, 2), rows weighted
    by w (N,), float64. Returns (3, 3) with H33 = 1."""
    a, b, w = (np.asarray(t, np.float64) for t in (a, b, w))
    an, Ta = _normalise(a, w)
    bn, Tb = _normalise(b, w)
    x1, y1 = an[:, 0], an[:, 1]
    x2, y2 = bn[:, 0], bn[:, 1]
    o, z = np.ones_like(x1), np.zeros_like(x1)
    ax = np.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1], 1)
    ay = np.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1], 1)
    A = np.stack([ax, ay], 1).reshape(-1, 8) * np.repeat(w, 2)[:, None]
    rhs = np.stack([-y2, x2], 1).reshape(-1) * np.repeat(w, 2)
    sol = np.linalg.lstsq(A, rhs, rcond=None)[0]
    h = np.append(sol, 1.0).reshape(3, 3)
    H = np.linalg.inv(Tb) @ h @ Ta
    return H / (H[2, 2] + 1e-8)


def project(H, p):
    """(N, 2) points by (3, 3) H."""
    q = np.asarray(H, np.float64) @ np.vstack([p.T, np.ones(len(p))])
    return (q[:2] / q[2:]).T


def inlier_check(H, a, b, keep, inlier_px, min_frac):
    """(ok, inlier fraction) of H mapping a -> b over the kept points."""
    err = np.linalg.norm(project(H, a) - b, axis=1)
    k = keep.astype(np.float64)
    frac = float(((err <= inlier_px) * k).sum() / max(k.sum(), 1.0))
    return bool(frac > min_frac and np.isfinite(H).all()), frac


class Tracker:
    """The step over a reference network (``raft.WeightedRaft``) for one
    template. ``tp``: the configuration's tracker parameters."""

    def __init__(self, net, template, mask, tp):
        self.net, self.tp = net, tp
        self.template = template
        self.mask = mask                       # (H, W) bool tensor
        self.first = net.encode(template)
        self.hw = template.shape[1:3]

    def _tcs(self, flow, weights, valid):
        """Sobol-selected (src, dst, weight * kept, kept) of a flow (H, W,
        2) over the (H*W,) validity, as float64 numpy."""
        h, w = self.hw
        idx, keep = sobol_select(valid.cpu().numpy(), self.tp["subsample_n"])
        src = np.stack([idx % w, idx // w], 1).astype(np.float64)
        fl = flow.reshape(-1, 2)[torch.from_numpy(idx).to(flow.device)]
        dst = src + fl.double().cpu().numpy()
        wt = weights.reshape(-1)[torch.from_numpy(idx).to(flow.device)]
        wt = wt.double().cpu().numpy() * keep
        return src, dst, wt, keep

    def _in_frame(self, flow, last_good):
        """(H*W,) bool: destination in the frame and, under
        ``use_pw_mask``, in the region the pre-warp by ``last_good``
        filled (the rounded destination)."""
        h, w = self.hw
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=flow.device),
            torch.arange(w, dtype=torch.float32, device=flow.device),
            indexing="ij")
        dst = torch.stack([xs, ys], -1).reshape(-1, 2) + flow.reshape(-1, 2)
        di = torch.round(dst).long()
        ok = ~((dst < 0).any(1) | (di[:, 0] >= w) | (di[:, 1] >= h))
        if self.tp["use_pw_mask"]:
            pts = torch.stack([di[:, 0].clamp(0, w - 1),
                               di[:, 1].clamp(0, h - 1)], -1)
            ok &= rwarp.validity_at(last_good, (h, w), pts)
        return ok

    def step(self, frame, last_good, prev=None, prev_h=None):
        """One frame given the state the program reported for it.

        ``last_good``: (3, 3) float32 tensor the frame is pre-warped by.
        ``prev``, ``prev_h``: the previous frame and its homography, for
        the fallback (taken only when the check fails). Returns a dict:
        ``H_global`` (the global fit composed with the pre-warp), ``ok``,
        ``inlier_frac``, and ``H``, the step's answer (the fallback's when
        the check fails)."""
        tp = self.tp
        prewarped = rwarp.warp(frame, last_good)
        flow, weights = self.net.flow(self.first, prewarped)
        valid = self.mask.reshape(-1) & self._in_frame(flow, last_good)
        src, dst, wt, keep = self._tcs(flow, weights, valid)
        H_pw = fit_homography(dst, src, wt)
        ok, frac = inlier_check(H_pw, dst, src, keep, tp["inlier_px"],
                                tp["min_inlier_frac"])
        lg = last_good.double().cpu().numpy()
        H_global = H_pw @ lg
        H_global = H_global / H_global[2, 2]
        out = {"H_global": H_global, "ok": ok, "inlier_frac": frac,
               "H": H_global}
        if not ok and tp["redetection"] == "inliers" and prev is not None:
            out["H"] = self.local(prev, frame, prev_h)
        return out

    def local(self, prev, frame, prev_h):
        """The local fallback: flow previous -> current, the target as
        ``prev_h`` places it in the previous frame, the fit current ->
        previous chained onto ``prev_h``."""
        inv = torch.linalg.inv(prev_h.to(torch.float64)).to(torch.float32)
        m = rwarp.warp(self.mask[None, :, :, None].to(torch.float32), inv,
                       mode="nearest")
        flow, weights = self.net.flow(self.net.encode(prev), frame)
        valid = m.reshape(-1) > 0
        src, dst, wt, _ = self._tcs(flow, weights, valid)
        H_flow = fit_homography(dst, src, wt)
        H = H_flow @ prev_h.double().cpu().numpy()
        H = H / H[2, 2]
        return H if np.isfinite(H).all() else prev_h.double().cpu().numpy()
