"""The WOFT tracker: a per-frame step over an explicit state, and its shell.

PyTorch twin of ``woft_tpu/tracker/woft.py`` (the full-frame tracker):

- ``TrackerState``: template features, homography history, lost counters;
- ``build_track_step``: ``(model, state, frame) -> (state, H_cur2init,
  meta)`` — pre-warp by the last good H (kernel A on the card; exact
  float32 in every precision mode, where the reference relaxes its
  pre-warp in bf16 mode), WeightedRAFT
  flow against the cached template features with the sparse weight head,
  mask-as-weights TC selection (TC: a template<->current point pair from
  the dense flow), Sobol-500 gather, weighted-QR fit, the 5 px / 20 %
  inlier check, and the local-flow fallback with the lost-counter reset.
  Where the JAX step chooses the fallback inside ``lax.cond``, this step
  syncs the ``ok`` flag to the host and branches in Python, as the JAX
  package's big-frame ``host_fallback`` mode does;
- ``WOFTTracker``: the reference's ``init``/``track`` API (numpy BGR in,
  numpy H out).

Static-shape conventions are the JAX package's: boolean TC filtering is
validity masks and zero weights, Sobol-500 is a fixed 500-slot gather, and
the inlier fraction divides by the count of valid points.
"""

from dataclasses import dataclass, replace
from types import SimpleNamespace

import numpy as np
import scipy.ndimage
import torch

from ..device import resolve_device
from ..flow.wrapper import RaftFlow, upload_bgr
from ..geometry.homography import compose_h, find_homography_wls_qr, proj_errors
from ..models.raft import RaftConfig, encode_template, weighted_raft_forward
from ..ops.pad import make_padder
from ..ops.sampling import featuremap_coords, masked_sobol_gather
from ..ops.warp import (inverse_h, warp_perspective, warp_perspective_fast,
                        warp_validity_at)

_ESTIMATORS = ("wls_qr", "plain_qr")


@dataclass(frozen=True)
class TrackerParams:
    """Tracker configuration; defaults are the canonical WOFT settings.

    ``estimator``: 'wls_qr' (weighted QR) or 'plain_qr' (0/1 validity as
    weights). ``redetection``: 'inliers' | 'never' | 'always'.
    ``padding_mode``: 'nopad' (the one ported policy)."""
    subsample_n: int = 500
    inlier_px: float = 5.0
    min_inlier_frac: float = 0.2
    no_prewarp_after_n: int = 10
    estimator: str = "wls_qr"
    redetection: str = "inliers"
    padding_mode: str = "nopad"

    def __post_init__(self):
        if self.estimator not in _ESTIMATORS:
            raise ValueError(f"estimator '{self.estimator}' is not ported; "
                             f"use one of {_ESTIMATORS}")
        if self.redetection not in ("inliers", "never", "always"):
            raise ValueError(f"unknown redetection '{self.redetection}'")


@dataclass
class TrackerState:
    """Tracker state.

    template_img: (1, H, W, 3) float RGB template frame.
    template_feats: (fmap1, net0, inp) pre-encoded template features, or
        None when a ``flow_fn`` replaces the network.
    template_mask: (H, W) bool target mask.
    prev_img: (1, H, W, 3) float RGB previous frame.
    prev_h2init, last_good_h2init: (3, 3) float32.
    lost: bool. n_lost: int.
    """
    template_img: torch.Tensor
    template_feats: tuple
    template_mask: torch.Tensor
    prev_img: torch.Tensor
    prev_h2init: torch.Tensor
    last_good_h2init: torch.Tensor
    lost: bool = False
    n_lost: int = 0


def _estimate_h(tp: TrackerParams, pts_a, pts_b, weights, valid):
    """Fit H mapping pts_a -> pts_b. pts: (1, N, 2); weights: (1, N)
    sigmoided reliabilities; valid: (1, N) 0/1 selection."""
    if tp.estimator == "plain_qr":
        return find_homography_wls_qr(pts_a, pts_b, valid)
    return find_homography_wls_qr(pts_a, pts_b, weights * valid)


def _sparse_point_weights(weight_head_at, up_mask, idx, W_img, H1, W1):
    """sigmoid(convex_upsample(weight_head)/8) at full-res pixels ``idx``.

    Each full-res point's upsampled weight is the softmaxed 3x3 convex
    combination of its parent cell's neighbours' logits, and the head is
    per-cell independent, so only |idx| * 9 cells are evaluated.

    up_mask: (1, H1, W1, 9*64) pre-softmax; idx: (n,) int64 flat pixels.
    Returns (n,) float32 weights."""
    n = idx.shape[0]
    px = idx % W_img
    py = idx // W_img
    cx, sx = px // 8, px % 8
    cy, sy = py // 8, py % 8
    d = torch.arange(3, device=idx.device) - 1
    cyn = cy[:, None, None] + d[None, :, None]               # (n, 3, 1)
    cxn = cx[:, None, None] + d[None, None, :]               # (n, 1, 3)
    nb_ok = (cyn >= 0) & (cyn < H1) & (cxn >= 0) & (cxn < W1)
    cells = (cyn.clamp(0, H1 - 1) * W1 + cxn.clamp(0, W1 - 1)).reshape(n * 9)
    logits = weight_head_at(cells).reshape(n, 9)
    # outside-grid neighbours contribute logit 0 (the dense path's zero pad)
    logits = logits * nb_ok.reshape(n, 9).to(logits.dtype)

    m = up_mask.reshape(H1 * W1, 9, 8, 8)[cy * W1 + cx]      # (n, 9, 8, 8)
    m = torch.softmax(m, dim=1)
    msel = m[torch.arange(n, device=idx.device), :, sy, sx]  # (n, 9)
    return torch.sigmoid(torch.sum(msel * logits, dim=1))


def _select_tcs(flow, weights, valid_mask, n):
    """Dense flow -> fixed-size TC set.

    flow: (1, H, W, 2); weights: (1, H, W, 1) sigmoided or None;
    valid_mask: (H*W,) bool. Returns (src (1,n,2), dst (1,n,2), w (1,n) or
    None, valid (1,n) float, idx (n,))."""
    H, W = flow.shape[1:3]
    src = featuremap_coords((H, W), flow.device).T
    dst = src + flow.reshape(H * W, 2)
    idx, sel_valid = masked_sobol_gather(valid_mask, n)
    g_w = None if weights is None else weights.reshape(H * W)[idx][None]
    return (src[idx][None], dst[idx][None], g_w,
            sel_valid[None].to(torch.float32), idx)


def _select_tcs_sparse(flow, forward_out, valid_mask, n):
    """``_select_tcs`` with weights computed only at the selected points."""
    H, W = flow.shape[1:3]
    src_g, dst_g, _, sel, idx = _select_tcs(flow, None, valid_mask, n)
    w = _sparse_point_weights(forward_out["weight_head_at"],
                              forward_out["up_mask"], idx, W, H // 8, W // 8)
    return src_g, dst_g, w[None], sel


def _success_check(tp: TrackerParams, H, pts_a, pts_b, valid):
    """Inlier-fraction redetection check. pts: (1, N, 2), H maps a -> b;
    valid: (1, N). Returns (ok bool tensor, inlier fraction)."""
    errs = proj_errors(H, pts_a.transpose(1, 2), pts_b.transpose(1, 2))
    inliers = (errs <= tp.inlier_px).to(torch.float32) * valid
    frac = inliers.sum() / valid.sum().clamp(min=1.0)
    if tp.redetection == "never":
        ok = torch.zeros((), dtype=torch.bool, device=H.device)
    elif tp.redetection == "always":
        ok = torch.ones((), dtype=torch.bool, device=H.device)
    else:
        ok = frac > tp.min_inlier_frac
    return ok & torch.isfinite(H).all(), frac


def build_track_step(raft_cfg: RaftConfig, tp: TrackerParams, flow_fn=None):
    """The per-frame step ``(model, state, frame) -> (new_state, H_cur2init,
    meta)``.

    ``frame``: (1, H, W, 3) float RGB in [0, 255]. ``meta``: dict of the
    reference's diagnostics. ``flow_fn(model, img1, img2, template_feats)
    -> (flow (1,H,W,2), weights (1,H,W,1) sigmoided)`` replaces the flow
    network (the tests inject oracle flow here). Without it the main flow
    runs WeightedRAFT against the cached template features with the sparse
    weight head (the head and the convex upsample evaluated only at the
    cells the solver consumes), the fallback flow with the dense head.

    The step branches on the host: when the inlier check fails it runs the
    local fallback flow and adds its H to ``meta`` as ``H_local_cur2init``.
    That key follows the reference's ``host_fallback`` path, the one
    ``woft_tpu``'s ``WOFTTracker`` takes for frames of 400k pixels or more
    (1280x720 among them); the port has no other path."""

    def dense_flow(model, img1, img2):
        padder = make_padder(tp.padding_mode, img2.shape)
        p1, p2 = padder.pad(img1, img2)
        out = weighted_raft_forward(model, raft_cfg, p1, p2)
        return (padder.unpad(out["flow_up"]),
                torch.sigmoid(padder.unpad(out["weights_up"])))

    run_flow = flow_fn if flow_fn is not None else dense_flow

    def local_h(model, prev_img, frame, prev_h2init, template_mask):
        """Local fallback: prev -> current flow chained onto prev_h2init
        (dense weight head: the fallback is off the steady-state path)."""
        hw = frame.shape[1] * frame.shape[2]
        prev_mask = warp_perspective(
            template_mask[None, :, :, None].to(torch.float32),
            inverse_h(prev_h2init), mode="nearest")
        lvalid = prev_mask.reshape(hw) > 0
        lflow, lweights = run_flow(model, prev_img, frame)
        lsrc, ldst, lw, lsel, _ = _select_tcs(lflow, lweights, lvalid,
                                              tp.subsample_n)
        H_flow = _estimate_h(tp, ldst, lsrc, lw, lsel)[0]     # cur -> prev
        # H_flow applies first (cur -> prev), then prev_h2init (prev -> init)
        H_local = compose_h(H_flow, prev_h2init)
        return torch.where(torch.isfinite(H_local).all(), H_local,
                           prev_h2init)

    def step(model, state: TrackerState, frame):
        H_img, W_img = frame.shape[1:3]
        hw = H_img * W_img

        # redetection reset
        if state.n_lost > tp.no_prewarp_after_n:
            last_good = torch.eye(3, dtype=torch.float32, device=frame.device)
        else:
            last_good = state.last_good_h2init

        prewarped = warp_perspective_fast(frame, last_good)

        # global flow template -> prewarped current
        if flow_fn is None:
            fo = weighted_raft_forward(model, raft_cfg, None, prewarped,
                                       template_feats=state.template_feats,
                                       sparse_weight_head=True)
            flow = fo["flow_up"]
        else:
            flow, weights = flow_fn(model, state.template_img, prewarped,
                                    state.template_feats)

        # TC validity: template mask + pre-warp region / image bounds
        dst = (featuremap_coords((H_img, W_img), frame.device).T
               + flow.reshape(hw, 2))
        dst_int = torch.round(dst).long()
        oob = ((dst < 0).any(dim=-1) | (dst_int[:, 0] >= W_img)
               | (dst_int[:, 1] >= H_img))
        # the pre-warp validity mask is a box check on Hinv @ p, so
        # evaluating it at clip(dst_int) equals gathering the mask there
        pts = torch.stack([dst_int[:, 0].clamp(0, W_img - 1),
                           dst_int[:, 1].clamp(0, H_img - 1)], dim=-1)
        in_pw = ~oob & warp_validity_at(last_good, (H_img, W_img), pts)
        valid = state.template_mask.reshape(hw) & in_pw

        if flow_fn is None:
            src_g, dst_g, w_g, sel = _select_tcs_sparse(flow, fo, valid,
                                                        tp.subsample_n)
        else:
            src_g, dst_g, w_g, sel, _ = _select_tcs(flow, weights, valid,
                                                    tp.subsample_n)

        # weighted fit: current-prewarped -> template
        H_pw2init = _estimate_h(tp, dst_g, src_g, w_g, sel)     # (1,3,3)
        H_global = compose_h(last_good, H_pw2init[0])
        ok, inlier_frac = _success_check(tp, H_pw2init, dst_g, src_g, sel)
        ok = bool(ok)                   # host sync: the branch below is Python

        if tp.redetection == "always" or ok:
            H_cur2init = H_global
        else:
            H_cur2init = local_h(model, state.prev_img, frame,
                                 state.prev_h2init, state.template_mask)

        n_lost = 0 if ok else state.n_lost + 1
        new_state = TrackerState(
            template_img=state.template_img,
            template_feats=state.template_feats,
            template_mask=state.template_mask,
            prev_img=frame,
            prev_h2init=H_cur2init,
            last_good_h2init=H_cur2init if ok else last_good,
            lost=not ok,
            n_lost=n_lost)
        meta = {
            "last_good_H2init": last_good,
            "H_global_cur2init": H_global,
            "global_H_success": ok,
            "inlier_frac": inlier_frac,
            "lost": not ok,
            "N_lost": n_lost,
        }
        if not (tp.redetection == "always" or ok):
            meta["H_local_cur2init"] = H_cur2init
        return new_state, H_cur2init, meta

    return torch.no_grad()(step)


def tracker_init_state(model, raft_cfg: RaftConfig, tp: TrackerParams,
                       template_img, template_mask, encode=True):
    """The initial TrackerState. template_img: (1, H, W, 3) float RGB;
    template_mask: (H, W) bool. ``encode=False`` skips the template
    features (oracle-flow tests)."""
    feats = None
    if encode:
        padder = make_padder(tp.padding_mode, template_img.shape)
        (padded,) = padder.pad(template_img)
        feats = encode_template(model, raft_cfg, padded)
    eye = torch.eye(3, dtype=torch.float32, device=template_img.device)
    return TrackerState(
        template_img=template_img,
        template_feats=feats,
        template_mask=template_mask,
        prev_img=template_img,
        prev_h2init=eye,
        last_good_h2init=eye)


class WOFTTracker:
    """Host shell with the reference tracker API: numpy BGR uint8 in, numpy
    float64 H (current -> template) out.

    ``config`` is a Config with ``flow_config`` (a ``RaftFlow`` config) and
    ``tracker_params`` (TrackerParams, or falsy for the canonical ones).
    Runs on ``device`` (default ``cuda``; raises without a card).
    ``raft_flags``: fields of ``RaftConfig`` that no config file carries,
    set on top of the flow config's, e.g. ``{"gru_fused": True,
    "tail_fused": True}`` for the fused refinement loop (the JAX package's
    ``bench.py`` sets its counterparts the same way, outside the configs)."""

    def __init__(self, config, device=None, raft_flags=None):
        self.C = config
        self.device = resolve_device(device)
        if config.downscale_inputs:
            raise NotImplementedError("input downscaling is not ported yet")
        of_class = config.flow_config.of_class or RaftFlow
        if of_class is not RaftFlow:
            raise NotImplementedError(f"flow wrapper {of_class} is not ported")
        self.tp = (config.tracker_params
                   if isinstance(config.tracker_params, TrackerParams)
                   else TrackerParams(padding_mode=str(
                       config.flow_config.padding_mode or "nopad")))
        self.flower = RaftFlow(config.flow_config, device=self.device)
        self.raft_cfg = replace(self.flower.cfg, **(raft_flags or {}))
        self._step = build_track_step(self.raft_cfg, self.tp)
        self.state = None

    def init(self, img, mask, img_identifier=None):
        """Start a track on ``img`` with the target ``mask`` (one blob)."""
        mask = np.asarray(mask) > 0
        _, n_blobs = scipy.ndimage.label(mask, structure=np.ones((3, 3)))
        if n_blobs != 1:
            raise ValueError(f"template mask must be one blob, got {n_blobs}")
        self.state = tracker_init_state(
            self.flower.model, self.raft_cfg, self.tp,
            upload_bgr(img, self.device),
            torch.from_numpy(mask).to(self.device))

    def track(self, input_img, img_identifier=None):
        """-> (H_cur2init (3, 3) float64, meta namespace)."""
        self.state, H_dev, meta_dev = self._step(
            self.flower.model, self.state, upload_bgr(input_img, self.device))
        H = H_dev.cpu().numpy().astype(np.float64)
        meta = SimpleNamespace(**{
            k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in meta_dev.items()})
        meta.estim_H_current2template = H.copy()
        return H, meta
