"""The WOFT tracker: a per-frame step over an explicit state, and its shell.

PyTorch twin of ``woft_tpu/tracker/woft.py`` (the full-frame tracker):

- ``TrackerState``: template features, homography history, lost counters;
- ``build_track_step``: ``(model, state, frame) -> (state, H_cur2init,
  meta)`` — pre-warp by the last good H (kernel A on the card; exact
  float32 in every precision mode, where the reference relaxes its
  pre-warp in bf16 mode), RAFT
  flow against the cached template features (WeightedRAFT's sparse weight
  head under ``nopad``; padded inputs and the dense head otherwise, or
  when ``sparse_weights`` is off; uniform weights under 'orig', and under
  'weighted_masked' its visibility mask joins the TC validity), or an
  external flow (``flow/external.py``), mask-as-weights TC selection (TC: a
  template<->current point pair from the dense flow), Sobol-500 gather,
  the fit (weighted QR, plain QR, IRLS-Huber, or a host fit through
  ``cv2``), the 5 px / 20 % inlier check, and the local-flow fallback
  with the lost-counter reset.
  Where the JAX step chooses the fallback inside ``lax.cond``, this step
  syncs the ``ok`` flag to the host and branches in Python, as the JAX
  package's big-frame ``host_fallback`` mode does. With ``no_local_h`` the
  step has no fallback and never syncs: the ladder is ``torch.where`` on
  device tensors, so the chunk loops (``pipeline.py``) queue frame after
  frame;
- ``build_shared_multi_step``: N targets from ONE full-frame flow a frame,
  the TC selection and fit batched over the targets;
- ``WOFTTracker``: the reference's ``init``/``track`` API (numpy BGR in,
  numpy H out), with its ``downscale`` option: frames and mask resized as
  ``cv2.resize`` does (``ops/resize.py``, on the device), the output H
  compensated back to full resolution.

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
from ..geometry.homography import (
    _cv2, compose_h, find_homography_cvransac, find_homography_irls_qr,
    find_homography_trs, find_homography_wls_qr, irls_huber, np_compose_h,
    proj_errors)
from ..models.raft import RaftConfig, encode_template, weighted_raft_forward
from ..ops.pad import make_padder
from ..ops.resize import SCALES, resize_down
from ..ops.sampling import featuremap_coords, masked_sobol_gather
from ..ops.warp import (inverse_h, warp_perspective, warp_perspective_fast,
                        warp_validity_at)

_ESTIMATORS = ("wls_qr", "plain_qr", "irls_huber", "cvransac", "trs")
_HOST_ESTIMATORS = ("cvransac", "trs")


@dataclass(frozen=True)
class TrackerParams:
    """Tracker configuration; defaults are the canonical WOFT settings, the
    fields and their order the JAX package's.

    ``estimator``: 'wls_qr' (weighted QR), 'plain_qr' (0/1 validity as
    weights), 'irls_huber' (``irls_iters + 1`` QR solves, Huber threshold
    ``irls_k``), or the host fits 'cvransac' (OpenCV RANSAC, ``ransac_thr``
    px, ``ransac_iters``) and 'trs' (a similarity), which need ``cv2`` and
    copy the points to the host once a frame.
    ``redetection``: 'inliers' | 'never' | 'always'.
    ``use_pw_mask``: keep only the TCs whose destination lies in the region
    the pre-warp filled.
    ``no_local_h``: skip the local-flow fallback; the steps then keep the
    ladder on the device and never sync to the host (with a device
    estimator).
    ``host_fallback``: accepted for the JAX package's configs and changes
    nothing: the port's steps always branch on the host, the JAX
    package's ``host_fallback`` behaviour.
    ``downscale``: the shell's input downscale factor (0: off; 1-4).
    ``padding_mode``: 'nopad' | 'crop' | 'RAFT' | 'Michal' (``ops/pad.py``).
    ``sparse_weights``: evaluate the weight head only at the cells the
    solver consumes; taken only under ``nopad`` (the same logits).
    ``multi_fit_chunk``: the shared-flow multi-target step fits at most
    this many targets at once, in groups beyond it (the sparse weight
    head's patch activations grow with the targets fitted together)."""
    subsample_n: int = 500
    inlier_px: float = 5.0
    min_inlier_frac: float = 0.2
    no_prewarp_after_n: int = 10
    estimator: str = "wls_qr"
    irls_k: float = 2.0
    irls_iters: int = 5
    ransac_thr: float = 3.0
    ransac_iters: int = 10000
    redetection: str = "inliers"
    use_pw_mask: bool = True
    no_local_h: bool = False
    host_fallback: bool = False
    downscale: int = 0
    padding_mode: str = "nopad"
    sparse_weights: bool = True
    multi_fit_chunk: int = 64

    def __post_init__(self):
        if self.estimator not in _ESTIMATORS:
            raise ValueError(f"estimator '{self.estimator}' is not ported; "
                             f"use one of {_ESTIMATORS}")
        if self.redetection not in ("inliers", "never", "always"):
            raise ValueError(f"unknown redetection '{self.redetection}'")
        if self.downscale and self.downscale not in SCALES:
            raise ValueError(f"downscale {self.downscale} is not supported; "
                             f"use 0 or one of {SCALES}")


@dataclass
class TrackerState:
    """Tracker state.

    template_img: (1, H, W, 3) float RGB template frame.
    template_feats: (fmap1, net0, inp) pre-encoded template features, or
        None when a ``flow_fn`` replaces the network.
    template_mask: (H, W) bool target mask.
    prev_img: (1, H, W, 3) float RGB previous frame.
    prev_h2init, last_good_h2init: (3, 3) float32.
    lost: bool. n_lost: int. Under ``no_local_h``: 0-d bool and int32
        device tensors.
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
    """Fit H mapping pts_a -> pts_b, one fit a row. pts: (B, N, 2);
    weights: (B, N) sigmoided reliabilities; valid: (B, N) 0/1 selection.
    Returns (B, 3, 3)."""
    if tp.estimator in _HOST_ESTIMATORS:
        return _host_fit(tp, pts_a, pts_b, valid)
    if tp.estimator == "plain_qr":
        return find_homography_wls_qr(pts_a, pts_b, valid)
    w = weights * valid
    if tp.estimator == "irls_huber":
        return find_homography_irls_qr(
            pts_a, pts_b, w, n_iter=tp.irls_iters,
            reweighting_fn=lambda r: irls_huber(r, k=tp.irls_k))
    return find_homography_wls_qr(pts_a, pts_b, w)


def _host_fit(tp: TrackerParams, pts_a, pts_b, valid):
    """The host fits ('cvransac', 'trs'), one target a row: the points copy
    to the host (a sync), each row fits on its valid points only, and a row
    with fewer than 4 of them or whose solver fails gets a NaN H, which the
    steps' finiteness guards send down the fallback ladder (the JAX
    package's ``_host_robust_fit``). Without ``cv2`` it raises."""
    cv2 = _cv2(tp.estimator)
    a = pts_a.cpu().numpy().astype(np.float64)
    b = pts_b.cpu().numpy().astype(np.float64)
    v = valid.cpu().numpy() > 0.5
    out = np.full((a.shape[0], 3, 3), np.nan, np.float32)
    for i in range(a.shape[0]):
        sa, sb = a[i][v[i]], b[i][v[i]]
        if sa.shape[0] < 4:
            continue
        try:
            if tp.estimator == "cvransac":
                out[i] = find_homography_cvransac(
                    sa[None], sb[None], max_iters=tp.ransac_iters,
                    thr=tp.ransac_thr)[0]
            else:
                out[i] = find_homography_trs(sa[None], sb[None])[0]
        except (RuntimeError, cv2.error):
            pass                        # NaN H: the fallback ladder
    return torch.from_numpy(out).to(pts_a.device)


def _sparse_point_weights(weight_head_at, up_mask, idx, W_img, H1, W1):
    """sigmoid(convex_upsample(weight_head)/8) at full-res pixels ``idx``.

    Each full-res point's upsampled weight is the softmaxed 3x3 convex
    combination of its parent cell's neighbours' logits, and the head is
    per-cell independent, so only |idx| * 9 cells are evaluated.

    up_mask: (B, H1, W1, 9*64) pre-softmax, B = 1 (one flow for every
    target) or N (a flow a target, rows ``b*H1*W1 + cell`` of
    ``weight_head_at``); idx: (N, n) int64 flat pixels, a row a target.
    Returns (N, n) float32 weights.

    A batch of targets that asks for more cells than its flows have (at
    1080p, 8 targets ask for 36,000 of 32,400) has the head evaluated once
    at every cell and gathered: the same logits, since the head is per
    cell, at a cost and a memory bounded by the grid (64 targets would ask
    for 288,000). One target keeps the sparse evaluation."""
    N, n = idx.shape
    px = idx % W_img
    py = idx // W_img
    cx, sx = px // 8, px % 8
    cy, sy = py // 8, py % 8
    # the first row of each target's flow
    base = (torch.arange(N, device=idx.device)[:, None] * (H1 * W1)
            if up_mask.shape[0] > 1 else torch.zeros_like(idx[:, :1]))
    d = torch.arange(3, device=idx.device) - 1
    cyn = cy[..., None, None] + d[:, None]                   # (N, n, 3, 1)
    cxn = cx[..., None, None] + d[None, :]                   # (N, n, 1, 3)
    nb_ok = (cyn >= 0) & (cyn < H1) & (cxn >= 0) & (cxn < W1)
    cells = cyn.clamp(0, H1 - 1) * W1 + cxn.clamp(0, W1 - 1)
    rows = (cells + base[..., None, None]).reshape(N * n * 9)
    n_cells = up_mask.shape[0] * H1 * W1
    if N > 1 and rows.numel() > n_cells:
        logits = weight_head_at(torch.arange(n_cells, device=idx.device))
        logits = logits[rows].reshape(N * n, 9)
    else:
        logits = weight_head_at(rows).reshape(N * n, 9)
    # outside-grid neighbours contribute logit 0 (the dense path's zero pad)
    logits = logits * nb_ok.reshape(N * n, 9).to(logits.dtype)

    parent = (base + cy * W1 + cx).reshape(N * n)
    m = up_mask.reshape(-1, 9, 8, 8)[parent]                 # (N*n, 9, 8, 8)
    m = torch.softmax(m, dim=1)
    msel = m[torch.arange(N * n, device=idx.device), :, sy.reshape(-1),
             sx.reshape(-1)]                                 # (N*n, 9)
    return torch.sigmoid(torch.sum(msel * logits, dim=1)).reshape(N, n)


def _select_tcs(flow, weights, valid_mask, n):
    """Dense flow -> fixed-size TC sets, one a target.

    flow: (B, H, W, 2) and weights (B, H, W, 1) sigmoided or None, B = 1
    (one flow for every target) or N; valid_mask: (H*W,) for one target or
    (N, H*W). Returns (src (N,n,2), dst (N,n,2), w (N,n) or None, valid
    (N,n) float, idx (N,n))."""
    H, W = flow.shape[1:3]
    valid_mask = valid_mask.reshape(-1, H * W)
    N = valid_mask.shape[0]
    src = featuremap_coords((H, W), flow.device).T            # (HW, 2)
    dst = (src + flow.reshape(-1, H * W, 2)).expand(N, -1, -1)
    idx, sel_valid = masked_sobol_gather(valid_mask, n)       # (N, n)
    g_dst = torch.gather(dst, 1, idx[..., None].expand(-1, -1, 2))
    g_w = None if weights is None else torch.gather(
        weights.reshape(-1, H * W).expand(N, -1), 1, idx)
    return src[idx], g_dst, g_w, sel_valid.to(torch.float32), idx


def _select_tcs_sparse(flow, forward_out, valid_mask, n):
    """``_select_tcs`` with weights computed only at the selected points."""
    H, W = flow.shape[1:3]
    src_g, dst_g, _, sel, idx = _select_tcs(flow, None, valid_mask, n)
    w = _sparse_point_weights(forward_out["weight_head_at"],
                              forward_out["up_mask"], idx, W, H // 8, W // 8)
    return src_g, dst_g, w, sel


def _success_check(tp: TrackerParams, H, pts_a, pts_b, valid):
    """Inlier-fraction redetection check, one a target. pts: (N, n, 2),
    H (N, 3, 3) maps a -> b; valid: (N, n). The sums run per target over
    its own points. Returns (ok (N,) bool, inlier fraction (N,))."""
    errs = proj_errors(H, pts_a.transpose(1, 2), pts_b.transpose(1, 2))
    inliers = (errs <= tp.inlier_px).to(torch.float32) * valid
    frac = inliers.sum(dim=-1) / valid.sum(dim=-1).clamp(min=1.0)
    if tp.redetection == "never":
        ok = torch.zeros_like(frac, dtype=torch.bool)
    elif tp.redetection == "always":
        ok = torch.ones_like(frac, dtype=torch.bool)
    else:
        ok = frac > tp.min_inlier_frac
    return ok & torch.isfinite(H).flatten(1).all(dim=1), frac


def _tc_validity(flow, last_good, frame_hw, use_pw_mask=True):
    """(H*W,) bool: the template pixel's destination under ``flow`` (1, H,
    W, 2) lies in the frame and (``use_pw_mask``) in the region the
    pre-warp by ``last_good`` (3, 3) filled. The pre-warp validity mask is
    a box check on Hinv @ p, so evaluating it at clip(dst_int) equals
    gathering the mask there."""
    H_img, W_img = frame_hw
    dst = (featuremap_coords(frame_hw, flow.device).T
           + flow.reshape(H_img * W_img, 2))
    dst_int = torch.round(dst).long()
    oob = ((dst < 0).any(dim=-1) | (dst_int[:, 0] >= W_img)
           | (dst_int[:, 1] >= H_img))
    if not use_pw_mask:
        return ~oob
    pts = torch.stack([dst_int[:, 0].clamp(0, W_img - 1),
                       dst_int[:, 1].clamp(0, H_img - 1)], dim=-1)
    return ~oob & warp_validity_at(last_good, frame_hw, pts)


def _sparse_ok(raft_cfg: RaftConfig, tp: TrackerParams, flow_fn):
    """Whether a step takes the sparse weight head: the network's own flow
    (no ``flow_fn``) of the 'weighted' variant, ``sparse_weights`` on, and
    unpadded inputs (the reference's gate)."""
    return (flow_fn is None and raft_cfg.variant == "weighted"
            and tp.sparse_weights and tp.padding_mode == "nopad")


def _dense_flow(model, raft_cfg, padding_mode, img1, img2,
                template_feats=None):
    """RAFT on padded inputs, with the dense weight head: (flow (B, H, W,
    2), sigmoided weights (B, H, W, 1), uniform ones under 'orig', and the
    sigmoided visibility mask (B, H, W, 1) under 'weighted_masked', else
    None), at the unpadded size. With ``template_feats`` (encoded from the
    padded template) ``img1`` is not read."""
    padder = make_padder(padding_mode, img2.shape)
    if template_feats is None:
        p1, p2 = padder.pad(img1, img2)
    else:
        p1, (p2,) = None, padder.pad(img2)
    out = weighted_raft_forward(model, raft_cfg, p1, p2,
                                template_feats=template_feats)
    flow = padder.unpad(out["flow_up"])
    weights = (torch.sigmoid(padder.unpad(out["weights_up"]))
               if "weights_up" in out else torch.ones_like(flow[..., :1]))
    vis = (torch.sigmoid(padder.unpad(out["mask_up"]))
           if "mask_up" in out else None)
    return flow, weights, vis


def _flow_seam(res):
    """A flow's result as (flow, weights, vis or None): a ``flow_fn`` may
    return the pair without the visibility mask."""
    return tuple(res) if len(res) == 3 else (*res, None)


def _device_ladder(n_lost, no_prewarp_after_n, last_good_h2init):
    """The pre-warp reset on the device, for one target or a batch:
    (n_lost as an int32 tensor, the last good H, or the identity once the
    target was lost more than ``no_prewarp_after_n`` frames in a row). A
    state made without ``no_local_h`` holds a Python ``0``, copied to the
    card once."""
    dev = last_good_h2init.device
    n_lost = torch.as_tensor(n_lost, dtype=torch.int32, device=dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    reset = (n_lost > no_prewarp_after_n)[..., None, None]
    return n_lost, torch.where(reset, eye, last_good_h2init)


def build_track_step(raft_cfg: RaftConfig, tp: TrackerParams, flow_fn=None):
    """The per-frame step ``(model, state, frame) -> (new_state, H_cur2init,
    meta)``.

    ``frame``: (1, H, W, 3) float RGB in [0, 255]. ``meta``: dict of the
    reference's diagnostics. ``flow_fn(model, img1, img2, template_feats)
    -> (flow (1,H,W,2), weights (1,H,W,1) sigmoided[, vis (1,H,W,1)])``
    replaces the flow network (the tests inject oracle flow here, and
    ``ExternalFlowWrapper.make_flow_fn`` its backend). Without it the main
    flow runs RAFT against the cached template features: WeightedRAFT under
    ``nopad`` with ``sparse_weights`` with the sparse weight head (the
    head and the convex upsample evaluated only at the cells the solver
    consumes), otherwise on the padded frame with the dense head, unpadded
    before the TC selection; the fallback flow always takes the dense head
    on padded inputs. A visibility mask (``weighted_masked``) keeps only
    the TCs where it exceeds 0.5, in the main flow and in the fallback.

    The step branches on the host: when the inlier check fails it runs the
    local fallback flow and adds its H to ``meta`` as ``H_local_cur2init``.
    That key follows the reference's ``host_fallback`` path, the one
    ``woft_tpu``'s ``WOFTTracker`` takes for frames of 400k pixels or more
    (1280x720 among them). With ``tp.no_local_h`` there is no fallback and
    no host sync (with a device estimator; the host fits copy the points
    to the host): ``ok``, ``lost`` and ``n_lost`` stay device tensors (in
    the state and in ``meta``) and the ladder is ``torch.where``, the JAX
    step's ``no_local_h`` branch."""

    def run_flow(model, img1, img2):
        if flow_fn is not None:
            return _flow_seam(flow_fn(model, img1, img2))
        return _dense_flow(model, raft_cfg, tp.padding_mode, img1, img2)

    def local_h(model, prev_img, frame, prev_h2init, template_mask):
        """Local fallback: prev -> current flow chained onto prev_h2init
        (dense weight head: the fallback is off the steady-state path)."""
        hw = frame.shape[1] * frame.shape[2]
        prev_mask = warp_perspective(
            template_mask[None, :, :, None].to(torch.float32),
            inverse_h(prev_h2init), mode="nearest")
        lvalid = prev_mask.reshape(hw) > 0
        lflow, lweights, lvis = run_flow(model, prev_img, frame)
        if lvis is not None:
            lvalid &= lvis.reshape(hw) > 0.5
        lsrc, ldst, lw, lsel, _ = _select_tcs(lflow, lweights, lvalid,
                                              tp.subsample_n)
        H_flow = _estimate_h(tp, ldst, lsrc, lw, lsel)[0]     # cur -> prev
        # H_flow applies first (cur -> prev), then prev_h2init (prev -> init)
        H_local = compose_h(H_flow, prev_h2init)
        return torch.where(torch.isfinite(H_local).all(), H_local,
                           prev_h2init)

    def step(model, state: TrackerState, frame):
        # redetection reset
        if tp.no_local_h:
            n_lost_in, last_good = _device_ladder(
                state.n_lost, tp.no_prewarp_after_n, state.last_good_h2init)
        elif state.n_lost > tp.no_prewarp_after_n:
            last_good = torch.eye(3, dtype=torch.float32, device=frame.device)
        else:
            last_good = state.last_good_h2init
        fits = _flow_fits(model, raft_cfg, tp, flow_fn, state, frame,
                          last_good, use_vis=True)
        # weighted fit: current-prewarped -> template
        H_pw2init, ok, inlier_frac = fits(state.template_mask[None])
        H_global = compose_h(last_good, H_pw2init[0])
        ok, inlier_frac = ok[0], inlier_frac[0]

        if tp.no_local_h:
            n_lost = torch.where(ok, torch.zeros_like(n_lost_in),
                                 n_lost_in + 1)
            new_state = replace(
                state, prev_img=frame, prev_h2init=H_global,
                last_good_h2init=torch.where(ok, H_global, last_good),
                lost=~ok, n_lost=n_lost)
            meta = {"last_good_H2init": last_good,
                    "H_global_cur2init": H_global, "global_H_success": ok,
                    "inlier_frac": inlier_frac, "lost": ~ok,
                    "N_lost": n_lost}
            return new_state, H_global, meta

        ok = bool(ok)                   # host sync: the branch below is Python
        if tp.redetection == "always" or ok:
            H_cur2init = H_global
        else:
            H_cur2init = local_h(model, state.prev_img, frame,
                                 state.prev_h2init, state.template_mask)

        n_lost = 0 if ok else state.n_lost + 1
        new_state = replace(
            state, prev_img=frame, prev_h2init=H_cur2init,
            last_good_h2init=H_cur2init if ok else last_good, lost=not ok,
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


def _flow_fits(model, raft_cfg, tp, flow_fn, state, frame, last_good,
               use_vis=False):
    """The global flow of a frame and the fits it feeds: pre-warp ``frame``
    by ``last_good``, one flow from the template (its cached features) to
    the pre-warped frame, the TC validity. The flow takes the sparse
    weight head where ``_sparse_ok``, else the padded frame and the dense
    head (``_dense_flow``); the pre-warp, the TC validity and the Sobol
    gather stay at the unpadded size. ``use_vis``: a visibility mask of the
    flow ('weighted_masked') joins the TC validity; the shared-flow step
    drops it, as the reference's does.

    Returns ``fits(masks (N, H, W) bool) ->
    (H_pw2init (N, 3, 3), ok (N,), inlier_frac (N,))``, a TC selection,
    Sobol-500 gather, fit and inlier check a target, all N in one batch
    (the host fits loop over the targets); the targets' sparse weight-head
    cells come from the one forward."""
    H_img, W_img = frame.shape[1:3]
    prewarped = warp_perspective_fast(frame, last_good)
    sparse = _sparse_ok(raft_cfg, tp, flow_fn)
    vis = None
    if sparse:
        fo = weighted_raft_forward(model, raft_cfg, None, prewarped,
                                   template_feats=state.template_feats,
                                   sparse_weight_head=True)
        flow = fo["flow_up"]
    elif flow_fn is None:
        flow, weights, vis = _dense_flow(model, raft_cfg, tp.padding_mode,
                                         None, prewarped,
                                         state.template_feats)
    else:
        flow, weights, vis = _flow_seam(flow_fn(
            model, state.template_img, prewarped, state.template_feats))
    in_pw = _tc_validity(flow, last_good, (H_img, W_img), tp.use_pw_mask)
    if use_vis and vis is not None:
        in_pw = in_pw & (vis.reshape(-1) > 0.5)

    def fits(masks):
        valid = masks.reshape(masks.shape[0], -1) & in_pw
        if sparse:
            src_g, dst_g, w_g, sel = _select_tcs_sparse(flow, fo, valid,
                                                        tp.subsample_n)
        else:
            src_g, dst_g, w_g, sel, _ = _select_tcs(flow, weights, valid,
                                                    tp.subsample_n)
        H_pw2init = _estimate_h(tp, dst_g, src_g, w_g, sel)
        ok, frac = _success_check(tp, H_pw2init, dst_g, src_g, sel)
        return H_pw2init, ok, frac

    return fits


def build_shared_multi_step(raft_cfg: RaftConfig, tp: TrackerParams,
                            flow_fn=None):
    """N targets from ONE full-frame flow a frame: the shared-correlation
    twin of ``woft_tpu/tracker/woft.py:build_shared_multi_step``.

    ``(model, state, masks (N, H, W) or (N, H*W) bool, h_last (N, 3, 3),
    frame (1, H, W, 3)) -> (new_state, new_h_last, hs (N, 3, 3), meta)``.
    One full-frame step: the pre-warp by the control target's (target 0's)
    last good H, one WeightedRAFT forward, the sparse weight head evaluated
    at every target's Sobol-500 cells from that forward; then a TC
    selection, weighted fit and inlier check a target, batched over the
    targets, at most ``tp.multi_fit_chunk`` at once (groups beyond it, the
    last padded with all-False masks whose fits are dropped). Each target
    keeps its last good H when its fit fails (``h_last``); target 0
    drives the state's ladder as ``build_track_step`` does. The pre-warp
    stays exact float32 in bf16 mode, where the JAX package relaxes it.

    ``meta``: ``global_H_success`` and ``inlier_frac``, each (N,). No host
    sync with a device estimator (the host fits copy the points to the
    host and fit target by target): the state's ``lost`` and ``n_lost``
    are device tensors. Needs
    ``no_local_h`` or ``redetection='always'`` (no per-target local
    fallback)."""
    if not (tp.no_local_h or tp.redetection == "always"):
        raise ValueError("the shared-flow multi-target step has no "
                         "per-target local fallback: set no_local_h=True or "
                         "redetection='always'")

    @torch.no_grad()
    def step(model, state: TrackerState, masks, h_last, frame):
        n_lost_in, last_good = _device_ladder(
            state.n_lost, tp.no_prewarp_after_n, state.last_good_h2init)
        fits = _flow_fits(model, raft_cfg, tp, flow_fn, state, frame,
                          last_good)
        n_t = masks.shape[0]
        masks = masks.reshape(n_t, -1)
        chunk = tp.multi_fit_chunk or n_t
        if n_t <= chunk:
            h_fit, oks, fracs = fits(masks)
        else:
            groups = -(-n_t // chunk)
            padded = torch.cat([masks, masks.new_zeros(
                (groups * chunk - n_t, masks.shape[1]))])
            h_fit, oks, fracs = (torch.cat(r)[:n_t] for r in zip(
                *(fits(g) for g in padded.split(chunk))))
        h_fit = compose_h(last_good, h_fit)
        # per-target ladder: keep the last good H when a fit fails
        hs = torch.where(oks[:, None, None], h_fit, h_last)
        ok0 = oks[0]
        new_state = replace(
            state, prev_img=frame, prev_h2init=hs[0],
            last_good_h2init=torch.where(ok0, hs[0], last_good), lost=~ok0,
            n_lost=torch.where(ok0, torch.zeros_like(n_lost_in),
                               n_lost_in + 1))
        return new_state, hs, hs, {"global_H_success": oks,
                                   "inlier_frac": fracs}

    return step


def tracker_init_state(model, raft_cfg: RaftConfig, tp: TrackerParams,
                       template_img, template_mask, encode=True):
    """The initial TrackerState. template_img: (1, H, W, 3) float RGB;
    template_mask: (H, W) bool. ``encode=False`` skips the template
    features (oracle-flow tests). Under ``tp.no_local_h`` the lost counters
    are device tensors, so no step copies them to the card."""
    feats = None
    if encode:
        padder = make_padder(tp.padding_mode, template_img.shape)
        (padded,) = padder.pad(template_img)
        feats = encode_template(model, raft_cfg, padded)
    dev = template_img.device
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    lost, n_lost = False, 0
    if tp.no_local_h:
        lost = torch.zeros((), dtype=torch.bool, device=dev)
        n_lost = torch.zeros((), dtype=torch.int32, device=dev)
    return TrackerState(
        template_img=template_img,
        template_feats=feats,
        template_mask=template_mask,
        prev_img=template_img,
        prev_h2init=eye,
        last_good_h2init=eye,
        lost=lost,
        n_lost=n_lost)


class WOFTTracker:
    """Host shell with the reference tracker API: numpy BGR uint8 in, numpy
    float64 H (current -> template) out.

    ``config`` is a Config with ``flow_config`` (a ``RaftFlow`` config),
    ``tracker_params`` (TrackerParams, or falsy for the canonical ones) and
    optionally ``downscale_inputs`` (honoured beside explicit tracker
    params, as in the JAX package). Under ``downscale`` s the shell resizes
    each frame and the mask as ``cv2.resize(INTER_LINEAR)`` does
    (``ops/resize.py``: the frame after its upload, on the device), checks
    the resized mask for one blob, tracks at the small size and returns
    ``diag(s, s, 1) @ H @ diag(1/s, 1/s, 1)``; ``meta`` keeps the small
    size's H. Runs on ``device`` (default ``cuda``; raises without a card).
    ``flow_config.of_class`` picks the flow: ``RaftFlow`` (the default), or
    a wrapper with ``make_flow_fn()`` (``flow/external.py``:
    ``ExternalFlowWrapper``), whose flow the step takes through its
    ``flow_fn`` seam with no template features, as the reference's shell
    does.
    ``raft_flags``: fields of ``RaftConfig`` that no config file carries,
    set on top of the flow config's, e.g. ``{"gru_fused": True,
    "tail_fused": True}`` for the fused refinement loop (the JAX package's
    ``bench.py`` sets its counterparts the same way, outside the configs)."""

    def __init__(self, config, device=None, raft_flags=None):
        self.C = config
        self.device = resolve_device(device)
        of_class = config.flow_config.of_class or RaftFlow
        self.tp = (config.tracker_params
                   if isinstance(config.tracker_params, TrackerParams)
                   else TrackerParams(
                       downscale=int(config.downscale_inputs or 0),
                       padding_mode=str(config.flow_config.padding_mode
                                        or "nopad")))
        if config.downscale_inputs and not self.tp.downscale:
            self.tp = replace(self.tp, downscale=int(config.downscale_inputs))
        self.flower = of_class(config.flow_config, device=self.device)
        self._external = of_class is not RaftFlow
        if self._external:
            # the reference's seam: the wrapper's flow, no template features
            self.raft_cfg = RaftConfig()
            self._step = build_track_step(
                self.raft_cfg, self.tp, flow_fn=self.flower.make_flow_fn())
        else:
            self.raft_cfg = replace(self.flower.cfg, **(raft_flags or {}))
            self._step = build_track_step(self.raft_cfg, self.tp)
        self.state = None

    def init(self, img, mask, img_identifier=None):
        """Start a track on ``img`` with the target ``mask`` (one blob; under
        ``downscale`` a uint8 mask, resized in its own encoding, or a bool
        one, taken as 0/1)."""
        mask = np.asarray(mask)
        if self.tp.downscale:
            mask = resize_down(torch.from_numpy(np.ascontiguousarray(
                mask.astype(np.uint8) if mask.dtype == bool else mask)),
                self.tp.downscale).numpy()
        mask = mask > 0
        _, n_blobs = scipy.ndimage.label(mask, structure=np.ones((3, 3)))
        if n_blobs != 1:
            raise ValueError(f"template mask must be one blob, got {n_blobs}")
        self.state = tracker_init_state(
            self.flower.model, self.raft_cfg, self.tp,
            upload_bgr(img, self.device, self.tp.downscale),
            torch.from_numpy(mask).to(self.device),
            encode=not self._external)

    def track(self, input_img, img_identifier=None):
        """-> (H_cur2init (3, 3) float64, meta namespace)."""
        self.state, H_dev, meta_dev = self._step(
            self.flower.model, self.state,
            upload_bgr(input_img, self.device, self.tp.downscale))
        H = H_dev.cpu().numpy().astype(np.float64)
        meta = SimpleNamespace(**{
            k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in meta_dev.items()})
        meta.estim_H_current2template = H.copy()
        if self.tp.downscale:
            # back to full-resolution pixels: full cur -> small cur -> small
            # init -> full init
            s = float(self.tp.downscale)
            H = np_compose_h(np.diag([1 / s, 1 / s, 1.0]), H,
                             np.diag([s, s, 1.0]))
        return H, meta
