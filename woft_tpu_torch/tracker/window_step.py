"""The search-window tracking step: crop, window-space WOFT, un-crop.

PyTorch twin of ``woft_tpu/tracker/window_step.py``. Each frame the step
picks the search box around the last good estimate, crops it from the full
frame into a window of fixed size (kernel A on the card), runs the
full-frame tracker's pipeline inside the window and maps the fitted window
homography back to the full frame:

- ``h_tmpl_crop`` (static per sequence): template frame -> template window;
- per frame, the search box is the template box projected through
  ``inv(h_last_good)`` with the margin and minimum-size rules
  (ref:pytracking/tracker/WOFT_window.py:37-44), kept inside the frame;
- the inner pipeline sees ``cur window -> template window`` homographies;
  the full-frame H is recovered by conjugation (ref:WOFT_window.py:420-427).

The crop homographies stay float32 on the device, as in the reference.
Where the JAX step chooses the local fallback inside ``lax.cond``, this
step syncs the ``ok`` flag to the host and branches in Python, as the
port's ``build_track_step`` does (one host sync a frame); with
``no_local_h`` it never syncs. ``build_window_batch_step`` steps N targets'
windows at once (the JAX package's ``vmap`` of this step).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..models.raft import RaftConfig, encode_template, weighted_raft_forward
from ..ops.pad import make_padder
from ..ops.sampling import featuremap_coords
from ..ops.warp import (inverse_h, warp_axis_aligned, warp_perspective,
                        warp_perspective_fast, warp_validity_at)
from .woft import (TrackerParams, _dense_flow, _device_ladder, _estimate_h,
                   _select_tcs, _select_tcs_sparse, _sparse_ok,
                   _success_check)


@dataclass(frozen=True)
class WindowParams:
    """Window geometry.

    size: int (square) or (H, W); rectangular windows let the crop match
        the target's aspect (``window_params_for_mask``).
    margin: box margin fraction. min_px: least source box size (ref 8*20).
    square: grow the source box to the window's aspect, so the box ->
        window resample is isotropic."""
    size: "int | tuple" = 256
    margin: float = 0.5
    min_px: float = 160.0
    square: bool = True

    @property
    def shape(self):
        """(H, W) window shape."""
        if isinstance(self.size, tuple):
            return self.size
        return (self.size, self.size)


def window_params_for_mask(mask, size=256, margin=0.5, min_px=160.0,
                           max_aspect=2.5):
    """WindowParams whose rectangular window matches the target's aspect:
    pixel area about size^2, sides multiples of 8, isotropic crops."""
    ys, xs = np.where(_host_mask(mask))
    w = xs.max() - xs.min() + 1.0
    h = ys.max() - ys.min() + 1.0
    aspect = float(np.clip(w / max(h, 1.0), 1.0 / max_aspect, max_aspect))
    ww = int(np.clip(round(size * np.sqrt(aspect) / 8) * 8, 64, 4 * size))
    wh = int(np.clip(round(size * size / ww / 8) * 8, 64, 4 * size))
    return WindowParams(size=(wh, ww), margin=margin, min_px=min_px)


def _host_mask(mask):
    if isinstance(mask, torch.Tensor):
        return mask.cpu().numpy()
    return np.asarray(mask)


def _bbox_to_window_h(x0, y0, w, h, shape):
    """The box (x0, y0, w, h) -> (0, 0, Sw, Sh) homography from tensors of
    one shape S (0-d for one box) -> (*S, 3, 3) (ref:geom_utils.py:142-166).
    """
    Sh, Sw = shape
    sx = Sw / w
    sy = Sh / h
    z = torch.zeros_like(sx)
    o = torch.ones_like(sx)
    return torch.stack([
        torch.stack([sx, z, -sx * x0], dim=-1),
        torch.stack([z, sy, -sy * y0], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def _search_crop_h(h_last_good, tmpl_corners, frame_hw, wp: WindowParams):
    """The search box's crop homography, on the device: the template
    corners projected through inv(h_last_good), padded, kept in the frame.
    h_last_good: (3, 3) and tmpl_corners (4, 2) float32, or a batch of
    targets: (N, 3, 3) and (N, 4, 2) -> (N, 3, 3)."""
    shape = wp.shape
    inv = inverse_h(h_last_good.reshape(-1, 3, 3)).reshape(h_last_good.shape)
    ones = torch.ones_like(tmpl_corners[..., :1])
    proj = torch.cat([tmpl_corners, ones], dim=-1) @ inv.transpose(-1, -2)
    proj = proj[..., :2] / proj[..., 2:3]                      # (..., 4, 2)
    x_min, x_max = proj[..., 0].amin(-1), proj[..., 0].amax(-1)
    y_min, y_max = proj[..., 1].amin(-1), proj[..., 1].amax(-1)
    w = x_max - x_min + 1.0
    h = y_max - y_min + 1.0
    H_img, W_img = frame_hw

    # the reference's order (ref:WOFT_window.py:37-44): margins, intersect
    # with the frame, then the minimum size
    x_min = x_min - wp.margin * w
    x_max = x_max + wp.margin * w
    y_min = y_min - wp.margin * h
    y_max = y_max + wp.margin * h
    x_min_c = x_min.clamp(min=0.0)
    y_min_c = y_min.clamp(min=0.0)
    x_max_c = x_max.clamp(max=W_img - 1.0)
    y_max_c = y_max.clamp(max=H_img - 1.0)
    # keep the unclamped box when the intersection is degenerate (a box
    # fully off the frame); the `bad` rule below then searches everywhere
    use = (x_max_c - x_min_c >= 8.0) & (y_max_c - y_min_c >= 8.0)
    x_min = torch.where(use, x_min_c, x_min)
    x_max = torch.where(use, x_max_c, x_max)
    y_min = torch.where(use, y_min_c, y_min)
    y_max = torch.where(use, y_max_c, y_max)

    # minimum size (ref:Bbox.with_margins_min_size, geom_utils.py:106-119)
    w = x_max - x_min + 1.0
    h = y_max - y_min + 1.0
    missing = torch.maximum((wp.min_px - w).clamp(min=0.0) / (2.0 * w),
                            (wp.min_px - h).clamp(min=0.0) / (2.0 * h))
    x_min = x_min - missing * w
    x_max = x_max + missing * w
    y_min = y_min - missing * h
    y_max = y_max + missing * h
    if wp.square:
        # grow to the window's aspect, then translate back into the frame
        # where it fits
        aspect = shape[1] / shape[0]
        cx = (x_min + x_max) / 2
        cy = (y_min + y_max) / 2
        half_w = torch.maximum(x_max - x_min, aspect * (y_max - y_min)) / 2
        half_h = half_w / aspect
        x_min, x_max = cx - half_w, cx + half_w
        y_min, y_max = cy - half_h, cy + half_h
        dx = ((-x_min).clamp(min=0.0)
              - (x_max - (W_img - 1.0)).clamp(min=0.0))
        dy = ((-y_min).clamp(min=0.0)
              - (y_max - (H_img - 1.0)).clamp(min=0.0))
        dx = torch.where(2 * half_w > W_img, dx / 2, dx)
        dy = torch.where(2 * half_h > H_img, dy / 2, dy)
        x_min, x_max = x_min + dx, x_max + dx
        y_min, y_max = y_min + dy, y_max + dy
    # a degenerate or escaped box: search the whole frame
    bad = ((x_max - x_min < 8.0) | (y_max - y_min < 8.0)
           | (x_max < 0) | (y_max < 0)
           | (x_min > W_img - 1.0) | (y_min > H_img - 1.0)
           | ~torch.isfinite(x_min) | ~torch.isfinite(y_max))
    zero = torch.zeros_like(x_min)
    x_min = torch.where(bad, zero, x_min)
    y_min = torch.where(bad, zero, y_min)
    x_max = torch.where(bad, zero + (W_img - 1.0), x_max)
    y_max = torch.where(bad, zero + (H_img - 1.0), y_max)
    return _bbox_to_window_h(x_min, y_min, x_max - x_min + 1.0,
                             y_max - y_min + 1.0, shape)


def window_init_state(model, raft_cfg: RaftConfig, tp: TrackerParams,
                      wp: WindowParams, frame, mask, encode=True):
    """The initial window-tracker state from the first full frame.

    frame: (1, H, W, 3) float32 RGB on the device; mask: (H, W) bool (numpy
    or tensor). The static template crop homography comes from the mask's
    box on the host, in float64, and is kept on the device in float32.
    ``encode=False`` skips the template features (oracle-flow tests)."""
    Sh, Sw = wp.shape
    dev = frame.device
    mask_np = _host_mask(mask)
    ys, xs = np.where(mask_np)
    x0, x1 = float(xs.min()), float(xs.max())
    y0, y1 = float(ys.min()), float(ys.max())
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    x0 -= wp.margin * w
    y0 -= wp.margin * h
    w *= 1 + 2 * wp.margin
    h *= 1 + 2 * wp.margin
    # intersect with the frame (ref:WOFT_window.py:40): content off the
    # image would waste window resolution
    H_img, W_img = frame.shape[1:3]
    x1, y1 = x0 + w, y0 + h
    x0, y0 = max(x0, 0.0), max(y0, 0.0)
    w = min(x1, W_img - 1.0) - x0
    h = min(y1, H_img - 1.0) - y0
    if wp.square:
        aspect = Sw / Sh
        nw = max(w, aspect * h)
        nh = nw / aspect
        x0 -= (nw - w) / 2
        y0 -= (nh - h) / 2
        w, h = nw, nh
        # translate back into the frame where it fits
        dx = max(-x0, 0.0) - max(x0 + w - (W_img - 1.0), 0.0)
        dy = max(-y0, 0.0) - max(y0 + h - (H_img - 1.0), 0.0)
        x0 += dx / 2 if w > W_img else dx
        y0 += dy / 2 if h > H_img else dy
    h_tmpl_crop = torch.tensor([[Sw / w, 0, -Sw / w * x0],
                                [0, Sh / h, -Sh / h * y0],
                                [0, 0, 1.0]], dtype=torch.float32, device=dev)
    tmpl_corners = torch.tensor([[x0, y0], [x0 + w - 1, y0],
                                 [x0 + w - 1, y0 + h - 1], [x0, y0 + h - 1]],
                                dtype=torch.float32, device=dev)

    tmpl_window = warp_axis_aligned(frame, h_tmpl_crop, out_shape=(Sh, Sw))
    mask_t = torch.from_numpy(mask_np.astype(np.float32)).to(dev)
    mask_window = warp_perspective(mask_t[None, :, :, None], h_tmpl_crop,
                                   out_shape=(Sh, Sw), mode="nearest")
    feats = None
    if encode:
        padder = make_padder(tp.padding_mode, tmpl_window.shape)
        (padded,) = padder.pad(tmpl_window)
        feats = encode_template(model, raft_cfg, padded)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    return {
        "h_tmpl_crop": h_tmpl_crop,
        "tmpl_corners": tmpl_corners,
        "tmpl_window": tmpl_window,
        "tmpl_feats": feats,
        "tmpl_mask_window": mask_window[0, :, :, 0] > 0,
        "prev_window": tmpl_window,
        "h_prev_win2tmplwin": eye,          # prev window -> template window
        "h_prev_crop": h_tmpl_crop,
        "h_last_good": eye,                 # full-frame cur2init
        "h_prev_full": eye,
        "lost": torch.zeros((), dtype=torch.bool, device=dev)
        if tp.no_local_h else False,
        "n_lost": torch.zeros((), dtype=torch.int32, device=dev)
        if tp.no_local_h else 0,
    }


def stack_window_states(states):
    """N per-target states (``window_init_state``, made under
    ``no_local_h``) as one state of (N, ...) tensors, the layout of JAX's
    ``jax.tree.map(jnp.stack, *states)``: the batched step's input."""
    out = {}
    for key, first in states[0].items():
        if first is None:
            out[key] = None
        elif isinstance(first, tuple):
            out[key] = tuple(torch.stack(t) for t in zip(
                *(st[key] for st in states)))
        else:
            out[key] = torch.stack([st[key] for st in states])
    return out


def _normalized(H):
    return H / H[..., 2:3, 2:3]


def _window_flow(raft_cfg, tp, flow_fn):
    """The step's flow ``(model, img1, img2, template_feats=None) ->
    (flow, sigmoided weights)`` where the sparse head is not taken:
    ``flow_fn``, or WeightedRAFT on padded windows with the dense head
    (windows are /8, so ``RAFT`` padding is the identity there and only
    the head changes)."""
    if flow_fn is not None:
        return flow_fn

    def dense(model, img1, img2, template_feats=None):
        return _dense_flow(model, raft_cfg, tp.padding_mode, img1, img2,
                           template_feats)
    return dense


def _window_estimate(model, raft_cfg, tp, wp, flow_fn, st, frame):
    """The window-space estimate of N targets at once, before the ladder.

    st: the targets' state pieces, batched: ``h_last_good`` (N, 3, 3)
    after the reset, ``tmpl_corners`` (N, 4, 2), ``h_tmpl_crop`` (N, 3, 3),
    ``tmpl_window`` (N, Sh, Sw, 3), ``tmpl_feats`` (N, ...) or None,
    ``tmpl_mask_window`` (N, Sh, Sw). frame: (1, H, W, 3) float32. Each
    target's search box is cropped from the one frame (kernel A, one
    launch for all), pre-warped by its prior (one launch), and all N
    windows go through one WeightedRAFT forward (B = N), with the sparse
    weight head where ``_sparse_ok``, else the dense one. Returns (h_full
    (N, 3, 3) cur frame -> init, ok (N,), inlier_frac (N,), window (N, Sh,
    Sw, 3), h_crop (N, 3, 3), h_crop_inv (N, 3, 3))."""
    Sh, Sw = wp.shape
    hw = Sh * Sw
    frame_hw = tuple(frame.shape[1:3])
    h_last_good = st["h_last_good"]
    N = h_last_good.shape[0]
    h_crop = _search_crop_h(h_last_good, st["tmpl_corners"], frame_hw, wp)
    window = warp_axis_aligned(frame, h_crop, out_shape=(Sh, Sw))
    # window-space prior: cur window -> template window
    h_crop_inv = inverse_h(h_crop)
    h_prior = _normalized(st["h_tmpl_crop"] @ (h_last_good @ h_crop_inv))
    prewarped = warp_perspective_fast(window, h_prior)

    sparse = _sparse_ok(tp, flow_fn)
    if sparse:
        fo = weighted_raft_forward(model, raft_cfg, None, prewarped,
                                   template_feats=st["tmpl_feats"],
                                   sparse_weight_head=True)
        wflow = fo["flow_up"]
    else:
        wflow, wweights = _window_flow(raft_cfg, tp, flow_fn)(
            model, st["tmpl_window"], prewarped, st["tmpl_feats"])

    dst = (featuremap_coords((Sh, Sw), frame.device).T
           + wflow.reshape(N, hw, 2))
    dst_int = torch.round(dst).long()
    oob = ((dst < 0).any(dim=-1) | (dst_int[..., 0] >= Sw)
           | (dst_int[..., 1] >= Sh))
    in_pw = ~oob
    if tp.use_pw_mask:
        # pre-warp and in-frame validity evaluated at the destination points
        pts = torch.stack([dst_int[..., 0].clamp(0, Sw - 1),
                           dst_int[..., 1].clamp(0, Sh - 1)], dim=-1)
        in_pw = (in_pw & warp_validity_at(h_prior, (Sh, Sw), pts)
                 & warp_validity_at(h_prior @ h_crop, frame_hw, pts))
    valid = st["tmpl_mask_window"].reshape(N, hw) & in_pw

    if sparse:
        src_g, dst_g, w_g, sel = _select_tcs_sparse(wflow, fo, valid,
                                                    tp.subsample_n)
    else:
        src_g, dst_g, w_g, sel, _ = _select_tcs(wflow, wweights, valid,
                                                tp.subsample_n)
    h_pw2tmpl = _estimate_h(tp, dst_g, src_g, w_g, sel)
    ok, inlier_frac = _success_check(tp, h_pw2tmpl, dst_g, src_g, sel)

    # window-space estimate (cur window -> template window), un-cropped
    # to the full frame (ref:WOFT_window.py:420-427)
    h_win = _normalized(h_pw2tmpl @ h_prior)
    h_full = _normalized(inverse_h(st["h_tmpl_crop"]) @ (h_win @ h_crop))
    return h_full, ok, inlier_frac, window, h_crop, h_crop_inv


def _to_float(frame):
    return frame if frame.dtype == torch.float32 else frame.to(torch.float32)


def build_window_track_step(raft_cfg: RaftConfig, tp: TrackerParams,
                            wp: WindowParams, flow_fn=None):
    """The per-frame step ``(model, state, frame (1, H, W, 3)) -> (state,
    H_cur2init (3, 3), meta)``; ``frame`` float32 or uint8 RGB.

    ``flow_fn(model, img1, img2, template_feats=None) -> (flow (1,Sh,Sw,2),
    weights (1,Sh,Sw,1) sigmoided)`` replaces the network (oracle-flow
    tests). Without it both flows (template features -> pre-warped window,
    and the fallback's previous window -> window) run WeightedRAFT with the
    sparse weight head under ``nopad`` and ``sparse_weights`` (the
    reference's ``sparse_ok`` branch, which its canonical settings take),
    otherwise with the dense head on padded windows.

    With ``tp.no_local_h`` there is no fallback and no host sync: ``ok``,
    ``lost`` and ``n_lost`` stay device tensors and the ladder is
    ``torch.where`` (the state must come from ``window_init_state`` under
    the same parameters)."""
    Sh, Sw = wp.shape
    hw = Sh * Sw
    sparse_ok = _sparse_ok(tp, flow_fn)
    run_flow = _window_flow(raft_cfg, tp, flow_fn)

    def local_branch(model, state, window, h_crop):
        """prev window -> cur window flow chained through the previous
        estimate (ref:YAOF:171-207)."""
        # valid where the previous window saw the template
        prev_mask = warp_perspective(
            state["tmpl_mask_window"][None, :, :, None].to(torch.float32),
            inverse_h(state["h_prev_win2tmplwin"][None]), mode="nearest")
        lvalid = prev_mask.reshape(hw) > 0
        if sparse_ok:
            lfo = weighted_raft_forward(model, raft_cfg, state["prev_window"],
                                        window, sparse_weight_head=True)
            lsrc, ldst, lw, lsel = _select_tcs_sparse(
                lfo["flow_up"], lfo, lvalid, tp.subsample_n)
        else:
            lflow, lweights = run_flow(model, state["prev_window"], window)
            lsrc, ldst, lw, lsel, _ = _select_tcs(lflow, lweights, lvalid,
                                                  tp.subsample_n)
        hf = _estimate_h(tp, ldst, lsrc, lw, lsel)[0]   # cur -> prev window
        # cur frame -> cur window -> prev window -> prev frame -> init
        h_full_l = _normalized(state["h_prev_full"]
                               @ inverse_h(state["h_prev_crop"][None])[0]
                               @ hf @ h_crop)
        return torch.where(torch.isfinite(h_full_l).all(), h_full_l,
                           state["h_prev_full"])

    @torch.no_grad()
    def step(model, state, frame):
        frame = _to_float(frame)
        # pre-warp reset after too many lost frames (ref:YAOF:78-79)
        if tp.no_local_h:
            n_lost_in, h_last_good = _device_ladder(
                state["n_lost"], tp.no_prewarp_after_n, state["h_last_good"])
        elif state["n_lost"] > tp.no_prewarp_after_n:
            h_last_good = torch.eye(3, dtype=torch.float32,
                                    device=frame.device)
        else:
            h_last_good = state["h_last_good"]

        st = {k: state[k][None] for k in ("tmpl_corners", "h_tmpl_crop",
                                          "tmpl_mask_window")}
        st.update(h_last_good=h_last_good[None],
                  tmpl_window=state["tmpl_window"],
                  tmpl_feats=state["tmpl_feats"])
        h_full, ok, inlier_frac, window, h_crop, h_crop_inv = (
            _window_estimate(model, raft_cfg, tp, wp, flow_fn, st, frame))
        h_full, ok, inlier_frac = h_full[0], ok[0], inlier_frac[0]
        h_crop, h_crop_inv = h_crop[0], h_crop_inv[0]

        if tp.no_local_h:
            h_out = h_full
            n_lost = torch.where(ok, torch.zeros_like(n_lost_in),
                                 n_lost_in + 1)
            h_last_good = torch.where(ok, h_out, h_last_good)
            lost = ~ok
        else:
            ok = bool(ok)               # host sync: the branch below is Python
            h_out = h_full if ok else local_branch(model, state, window,
                                                   h_crop)
            n_lost = 0 if ok else state["n_lost"] + 1
            h_last_good = h_out if ok else h_last_good
            lost = not ok
        new_state = dict(
            state,
            prev_window=window,
            h_prev_win2tmplwin=state["h_tmpl_crop"] @ h_out @ h_crop_inv,
            h_prev_crop=h_crop,
            h_last_good=h_last_good,
            h_prev_full=h_out,
            lost=lost,
            n_lost=n_lost)
        meta = {"global_H_success": ok, "inlier_frac": inlier_frac,
                "lost": lost, "N_lost": n_lost, "h_crop": h_crop}
        return new_state, h_out, meta

    return step


def build_window_batch_step(raft_cfg: RaftConfig, tp: TrackerParams,
                            wp: WindowParams, flow_fn=None):
    """N window trackers as one batched step, the counterpart of the JAX
    package's ``jax.vmap`` of the window step (``woft_tpu/pipeline.py``):
    ``(model, states, frame (1, H, W, 3)) -> (states, hs (N, 3, 3), meta
    of (N, ...))``, ``states`` from ``stack_window_states``.

    Each target keeps its own search box, crop, template features and
    ladder; the N search crops are one launch of kernel A from the one
    frame, and all N windows go through one WeightedRAFT forward with
    B = N (the encoders' batch norm runs in ``eval()`` mode, so a batch
    equals N separate calls). No local fallback (``no_local_h`` is
    implied, as in JAX, where ``lax.cond`` under ``vmap`` would run the
    fallback for every target) and no host sync. ``flow_fn`` as for
    ``build_window_track_step``, called with the N windows at once.

    ``corr_impl='local'`` is refused: the block-local volume takes one
    frame pair, and the JAX package does not batch it either (its
    ``bench.py`` pins the one-hot lookup for the batched tracker)."""
    if flow_fn is None and raft_cfg.corr_impl == "local":
        raise ValueError("the batched window step runs the dense "
                         "correlation (corr_impl='dense'): the block-local "
                         "volume takes one frame pair, and woft_tpu's "
                         "batched tracker does not run it either")

    @torch.no_grad()
    def step(model, states, frame):
        frame = _to_float(frame)
        n_lost_in, h_last_good = _device_ladder(
            states["n_lost"], tp.no_prewarp_after_n, states["h_last_good"])
        feats = states["tmpl_feats"]
        st = {k: states[k] for k in ("tmpl_corners", "h_tmpl_crop",
                                     "tmpl_mask_window")}
        st.update(h_last_good=h_last_good,
                  tmpl_window=states["tmpl_window"][:, 0],
                  tmpl_feats=None if feats is None
                  else tuple(f[:, 0] for f in feats))
        h_out, ok, inlier_frac, window, h_crop, h_crop_inv = (
            _window_estimate(model, raft_cfg, tp, wp, flow_fn, st, frame))
        n_lost = torch.where(ok, torch.zeros_like(n_lost_in), n_lost_in + 1)
        new_states = dict(
            states,
            prev_window=window[:, None],
            h_prev_win2tmplwin=states["h_tmpl_crop"] @ h_out @ h_crop_inv,
            h_prev_crop=h_crop,
            h_last_good=torch.where(ok[:, None, None], h_out, h_last_good),
            h_prev_full=h_out,
            lost=~ok,
            n_lost=n_lost)
        meta = {"global_H_success": ok, "inlier_frac": inlier_frac,
                "lost": ~ok, "N_lost": n_lost, "h_crop": h_crop}
        return new_states, h_out, meta

    return step
