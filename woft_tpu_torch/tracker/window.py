"""The search-window WOFT tracker: crops of a fixed size, any frame size.

PyTorch twin of ``woft_tpu/tracker/window.py`` (after
ref:pytracking/tracker/WOFT_window.py). The reference crops the template
and the current frame to a margin-padded target box at native scale; here
the search region is warped into a window of fixed shape by a box -> window
homography (kernel A on the card), and the full-frame tracker's step runs
inside the window:

- the per-frame cost does not depend on the frame's resolution;
- the window homography is un-cropped exactly by conjugating with the crop
  transforms (ref:WOFT_window.py:420-427 'H_undo_crop');
- the search box follows the last good estimate with the reference's
  margin and minimum-size rules (ref:WOFT_window.py:37-44).

The shell picks the crop homographies on the host in float64 numpy, as the
reference does; the device step (``tracker/woft.py:build_track_step``) runs
at the window's shape.
"""

from types import SimpleNamespace

import numpy as np
import torch

from ..device import resolve_device
from ..flow.wrapper import RaftFlow, upload_bgr
from ..geometry.bbox import Bbox, h_bbox2bbox, project_bbox
from ..geometry.homography import np_compose_h
from ..ops.warp import warp_axis_aligned, warp_perspective
from .woft import (TrackerParams, TrackerState, build_track_step,
                   tracker_init_state)


def _shift_into(box, frame_box):
    """Translate ``box`` to lie inside ``frame_box`` where it fits (half
    the shift when it is larger than the frame), so aspect-grown search
    regions stay on the image without being distorted again."""
    dx = max(0.0, frame_box.tl_x - box.tl_x) \
        - max(0.0, box.br_x - frame_box.br_x)
    dy = max(0.0, frame_box.tl_y - box.tl_y) \
        - max(0.0, box.br_y - frame_box.br_y)
    if box.w > frame_box.w:
        dx /= 2
    if box.h > frame_box.h:
        dy /= 2
    return Bbox.from_xywh((box.tl_x + dx, box.tl_y + dy, box.w, box.h))


def warp_mask_nearest(mask, H, out_hw):
    """``cv2.warpPerspective(uint8(mask), H, (w, h), INTER_NEAREST) > 0``
    through the port's float32 ``warp_perspective(mode='nearest')`` on the
    CPU: a source coordinate at an exact half-pixel tie rounds up here
    (``floor(x + 0.5)``), to even in OpenCV. mask: (H, W) numpy; H: (3, 3)
    float64 numpy. Returns (out_h, out_w) bool numpy."""
    src = torch.from_numpy(np.asarray(mask > 0, np.float32))[None, :, :, None]
    out = warp_perspective(src, torch.tensor(H, dtype=torch.float32),
                           out_shape=out_hw, mode="nearest")
    return out[0, :, :, 0].numpy() > 0


class WOFTWindowTracker:
    """Search-window WOFT tracker with the reference's init/track API:
    numpy BGR uint8 in, numpy float64 H (current -> template) out.

    Config keys besides the full-frame tracker's: ``window_size`` (default
    256), ``window_margin`` (box margin fraction, default 0.5),
    ``min_window_px`` (least source box side, default 160, the reference's
    8*20), ``window_aniso_crop`` (a fixed square window fed by
    anisotropically squeezed crops; by default the window takes the
    template box's aspect at init, area about window_size^2, sides
    multiples of 8).

    ``window_native_scale = True`` switches to native-resolution crops
    (ref:WOFT_window.py:37-44 fixes a native-scale search box a sequence):
    the window's sides follow the margin-padded template box, snapped up to
    ``window_snap_px`` and capped at ``window_max_px`` (both multiples of
    8, the RAFT feature stride), so the crop scale is one isotropic
    constant, exactly 1 when the native region fits the cap. The search
    region keeps that source size, re-centred on the current estimate.

    Runs on ``device`` (default ``cuda``; raises without a card)."""

    def __init__(self, config, device=None):
        self.C = config
        self.device = resolve_device(device)
        of_class = config.flow_config.of_class or RaftFlow
        if of_class is not RaftFlow:
            raise NotImplementedError(f"flow wrapper {of_class} is not ported")
        self.S = int(config.window_size or 256)
        self.margin = float(config.window_margin or 0.5)
        self.min_px = int(config.min_window_px or 160)
        self.native_scale = bool(config.window_native_scale)
        self.max_px = int(config.window_max_px or 2 * self.S)
        self.snap_px = int(config.window_snap_px or 32)
        if self.snap_px % 8:
            raise ValueError("window_snap_px must be a multiple of 8 "
                             "(RAFT feature stride)")
        if self.max_px % 8:
            # the reference does not check it (woft_tpu/tracker/window.py:78)
            # and then builds windows RAFT cannot take
            raise ValueError("window_max_px must be a multiple of 8 "
                             "(RAFT feature stride)")
        self.iso_crop = not bool(config.window_aniso_crop)
        self.win_hw = (self.S, self.S)      # chosen per sequence in init()
        self.tp = (config.tracker_params
                   if isinstance(config.tracker_params, TrackerParams)
                   else TrackerParams())
        self.flower = RaftFlow(config.flow_config, device=self.device)
        self._step = build_track_step(self.flower.cfg, self.tp)
        self.state = None

    # ------------------------------------------------------------------

    def _crop(self, img_bgr, h_crop):
        """Warp a full BGR frame into the window (kernel A on the card)."""
        return warp_axis_aligned(
            upload_bgr(img_bgr, self.device),
            torch.tensor(h_crop, dtype=torch.float32, device=self.device),
            out_shape=self.win_hw)

    def _search_bbox(self, h_init2cur, frame_shape):
        """The template box projected into the current frame and padded, in
        the reference's order (ref:WOFT_window.py:37-44): margins,
        intersection with the frame, minimum size; the aspect growth is
        shifted back into the frame where it fits."""
        box = project_bbox(self.template_bbox, h_init2cur)
        frame_box = Bbox.from_xywh((0, 0, frame_shape[1], frame_shape[0]))
        if self.native_scale:
            # the fixed native-scale source size, re-centred on the current
            # estimate; the template box already carries the margins
            inter = box.intersection(frame_box)
            if inter.w < 8 or inter.h < 8:   # lost far outside
                return frame_box
            cx, cy = box.get_center()
            sw, sh = self._src_wh
            return _shift_into(
                Bbox.from_xywh((cx - sw / 2, cy - sh / 2, sw, sh)),
                frame_box)
        box = box.with_margins(self.margin)
        inter = box.intersection(frame_box)
        if inter.w < 8 or inter.h < 8:   # lost far outside: search everywhere
            return frame_box
        box = inter.with_margins_min_size(self.min_px)
        if self.iso_crop:
            box = box.with_aspect(self.win_hw[1] / self.win_hw[0])
            box = _shift_into(box, frame_box)
        return box

    # ------------------------------------------------------------------

    def init(self, img, mask, img_identifier=None):
        """Start a track on ``img`` (BGR uint8) with the target ``mask``."""
        frame_box = Bbox.from_xywh((0, 0, img.shape[1], img.shape[0]))
        self.template_bbox = Bbox.from_mask(mask > 0).with_margins(self.margin)
        self.template_bbox = self.template_bbox.intersection(frame_box)
        if self.native_scale:
            # static window sides at the native crop scale; snapping grows
            # the source region (ceil), and the source box is derived back
            # from the snapped sides, so the scale s stays exact
            box = self.template_bbox.with_margins_min_size(self.min_px)
            s = min(1.0, self.max_px / max(box.w, box.h))
            snap = self.snap_px
            ww = int(np.clip(np.ceil(box.w * s / snap) * snap, 64,
                             self.max_px))
            wh = int(np.clip(np.ceil(box.h * s / snap) * snap, 64,
                             self.max_px))
            self.win_hw = (wh, ww)
            self._src_wh = (ww / s, wh / s)
            cx, cy = box.get_center()
            self.template_bbox = _shift_into(
                Bbox.from_xywh((cx - self._src_wh[0] / 2,
                                cy - self._src_wh[1] / 2,
                                self._src_wh[0], self._src_wh[1])),
                frame_box)
        elif self.iso_crop:
            # a window of the template's aspect: area window_size^2, sides
            # multiples of 8, aspect clipped
            aspect = np.clip(self.template_bbox.w
                             / max(self.template_bbox.h, 1.0), 0.4, 2.5)
            ww = int(np.clip(round(self.S * np.sqrt(aspect) / 8) * 8, 64,
                             4 * self.S))
            wh = int(np.clip(round(self.S * self.S / ww / 8) * 8, 64,
                             4 * self.S))
            self.win_hw = (wh, ww)
            self.template_bbox = _shift_into(
                self.template_bbox.with_aspect(ww / wh), frame_box)
        self.h_tmpl_crop = h_bbox2bbox(
            self.template_bbox,
            Bbox.from_xywh((0, 0, self.win_hw[1], self.win_hw[0])))

        tmpl_window = self._crop(img, self.h_tmpl_crop)
        mask_window = warp_mask_nearest(mask, self.h_tmpl_crop, self.win_hw)
        self.state = tracker_init_state(
            self.flower.model, self.flower.cfg, self.tp, tmpl_window,
            torch.from_numpy(mask_window).to(self.device))
        self.h_cur2init = np.eye(3)
        self.h_last_good = np.eye(3)
        self.h_prev = np.eye(3)
        self._prev_crop = self.h_tmpl_crop

    def _to_window(self, h_full, h_crop):
        """A full-frame cur2init H in window coordinates: cur window ->
        full cur -> full init -> template window."""
        return np_compose_h(np.linalg.inv(h_crop), h_full, self.h_tmpl_crop)

    def _window_h(self, h_full, h_crop):
        return torch.tensor(self._to_window(h_full, h_crop),
                            dtype=torch.float32, device=self.device)

    def track(self, input_img, debug=False, img_identifier=None):
        """-> (H_cur2init (3, 3) float64, meta namespace). ``debug`` is
        accepted and draws nothing, as in the JAX package's window shell."""
        search = self._search_bbox(np.linalg.inv(self.h_last_good),
                                   input_img.shape)
        h_cur_crop = h_bbox2bbox(
            search, Bbox.from_xywh((0, 0, self.win_hw[1], self.win_hw[0])))
        cur_window = self._crop(input_img, h_cur_crop)

        # the crop changes every frame, so the inner state's homography
        # history is re-expressed in the new window's coordinates
        s = self.state
        self.state = TrackerState(
            template_img=s.template_img,
            template_feats=s.template_feats,
            template_mask=s.template_mask,
            prev_img=s.prev_img,
            prev_h2init=self._window_h(self.h_prev, self._prev_crop),
            last_good_h2init=self._window_h(self.h_last_good, h_cur_crop),
            lost=s.lost,
            n_lost=s.n_lost)
        self.state, h_win, meta_dev = self._step(self.flower.model,
                                                 self.state, cur_window)
        h_win = h_win.cpu().numpy().astype(np.float64)

        # un-crop (ref:WOFT_window.py:420-427): the window H maps cur window
        # -> template window; conjugate with the crop transforms
        h_cur2init = np_compose_h(h_cur_crop, h_win,
                                  np.linalg.inv(self.h_tmpl_crop))
        meta = SimpleNamespace(**{
            k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in meta_dev.items()})
        ok = bool(meta.global_H_success)
        self.h_cur2init = h_cur2init
        self.h_prev = h_cur2init
        self._prev_crop = h_cur_crop
        if ok:
            self.h_last_good = h_cur2init
        elif int(meta.N_lost) > self.tp.no_prewarp_after_n:
            self.h_last_good = np.eye(3)       # full-frame redetection

        meta.estim_H_current2template = h_cur2init.copy()
        meta.search_bbox = search.as_xywh()
        return h_cur2init, meta
