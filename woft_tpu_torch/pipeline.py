"""Multi-target tracking and the chunk loops that keep the host out of
the frame.

PyTorch twin of ``woft_tpu/pipeline.py``:

- ``build_full_track_chunk``, ``build_multi_track_chunk`` and
  ``build_shared_multi_chunk`` step a chunk of T frames with the
  device-resident steps (``no_local_h``: no host sync in a step with a
  device estimator; the host fits ``cvransac``/``trs`` copy the points to
  the host every frame). Where
  the JAX package runs a ``lax.scan`` in one dispatch, each is a Python
  loop that queues the T frames' launches back to back and stacks the
  outputs into (T, ...) tensors; the host reads them once a chunk.
- ``MultiTargetTracker``: N targets, each with its own search window,
  stepped as one batch (``tracker/window_step.py:build_window_batch_step``:
  one crop launch, one WeightedRAFT forward with B = N).
- ``SharedMultiTracker``: N targets sharing ONE full-frame flow a frame
  (``tracker/woft.py:build_shared_multi_step``).
- ``track_video``: one clip, streamed: a frame source that decodes a jpg
  directory on worker threads (``cv2.imread``, which releases the
  interpreter lock while it decodes; the counterpart of the JAX
  package's ``woft_native.FrameLoader``) ahead of the device, and the
  device-resident window step, whose homographies the host fetches every
  ``sync_every`` frames.

``bgr_u8=True`` takes BGR uint8 frames, flipped and cast on the device.
"""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from .device import resolve_device
from .flow.wrapper import upload_bgr
from .geometry.homography import _cv2
from .models.raft import RaftConfig
from .tracker.window_step import (WindowParams, build_window_batch_step,
                                  build_window_track_step,
                                  stack_window_states, window_init_state)
from .tracker.woft import (TrackerParams, build_shared_multi_step,
                           build_track_step, tracker_init_state)
from .utils.io import GeneralVideoCapture
from .utils.profiling import span


#: the decode path the latest ``_frame_source`` took: 'threaded' (a jpg
#: directory, ``cv2.imread`` on worker threads) or 'cv2' (anything else,
#: through ``GeneralVideoCapture``); tests and ``chip_smoke.py`` check it
LAST_SOURCE = None


def _decode_rgb(path, as_uint8):
    img = _cv2("_frame_source").imread(path)
    if img is None:
        raise OSError(f"cannot decode {path}")
    rgb = img[:, :, ::-1]
    return np.ascontiguousarray(rgb) if as_uint8 else rgb.astype(np.float32)


def _frame_source(video_path, n_threads=4, prefetch=6, as_uint8=False):
    """Yield (H, W, 3) RGB frames (float32, or uint8 with ``as_uint8``).

    A directory of jpgs is decoded on ``n_threads`` worker threads,
    ``prefetch`` frames ahead of the consumer, in order; any other input
    (a video file, a directory of pngs) through ``GeneralVideoCapture``.
    Closing the generator early cancels the decodes not yet started."""
    global LAST_SOURCE
    prefetch = max(1, prefetch)
    path = Path(video_path)
    if path.is_dir():
        jpgs = sorted(str(p) for p in path.iterdir()
                      if p.suffix.lower() in (".jpg", ".jpeg"))
        if jpgs:
            LAST_SOURCE = "threaded"
            pool = ThreadPoolExecutor(max_workers=n_threads)
            try:
                ahead = [pool.submit(_decode_rgb, p, as_uint8)
                         for p in jpgs[:prefetch]]
                for i in range(len(jpgs)):
                    frame = ahead.pop(0).result()
                    if i + prefetch < len(jpgs):
                        ahead.append(pool.submit(
                            _decode_rgb, jpgs[i + prefetch], as_uint8))
                    yield frame
            finally:
                pool.shutdown(wait=True, cancel_futures=True)
            return
    LAST_SOURCE = "cv2"
    cap = GeneralVideoCapture(video_path)
    try:
        while True:
            ok, frame = cap.read()
            if not ok or frame is None:
                return
            rgb = frame[:, :, ::-1]
            yield (np.ascontiguousarray(rgb) if as_uint8
                   else rgb.astype(np.float32))
    finally:
        cap.release()


def track_video(model, raft_cfg: RaftConfig, tp: TrackerParams,
                wp: WindowParams, video_path, mask, *, sync_every=8,
                max_frames=0, uint8_upload=False):
    """Track one clip end to end; returns (T, 3, 3) float64 homographies
    (cur -> first frame; ``hs[0]`` is the identity).

    The device-resident window step (``build_window_track_step``) on the
    model's device, on frames from ``_frame_source``: the host decodes
    ahead while the card tracks, and fetches the accumulated homographies
    every ``sync_every`` frames. Use ``TrackerParams(no_local_h=True)``:
    then no step syncs to the host between fetches. ``uint8_upload``
    uploads the uint8 RGB frames (4x fewer bytes) and casts them on the
    card. ``max_frames`` > 0 stops after that many frames, the first
    included."""
    dev = next(model.parameters()).device
    source = _frame_source(video_path, as_uint8=uint8_upload)
    try:
        first = next(source)
        # init runs once and takes float32
        frame0 = torch.from_numpy(np.asarray(first, np.float32)).to(dev)
        state = window_init_state(model, raft_cfg, tp, wp, frame0[None],
                                  np.asarray(mask) > 0)
        step = build_window_track_step(raft_cfg, tp, wp)

        hs = [np.eye(3)]
        pending = []
        for i, frame in enumerate(source):
            if max_frames and i + 1 >= max_frames:
                break
            device_frame = torch.from_numpy(frame)[None].to(
                dev, non_blocking=True)
            state, h, _meta = step(model, state, device_frame)
            pending.append(h)
            if len(pending) >= sync_every:
                hs.extend(torch.stack(pending).cpu().numpy())
                pending = []
        if pending:
            hs.extend(torch.stack(pending).cpu().numpy())
    finally:
        source.close()
    return np.stack(hs)


def _rgb(frame, bgr_u8):
    """A frame of a chunk as the steps take it: (1, H, W, 3) float32 RGB."""
    return frame.flip(-1).to(torch.float32) if bgr_u8 else frame


def _stack_meta(metas):
    return {k: torch.stack([m[k] for m in metas]) for k in metas[0]}


def build_multi_track_chunk(raft_cfg: RaftConfig, tp: TrackerParams,
                            wp: WindowParams, flow_fn=None, bgr_u8=False):
    """N window trackers over a chunk of frames, never syncing to the host.

    ``(model, states, frames (T, 1, H, W, 3)) -> (states, hs (T, N, 3, 3),
    meta of (T, N, ...))``: the batched window step (``no_local_h`` forced,
    as in JAX) on each frame in turn. ``states``: ``stack_window_states``
    of the targets' ``window_init_state``."""
    tp = replace(tp, no_local_h=True)
    step = build_window_batch_step(raft_cfg, tp, wp, flow_fn=flow_fn)

    def chunk(model, states, frames):
        hs, metas = [], []
        for f in frames:
            states, h, meta = step(model, states, _rgb(f, bgr_u8))
            hs.append(h)
            metas.append(meta)
        return states, torch.stack(hs), _stack_meta(metas)

    return chunk


def build_full_track_chunk(raft_cfg: RaftConfig, tp: TrackerParams,
                           flow_fn=None, bgr_u8=False):
    """The full-frame tracker over a chunk of frames, never syncing to the
    host: ``(model, state, frames (T, 1, H, W, 3)) -> (state, hs (T, 3, 3),
    meta of (T, ...))``. ``no_local_h`` is forced (a chunk has no host
    branch for the fallback); ``state`` from ``tracker_init_state`` under
    the same parameters."""
    tp = replace(tp, no_local_h=True)
    step = build_track_step(raft_cfg, tp, flow_fn=flow_fn)

    def chunk(model, state, frames):
        hs, metas = [], []
        for f in frames:
            state, h, meta = step(model, state, _rgb(f, bgr_u8))
            hs.append(h)
            metas.append(meta)
        return state, torch.stack(hs), _stack_meta(metas)

    return chunk


def build_shared_multi_chunk(raft_cfg: RaftConfig, tp: TrackerParams,
                             flow_fn=None, bgr_u8=False, keep_tcs=False):
    """The shared-flow multi-target step over a chunk of frames, never
    syncing to the host: ``(model, state, masks (N, H*W), h_last (N, 3,
    3), frames (T, 1, H, W, 3)) -> (state, h_last, hs (T, N, 3, 3), meta
    of (T, ...))``; ``no_local_h`` forced. Each frame's step runs inside
    the span ``woft.step``."""
    tp = replace(tp, no_local_h=True)
    step = build_shared_multi_step(raft_cfg, tp, flow_fn=flow_fn,
                                   **_kept(keep_tcs))

    def chunk(model, state, masks, h_last, frames):
        hs, metas = [], []
        for f in frames:
            with span("woft.step", f.device):
                state, h_last, h, meta = step(model, state, masks, h_last,
                                              _rgb(f, bgr_u8))
            hs.append(h)
            metas.append(meta)
        return state, h_last, torch.stack(hs), _stack_meta(metas)

    return chunk


def _kept(keep_tcs):
    """The step builder's ``keep_tcs`` argument, passed only when set (a
    step built without it takes the builder's signature as it was)."""
    return {"keep_tcs": True} if keep_tcs else {}


def _upload_chunk(frames_bgr, device):
    """(T, H, W, 3) BGR uint8 -> (T, 1, H, W, 3) uint8 on ``device``."""
    frames = np.ascontiguousarray(np.asarray(frames_bgr, np.uint8))
    return torch.from_numpy(frames).to(device)[:, None]


def _host(hs, meta):
    return hs.cpu().numpy(), {k: v.cpu().numpy() for k, v in meta.items()}


class MultiTargetTracker:
    """Track N targets (masks in one template frame) as one batched step:
    each keeps its own search window, template features and ladder; the
    lost targets re-detect through the pre-warp reset (``no_local_h``).

    ``model``: a ``WeightedRAFT`` (moved to ``device``, default ``cuda``,
    and put in ``eval()`` mode: a batch equals separate calls only there).
    ``raft_cfg.corr_impl`` must be 'dense'."""

    def __init__(self, model, raft_cfg: RaftConfig, tp: TrackerParams,
                 wp: WindowParams, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = raft_cfg
        self.tp = replace(tp, no_local_h=True)
        self.wp = wp
        self._step = build_window_batch_step(self.cfg, self.tp, wp)
        self._chunk_step = None
        self.states = None

    def init(self, frame_bgr, masks):
        """frame_bgr: (H, W, 3) uint8; masks: (N, H, W) bool/uint8."""
        frame = upload_bgr(frame_bgr, self.device)
        self.states = stack_window_states([
            window_init_state(self.model, self.cfg, self.tp, self.wp, frame,
                              np.asarray(m) > 0) for m in masks])

    def track(self, frame_bgr):
        """-> ((N, 3, 3) homographies, meta dict of (N,) diagnostics)."""
        self.states, hs, meta = self._step(
            self.model, self.states, upload_bgr(frame_bgr, self.device))
        return _host(hs, meta)

    def track_chunk(self, frames_bgr):
        """Track a chunk of frames with one host read at its end.

        ``frames_bgr``: (T, H, W, 3) uint8 BGR. Returns ((T, N, 3, 3)
        homographies, meta dict of (T, N, ...) diagnostics). Uploads uint8
        and converts on the device."""
        if self._chunk_step is None:
            self._chunk_step = build_multi_track_chunk(
                self.cfg, self.tp, self.wp, bgr_u8=True)
        self.states, hs, meta = self._chunk_step(
            self.model, self.states, _upload_chunk(frames_bgr, self.device))
        return _host(hs, meta)


class SharedMultiTracker:
    """Track N targets in one video with ONE shared full-frame flow a frame
    (``build_shared_multi_step``): WeightedRAFT runs once a frame and every
    target adds a TC selection and weighted fit over its own mask, batched
    (grouped beyond ``TrackerParams.multi_fit_chunk``). The pre-warp and
    its ladder follow target 0; each target keeps its own last good H.

    ``model``: a ``WeightedRAFT`` (moved to ``device``, default ``cuda``).
    ``flow_fn`` replaces the network as in ``build_track_step``.
    ``keep_tcs``: the meta of ``track`` and ``track_chunk`` also holds
    every target's fit points (``tcs``, ``build_shared_multi_step``)."""

    def __init__(self, model, raft_cfg: RaftConfig, tp: TrackerParams,
                 flow_fn=None, device=None, keep_tcs=False):
        self.device = resolve_device(device)
        self.model = None if model is None else model.to(self.device).eval()
        self.cfg = raft_cfg
        self.tp = replace(tp, no_local_h=True)
        self._flow_fn = flow_fn
        self._keep_tcs = keep_tcs
        self._step = build_shared_multi_step(self.cfg, self.tp,
                                             flow_fn=flow_fn,
                                             **_kept(keep_tcs))
        self._chunk_step = None
        self.state = None
        self.masks = None
        self.h_last = None

    def init(self, frame_bgr, masks):
        """frame_bgr: (H, W, 3) uint8 BGR; masks: (N, H, W) bool/uint8."""
        masks = torch.from_numpy(np.asarray(masks) > 0).to(self.device)
        n = masks.shape[0]
        # the template features serve the network path only
        self.state = tracker_init_state(
            self.model, self.cfg, self.tp, upload_bgr(frame_bgr, self.device),
            masks[0], encode=self._flow_fn is None)
        self.masks = masks.reshape(n, -1)
        self.h_last = torch.eye(3, dtype=torch.float32,
                                device=self.device).repeat(n, 1, 1)

    def track(self, frame_bgr):
        """-> ((N, 3, 3) homographies, meta dict of the step's diagnostics:
        (N,) a target, and the control target's ladder). The call runs
        inside the span ``woft.track``, its stages inside ``woft.upload``,
        ``woft.step`` and ``woft.readback``."""
        with span("woft.track", self.device):
            with span("woft.upload", self.device):
                frame = upload_bgr(frame_bgr, self.device)
            with span("woft.step", self.device):
                self.state, self.h_last, hs, meta = self._step(
                    self.model, self.state, self.masks, self.h_last, frame)
            with span("woft.readback", self.device):
                return _host(hs, meta)

    def track_chunk(self, frames_bgr):
        """Track T frames with one host read at the end: ``frames_bgr``
        (T, H, W, 3) uint8 BGR -> ((T, N, 3, 3) homographies, meta dict of
        (T, ...) diagnostics). Uploads uint8 and converts on the device.
        The call runs inside the span ``woft.chunk`` (not ``woft.track``:
        one tree holds T steps), the upload and the read inside
        ``woft.upload`` and ``woft.readback``, each frame inside
        ``woft.step``."""
        if self._chunk_step is None:
            self._chunk_step = build_shared_multi_chunk(
                self.cfg, self.tp, flow_fn=self._flow_fn, bgr_u8=True,
                keep_tcs=self._keep_tcs)
        with span("woft.chunk", self.device):
            with span("woft.upload", self.device):
                frames = _upload_chunk(frames_bgr, self.device)
            self.state, self.h_last, hs, meta = self._chunk_step(
                self.model, self.state, self.masks, self.h_last, frames)
            with span("woft.readback", self.device):
                return _host(hs, meta)
