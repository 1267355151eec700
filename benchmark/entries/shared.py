"""Shared-flow multi-target tracking: ``SharedMultiTracker.track_chunk``, a
chunk of frames a call.

The client hands the program a chunk of ``chunk`` BGR uint8 frames from the
host and holds every target's homography of every frame on the host before
it hands the next chunk (a closed loop, one stream). The ``targets``
targets are boxes on the one plane (``shared_masks``), tracked from one
shared flow a frame. The program is built as a user builds it: the flow
network from the configuration's tracker config file and weights
(``RaftFlow``), then ``SharedMultiTracker`` over it with that file's
tracker parameters; it is checked against the configuration as it is run,
initialised on the template with the masks and warmed up on the first
chunks of the traffic. ``targets`` and ``chunk`` come from the cell's
traffic file.

The check: frames sampled after the window are stepped again by the
reference (``reference/shared.py``) from the state the program reported
for them (the H the frame was pre-warped by, and each target's H of the
frame before), since a tracker's frame depends on the frames before it.
The state chain itself, which this skips, is checked on every frame
(``ladder_breaks``): the pre-warp follows target 0's ladder, and a target
whose check failed keeps its H of the frame before.
"""

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.entries import online
from benchmark.harness import shared_work
from benchmark.reference import shared as rshared

FRAMES_PER_CALL = 64        # the cell's traffic: 8 targets x 8 frames


def shared_masks(n, h, w):
    """(n, h, w) bool masks and (n, 4, 2) corners (x, y), inclusive: a
    grid of 4 columns and ceil(n / 4) rows, each target the middle half of
    its cell's height and an eighth of the frame's width."""
    rows = max(1, (n + 3) // 4)
    ch = h // rows
    masks = np.zeros((n, h, w), bool)
    corners = np.zeros((n, 4, 2))
    for t in range(n):
        y, x = (t // 4) * ch, (t % 4) * (w // 4)
        y0, y1 = y + ch // 4, y + 3 * ch // 4
        x0, x1 = x + w // 16, x + 3 * w // 16
        masks[t, y0:y1, x0:x1] = True
        corners[t] = [[x0, y0], [x1 - 1, y0], [x1 - 1, y1 - 1],
                      [x0, y1 - 1]]
    return masks, corners


class Shared:
    """The program under test for one cell and one seed's traffic."""

    def __init__(self, cell, traffic, device, parts, flow=None):
        from woft_tpu_torch.config import load_config
        from woft_tpu_torch.flow import RaftFlow
        from woft_tpu_torch.ops import kernels
        from woft_tpu_torch.pipeline import SharedMultiTracker

        cfg = cell.config
        if flow:                    # the program's own lower-precision path
            cfg = {**cfg, "flow": {**cfg["flow"], **flow}}
        self.traffic, self.kernels = traffic, kernels
        self.chunk = cell.traffic["chunk"]
        self.masks, _ = shared_masks(cell.traffic["targets"], *traffic.hw)
        t = time.perf_counter()
        # every distinct chunk of the walk's period, stacked once
        period = math.lcm(len(traffic.order), self.chunk)
        self.chunks = [np.stack([traffic.frames[traffic.frame_index(f)]
                                 for f in range(s, s + self.chunk)])
                       for s in range(0, period, self.chunk)]
        parts["chunks_s"] = time.perf_counter() - t
        t = time.perf_counter()
        conf = load_config(cell.root / cfg["program_config"])
        conf.flow_config.model = cell.root / cfg["weights"]
        for key, value in (flow or {}).items():
            setattr(conf.flow_config, key, value)
        flower = RaftFlow(conf.flow_config, device=device)
        self.tracker = SharedMultiTracker(flower.model, flower.cfg,
                                          conf.tracker_params, device=device)
        online.check_as_run(SimpleNamespace(
            raft_cfg=self.tracker.cfg, tp=self.tracker.tp,
            device=self.tracker.device), cfg)
        self.tracker.init(traffic.template, self.masks)
        parts["weights_s"] = time.perf_counter() - t
        self.records = []

    def call(self, k):
        """Hand the k-th chunk; keep what the program answered, a record a
        call: ``H`` (chunk, targets, 3, 3), ``ok`` and ``frac`` (chunk,
        targets), and the pre-warp's ladder, ``lg`` (chunk, 3, 3) and
        ``n_lost`` (chunk,)."""
        hs, meta = self.tracker.track_chunk(
            self.chunks[k % len(self.chunks)])
        if "last_good_H2init" not in meta:
            raise RuntimeError("the program's shared step reports no "
                               "pre-warp H ('last_good_H2init' in meta), "
                               "which the check follows")
        self.records.append({
            "k": k, "H": hs.astype(np.float64),
            "ok": np.asarray(meta["global_H_success"], bool),
            "frac": np.asarray(meta["inlier_frac"], np.float64),
            "lg": np.asarray(meta["last_good_H2init"], np.float32),
            "n_lost": np.asarray(meta["N_lost"], np.int64)})
        return hs

    def counters(self):
        """The launch counter the volume's roofline confirms its calls by:
        C's."""
        return {"local_corr_build": self.kernels.local_corr_build.launches}

    def close(self):
        self.tracker = None


def build(cell, traffic, device, parts, flow=None):
    """The program for ``cell``; ``flow``: flow-config keys set over the
    configuration's (a control on the program's own path)."""
    return Shared(cell, traffic, device, parts, flow)


def frames_flops(cell, traffic_spec, records):
    """Model operations of the recorded calls (``harness/shared_work.py``:
    a frame's one flow, every target's head rows and fit)."""
    return shared_work.records_flops(cell.config, traffic_spec, records)


def by_frame(records):
    """The calls' frames, in order: dicts of ``f`` (the frame's place in
    the stream), ``H`` (targets, 3, 3), ``ok`` (targets,), ``lg`` and
    ``n_lost``."""
    return [{"f": r["k"] * len(r["H"]) + j, "H": r["H"][j], "ok": r["ok"][j],
             "lg": r["lg"][j], "n_lost": int(r["n_lost"][j])}
            for r in records for j in range(len(r["H"]))]


def ladder_breaks(frames, no_prewarp_after_n):
    """Breaks of the reported state chain over ``frames`` (``by_frame``),
    from the template on: a frame whose pre-warp H or lost counter does
    not follow from target 0's answers before it (its last good H, the
    identity once lost more than ``no_prewarp_after_n`` frames in a row),
    and each target whose check failed but whose H is not its H of the
    frame before."""
    eye = np.eye(3, dtype=np.float32)
    last_good, n_lost = eye, 0
    prev = None
    breaks = 0
    for fr in frames:
        hs = fr["H"].astype(np.float32)
        want_lg = rshared.prewarp_h(last_good, n_lost, no_prewarp_after_n)
        last_good, n_lost = rshared.advance(fr["lg"], n_lost, hs[0],
                                            fr["ok"][0])
        breaks += (not np.array_equal(fr["lg"], want_lg)
                   or fr["n_lost"] != n_lost)
        before = prev if prev is not None else [eye] * len(hs)
        breaks += sum(not ok and not np.array_equal(h, b)
                      for ok, h, b in zip(fr["ok"], hs, before))
        prev = hs
    return breaks


def compare(cell, traffic, records, window, seed, device, precision="fp32"):
    """The numbers the check compares. ``records``: every call the program
    answered, in order; ``window``: the indices of those in the measured
    window. With ``precision`` other than 'fp32' the reference at
    that precision takes the program's place (a control), judged by the
    float32 reference. Over every target of the sampled frames:
    ``h_gap_px`` is the largest corner gap, ``h_gap_median_px`` its
    median, ``ok_flips`` the check flags that differ."""
    tp = cell.config["tracker"]
    n = cell.limits["check"]["frames"]
    frames = by_frame(records)
    in_window = {records[i]["k"] for i in window}
    chunk = len(records[0]["H"])
    pos = [p for p, fr in enumerate(frames) if fr["f"] // chunk in in_window]
    summary = [{"ok": bool(frames[p]["ok"].all()),
                "pose": traffic.frame_index(frames[p]["f"])} for p in pos]
    picked = [pos[i] for i in online.sample(summary, n, seed)]
    dev = torch.device(device)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rgb(bgr):
        return to_dev(bgr[:, :, ::-1].copy()).float()[None]

    masks, corners = shared_masks(len(frames[0]["H"]), *traffic.hw)
    template, tmasks = rgb(traffic.template), to_dev(masks)
    ref = rshared.SharedTracker(online.reference_net(cell, dev, "fp32"),
                                template, tmasks, tp)
    ctl = (None if precision == "fp32" else rshared.SharedTracker(
        online.reference_net(cell, dev, precision), template, tmasks, tp))
    eye = np.eye(3)
    gaps, flips = [], 0
    for p in picked:
        fr = frames[p]
        frame = rgb(traffic.frames[traffic.frame_index(fr["f"])])
        h_last = frames[p - 1]["H"] if p else np.stack([eye] * len(masks))
        lg = to_dev(fr["lg"])
        want = ref.step(frame, lg, h_last)
        if ctl is None:
            got_H, got_ok = fr["H"], fr["ok"]
        else:
            got = ctl.step(frame, lg, h_last)
            got_H, got_ok = got["H"], got["ok"]
        for t in range(len(masks)):
            gaps.append(online.corner_gap_px(got_H[t], want["H"][t],
                                             corners[t]))
            flips += bool(got_ok[t]) != bool(want["ok"][t])
    return {"h_gap_px": max(gaps),
            "h_gap_median_px": float(np.median(gaps)), "ok_flips": flips,
            "ladder_breaks": ladder_breaks(frames,
                                           tp["no_prewarp_after_n"]),
            "compared": len(picked)}
