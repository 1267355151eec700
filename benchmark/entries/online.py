"""Online single-target tracking: ``WOFTTracker.track``, one frame a call.

The client hands the program one BGR uint8 frame from the host and holds
the homography on the host before it hands the next (a closed loop, one
stream). The program is built from the configuration's tracker config
file with the configuration's weights, checked against the configuration
as it is run, initialised on the template and warmed up on the first
frames of the traffic.

The check: the frames sampled after the window are stepped again by the
reference tracker (``reference/tracker.py``) from the state the program
reported for them (the last good homography its pre-warp used, and for a
fallback the previous frame's homography), since a tracker's frame
depends on the frames before it. The state chain itself, which this
skips, is checked on every frame (``ladder_breaks``): each frame's
pre-warp is the last good homography of the frames before it, reset to
the identity after ``no_prewarp_after_n`` lost frames.
"""

import time
from dataclasses import fields

import numpy as np
import torch

from benchmark.harness import work
from benchmark.reference import raft as rraft
from benchmark.reference import tracker as rtracker

FRAMES_PER_CALL = 1


def _expect(what, got, want):
    if got != want:
        raise ValueError(f"the program runs {what} = {got!r}; the "
                         f"configuration states {want!r}")


def check_as_run(tracker, cfg):
    """The program's flow and tracker settings against the configuration
    file, key by key."""
    rc, m = tracker.raft_cfg, cfg["model"]
    for key, want in (("fnet_dim", m["fnet_dim"]),
                      ("hidden_dim", m["hidden_dim"]),
                      ("context_dim", m["context_dim"]),
                      ("corr_levels", m["corr_levels"]),
                      ("radius", m["corr_radius"]), ("iters", m["iters"]),
                      ("weight_head_structure",
                       tuple(tuple(s) for s in m["weight_head_structure"])),
                      ("variant", cfg["flow"]["variant"]),
                      ("corr_impl", cfg["flow"]["corr_impl"]),
                      ("precision", cfg["flow"]["precision"]),
                      ("small", False), ("gru_fused", False),
                      ("tail_fused", False), ("alternate_corr", False)):
        _expect(key, getattr(rc, key), want)
    if cfg["flow"]["corr_impl"] == "local":
        _expect("local_margin", rc.local_margin, cfg["flow"]["local_margin"])
    tp = tracker.tp
    names = {f.name for f in fields(tp)}
    for key, want in cfg["tracker"].items():
        if key not in names:
            raise ValueError(f"the program's tracker has no {key!r}")
        _expect(key, getattr(tp, key), want)
    if tracker.device.type == "cuda":
        _expect("TF32 (matmul, cuDNN)",
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32), (cfg["tf32"],) * 2)


class Online:
    """The program under test for one cell and one seed's traffic."""

    def __init__(self, cell, traffic, device, parts, flow=None):
        from woft_tpu_torch.config import load_config
        from woft_tpu_torch.ops import kernels
        from woft_tpu_torch.tracker import WOFTTracker

        cfg = cell.config
        if flow:                    # the program's own lower-precision path
            cfg = {**cfg, "flow": {**cfg["flow"], **flow}}
        self.traffic, self.kernels = traffic, kernels
        t = time.perf_counter()
        conf = load_config(cell.root / cfg["program_config"])
        conf.flow_config.model = cell.root / cfg["weights"]
        for key, value in (flow or {}).items():
            setattr(conf.flow_config, key, value)
        self.tracker = WOFTTracker(conf, device=device)
        check_as_run(self.tracker, cfg)
        self.tracker.init(traffic.template, traffic.mask)
        parts["weights_s"] = time.perf_counter() - t
        self.records = []

    def call(self, k):
        """Hand the k-th frame; keep what the program answered."""
        H, meta = self.tracker.track(
            self.traffic.frames[self.traffic.frame_index(k)])
        self.records.append({
            "k": k, "H": H, "ok": bool(meta.global_H_success),
            "frac": float(meta.inlier_frac),
            "lg": np.asarray(meta.last_good_H2init, np.float32),
            "Hg": np.asarray(meta.H_global_cur2init, np.float32),
            "n_lost": int(meta.N_lost)})
        return [H]

    def counters(self):
        """The launch counters the rooflines confirm their calls by: B's
        and C's."""
        return {name: getattr(self.kernels, name).launches
                for name in ("corr_pyramid_lookup", "local_corr_build")}

    def close(self):
        self.tracker = None


def build(cell, traffic, device, parts, flow=None):
    """The program for ``cell``; ``flow``: flow-config keys set over the
    configuration's (a control on the program's own path)."""
    return Online(cell, traffic, device, parts, flow)


def frames_flops(cell, traffic_spec, records):
    """Model operations of the recorded frames (``work.frame_flops``; a
    frame whose check failed adds the local fallback)."""
    cfg, m = cell.config, cell.config["model"]
    h, w = traffic_spec["height"], traffic_spec["width"]
    n = cfg["tracker"]["subsample_n"]
    sparse = cfg["tracker"]["sparse_weights"]

    def one(fallback):
        return sum(work.frame_flops(
            m, cfg["flow"]["corr_impl"], h, w,
            cfg["flow"].get("local_margin", 0), n, sparse,
            fallback).values())
    return sum(one(not r["ok"] and cfg["tracker"]["redetection"]
                   == "inliers") for r in records)


def ladder_breaks(records, no_prewarp_after_n):
    """Frames whose reported state does not follow from the frames before
    them: the pre-warp's H is the last good one (the identity once more
    than ``no_prewarp_after_n`` frames were lost in a row), the answer of
    a passed check is its global H, and the lost counter counts."""
    eye = np.eye(3, dtype=np.float32)
    last_good, n_lost, breaks = eye, 0, 0
    for r in records:
        want_lg = eye if n_lost > no_prewarp_after_n else last_good
        want_n = 0 if r["ok"] else n_lost + 1
        H32 = r["H"].astype(np.float32)
        bad = (not np.array_equal(r["lg"], want_lg)
               or r["n_lost"] != want_n
               or (r["ok"] and not np.array_equal(H32, r["Hg"])))
        breaks += bad
        last_good = H32 if r["ok"] else r["lg"]
        n_lost = want_n
    return breaks


def corner_gap_px(Ha, Hb, corners):
    """Largest distance between where two current -> template
    homographies put the target's corners in the current frame."""
    pa = rtracker.project(np.linalg.inv(Ha), corners)
    pb = rtracker.project(np.linalg.inv(Hb), corners)
    return float(np.linalg.norm(pa - pb, axis=1).max())


def sample(records, n, seed):
    """The window's frames to compare: every frame whose check failed,
    the frame at the walk's far end (the largest motion from the
    template), and a draw from the seed, ``n`` in all at most."""
    fails = [i for i, r in enumerate(records) if not r["ok"]]
    chosen = set(fails[:n])
    by_k = sorted(range(len(records)), key=lambda i: -records[i]["pose"])
    if by_k and len(chosen) < n:
        chosen.add(by_k[0])
    rng = np.random.default_rng(seed)
    rest = [i for i in rng.permutation(len(records)) if i not in chosen]
    chosen.update(rest[:max(0, n - len(chosen))])
    return sorted(chosen)


def reference_net(cell, device, precision):
    state = torch.load(str(cell.root / cell.config["weights"]),
                       map_location="cpu", weights_only=True)
    return rraft.WeightedRaft(state, cell.config["model"], device, precision)


def compare(cell, traffic, records, window, seed, device, precision="fp32"):
    """The numbers the check compares. ``records``: every frame the
    program tracked, in order; ``window``: the indices of those in the
    measured window. With ``precision`` other than 'fp32' the reference at
    that precision takes the program's place (a control), judged by the
    float32 reference. ``h_gap_px`` is the largest corner gap over the
    sample, ``h_gap_median_px`` its median."""
    tp = cell.config["tracker"]
    n = cell.limits["check"]["frames"]
    for r in records:
        r["pose"] = traffic.frame_index(r["k"])
    picked = [window[i] for i in sample([records[i] for i in window], n,
                                        seed)]
    dev = torch.device(device)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rgb(bgr):
        return to_dev(bgr[:, :, ::-1].copy()).float()[None]

    template = rgb(traffic.template)
    mask = to_dev(traffic.mask)
    ref = rtracker.Tracker(reference_net(cell, dev, "fp32"), template, mask,
                           tp)
    ctl = (None if precision == "fp32" else rtracker.Tracker(
        reference_net(cell, dev, precision), template, mask, tp))
    gaps, flips = [], 0
    for i in picked:
        r = records[i]
        frame = rgb(traffic.frames[r["pose"]])
        prev = (template if i == 0 else
                rgb(traffic.frames[records[i - 1]["pose"]]))
        prev_h = to_dev(np.eye(3, dtype=np.float32) if i == 0
                        else records[i - 1]["H"].astype(np.float32))
        lg = to_dev(r["lg"])
        want = ref.step(frame, lg, prev, prev_h)
        if ctl is None:
            got_H, got_ok = r["H"], r["ok"]
        else:
            got = ctl.step(frame, lg, prev, prev_h)
            got_H, got_ok = got["H"], got["ok"]
        gaps.append(corner_gap_px(got_H, want["H"], traffic.corners))
        flips += got_ok != want["ok"]
    return {"h_gap_px": max(gaps),
            "h_gap_median_px": float(np.median(gaps)), "ok_flips": flips,
            "ladder_breaks": ladder_breaks(
                records, tp["no_prewarp_after_n"]),
            "compared": len(picked)}
