"""Online single-target tracking on RAFT's volume-free correlation:
``WOFTTracker.track``, one frame a call, under a configuration whose
``flow`` states ``alternate_corr``.

The client, the program and the check are ``online.py``'s: one BGR uint8
frame handed from the host, its homography held on the host before the
next (a closed loop, one stream); the program built from the
configuration's tracker config file and weights, checked against the
configuration key by key (here with ``alternate_corr`` as the
configuration states it), initialised on the template and warmed up on the
first frames of the traffic. The check steps the sampled frames again
with the plain reference on the same correlation
(``reference/alternate.py``), from the state the program reported for
them, with TF32 off and cuDNN's float32 algorithms chosen by timing
(``reference/shared.py:plain_fp32``: at 3840x2160 its heuristics may pick
an algorithm of one small launch a cell), and checks the state chain on
every frame (``ladder_breaks``).

At 3840x2160 the program's float32 fit moves the corners by 0.0003-0.0005
px on its own, more than TF32 in the network moves them, so the corner
gap cannot tell a float32 flow from a TF32 one. The program therefore
hands over the points its global fit took (``WOFTTracker(keep_tcs=
True)``: template pixel, pre-warped destination, weight, kept), and the
check holds them to the reference's flow and weights at the same template
pixels, and refits them in float64 (``reference/tracker.py``'s fit).
"""

import dataclasses
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.entries import online
from benchmark.harness import alternate_work
from benchmark.reference import alternate as ralternate
from benchmark.reference import shared as rshared
from benchmark.reference import tracker as rtracker

FRAMES_PER_CALL = 1


def check_as_run(tracker, cfg):
    """``online.check_as_run`` with ``alternate_corr`` as ``cfg['flow']``
    states it."""
    want = cfg["flow"].get("alternate_corr", False)
    online._expect("alternate_corr", tracker.raft_cfg.alternate_corr, want)
    dense = SimpleNamespace(
        raft_cfg=dataclasses.replace(tracker.raft_cfg, alternate_corr=False),
        tp=tracker.tp, device=tracker.device)
    online.check_as_run(dense, {**cfg, "flow": {
        k: v for k, v in cfg["flow"].items() if k != "alternate_corr"}})


class OnlineAlternate(online.Online):
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
        self.tracker = WOFTTracker(conf, device=device, keep_tcs=True)
        check_as_run(self.tracker, cfg)
        self.tracker.init(traffic.template, traffic.mask)
        parts["weights_s"] = time.perf_counter() - t
        self.records = []

    def call(self, k):
        """Hand the k-th frame; keep what the program answered
        (``online.Online.call``'s record) and the points of its global fit
        (``tcs``: (n, 6) float32 rows of template x, y, pre-warped x, y,
        weight, kept)."""
        H, meta = self.tracker.track(
            self.traffic.frames[self.traffic.frame_index(k)])
        t = meta.tcs
        tcs = torch.cat([t["src"][0], t["dst"][0], t["w"][0, :, None],
                         t["valid"][0, :, None]], 1)
        self.records.append({
            "k": k, "H": H, "ok": bool(meta.global_H_success),
            "frac": float(meta.inlier_frac),
            "lg": np.asarray(meta.last_good_H2init, np.float32),
            "Hg": np.asarray(meta.H_global_cur2init, np.float32),
            "n_lost": int(meta.N_lost), "tcs": tcs.cpu().numpy()})
        return [H]

    def counters(self):
        """The launch counter the roofline confirms its calls by: K's
        (none where the program has no kernel K)."""
        n = getattr(self.kernels, "alt_corr_lookup", None)
        return {} if n is None else {"alt_corr_lookup": n.launches}


def build(cell, traffic, device, parts, flow=None):
    """The program for ``cell``; ``flow``: flow-config keys set over the
    configuration's (a control on the program's own path)."""
    return OnlineAlternate(cell, traffic, device, parts, flow)


def frames_flops(cell, traffic_spec, records):
    """Model operations of the recorded frames
    (``harness/alternate_work.py``)."""
    return alternate_work.frames_flops(cell, traffic_spec, records)


def reference_net(cell, device, precision):
    state = torch.load(str(cell.root / cell.config["weights"]),
                       map_location="cpu", weights_only=True)
    return ralternate.AlternateWeightedRaft(state, cell.config["model"],
                                            device, precision)


class FlowTracker(rtracker.Tracker):
    """``reference/tracker.py``'s step, keeping its global flow: the
    step's dict also holds ``flow`` (H*W, 2) and ``weights`` (H*W,) of the
    pre-warped frame, and ``tcs``, the points its fit took as (n, 6) rows
    of template x, y, pre-warped x, y, weight, kept."""

    def step(self, *args):
        self._kept = None
        out = super().step(*args)
        out.update(self._kept)
        return out

    def _tcs(self, flow, weights, valid):
        got = super()._tcs(flow, weights, valid)
        if self._kept is None:               # the global flow's, not the
            src, dst, wt, keep = got         # fallback's
            self._kept = {"flow": flow.reshape(-1, 2),
                          "weights": weights.reshape(-1),
                          "tcs": np.concatenate(
                              [src, dst, wt[:, None], keep[:, None]], 1)}
        return got


def point_gaps(tcs, ref, width):
    """A fit's points (``tcs`` (n, 6)) against the reference step ``ref``
    at the same template pixels, over the kept points: (median flow gap
    in px, median weight gap)."""
    keep = tcs[:, 5] > 0
    src, dst, w = tcs[keep, :2], tcs[keep, 2:4], tcs[keep, 4]
    idx = (np.rint(src[:, 1]) * width + np.rint(src[:, 0])).astype(np.int64)
    at = torch.from_numpy(idx).to(ref["flow"].device)
    ref_dst = src + ref["flow"][at].double().cpu().numpy()
    ref_w = ref["weights"][at].double().cpu().numpy()
    return (float(np.median(np.linalg.norm(dst - ref_dst, axis=1))),
            float(np.median(np.abs(w - ref_w))))


def refit_gap_px(tcs, last_good, ref, corners):
    """Corner gap between the float64 fit on a fit's points (``tcs``,
    composed with the pre-warp ``last_good``) and the reference step's
    global H: the flow and weights the fit took, without its rounding."""
    keep = tcs[:, 5] > 0
    H = rtracker.fit_homography(tcs[keep, 2:4], tcs[keep, :2],
                                tcs[keep, 4]) @ np.float64(last_good)
    return online.corner_gap_px(H / H[2, 2], ref["H_global"], corners)


def compare(cell, traffic, records, window, seed, device, precision="fp32"):
    """``online.compare`` with the reference on the alternate correlation:
    the largest (``h_gap_px``) and median (``h_gap_median_px``) corner gap
    over the sample, check flags that differ, the state chain's breaks;
    and of the points the global fit took, each frame's median flow gap
    (px) and weight gap against the reference at the same template pixels
    (``flow_gap_px``: the largest over the sample, ``flow_gap_median_px``
    and ``weight_gap_median``: the medians) and the median corner gap of
    their float64 refit (``refit_gap_median_px``). With ``precision``
    other than 'fp32' the reference at that precision takes the
    program's place (a control), judged by the float32 reference."""
    tp = cell.config["tracker"]
    n = cell.limits["check"]["frames"]
    for r in records:
        r["pose"] = traffic.frame_index(r["k"])
    picked = [window[i] for i in online.sample(
        [records[i] for i in window], n, seed)]
    dev = torch.device(device)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rgb(bgr):
        return to_dev(bgr[:, :, ::-1].copy()).float()[None]

    width = traffic.template.shape[1]
    gaps, flow_gaps, weight_gaps, refits, flips = [], [], [], [], 0
    with rshared.plain_fp32():
        template = rgb(traffic.template)
        mask = to_dev(traffic.mask)
        ref = FlowTracker(reference_net(cell, dev, "fp32"), template, mask,
                          tp)
        ctl = (None if precision == "fp32" else FlowTracker(
            reference_net(cell, dev, precision), template, mask, tp))
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
                got_H, got_ok, tcs = r["H"], r["ok"], r["tcs"]
            else:
                got = ctl.step(frame, lg, prev, prev_h)
                got_H, got_ok, tcs = got["H"], got["ok"], got["tcs"]
            gaps.append(online.corner_gap_px(got_H, want["H"],
                                             traffic.corners))
            flips += got_ok != want["ok"]
            fg, wg = point_gaps(tcs, want, width)
            flow_gaps.append(fg)
            weight_gaps.append(wg)
            refits.append(refit_gap_px(tcs, r["lg"], want, traffic.corners))
    return {"h_gap_px": max(gaps),
            "h_gap_median_px": float(np.median(gaps)), "ok_flips": flips,
            "ladder_breaks": online.ladder_breaks(
                records, tp["no_prewarp_after_n"]),
            "flow_gap_px": max(flow_gaps),
            "flow_gap_median_px": float(np.median(flow_gaps)),
            "weight_gap_median": float(np.median(weight_gaps)),
            "refit_gap_median_px": float(np.median(refits)),
            "compared": len(picked)}
