"""Shared-flow multi-target tracking with GMA as the flow network:
``SharedMultiTracker.track_chunk``, a chunk of frames a call, under a
configuration whose ``flow`` states ``gma``.

The client and the program are ``shared.py``'s: a chunk of BGR uint8
frames handed from the host, every target's homography of every frame held
on the host before the next chunk (a closed loop, one stream), the targets
boxes of one plane tracked from one shared flow a frame. The program is
built as a user builds it, the flow network from the configuration's
tracker config file and weights (``RaftFlow``: RAFT-large's trained
weights with GMA's additions drawn from their seed), then
``SharedMultiTracker`` over it, which also hands over every target's fit
points (``keep_tcs``); it is checked against the configuration key by key,
GMA's keys and the additions' values included, initialised on the template
(its attention built once there) and warmed up on the first chunks.

The check is ``shared.py``'s, with the reference network of GMA
(``reference/gma.py``): sampled frames stepped again from the state the
program reported for them, the corner gap of every target, the check
flags, the state chain of every frame. The corner gap of a fit of 500
points moves little with the flow; so, as ``online_alternate.py`` does,
the check also holds each target's fit points to the reference's flow and
weights at the same template pixels: a frame-target's median flow gap
(``flow_gap_median_px``: the median over the sample, ``flow_gap_px``: the
largest) and median weight gap (``weight_gap_median``).
"""

import math
import time
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.entries import online, online_alternate, shared
from benchmark.harness import gma_work
from benchmark.reference import gma as rgma
from benchmark.reference import shared as rshared

FRAMES_PER_CALL = 64        # the cell's traffic: 8 targets x 8 frames


def check_as_run(tracker, model, cfg):
    """``online.check_as_run`` with ``gma`` as ``cfg['flow']`` states it,
    and GMA's widths and additions (``cfg['model']``, ``cfg['assumed']``)
    against the network ``model`` as built."""
    rc, m = tracker.raft_cfg, cfg["model"]
    online._expect("gma", rc.gma, cfg["flow"].get("gma", False))
    plain = SimpleNamespace(raft_cfg=replace(rc, gma=False), tp=tracker.tp,
                            device=tracker.device)
    online.check_as_run(plain, {**cfg, "flow": {
        k: v for k, v in cfg["flow"].items() if k != "gma"}})
    heads, dim = m["gma_heads"], m["gma_dim_head"]
    qk = model.att.to_qk.weight
    agg = model.update_block.aggregator
    gru = model.update_block.gru.convz1.weight
    for key, got, want in (
            ("gma_heads x gma_dim_head", tuple(qk.shape),
             (2 * heads * dim, rc.context_dim, 1, 1)),
            ("to_v", tuple(agg.to_v.weight.shape), (heads * dim, dim, 1, 1)),
            ("gru_input_dim", gru.shape[1] - rc.hidden_dim,
             m["gru_input_dim"]),
            ("gma_attention", "content", m["gma_attention"]),
            ("gamma", float(agg.gamma.detach().float().cpu()[0]),
             float(cfg["assumed"]["gamma"]))):
        online._expect(key, got, want)


class SharedGma(shared.Shared):
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
        self.masks, _ = shared.shared_masks(cell.traffic["targets"],
                                            *traffic.hw)
        t = time.perf_counter()
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
                                          conf.tracker_params, device=device,
                                          keep_tcs=True)
        check_as_run(SimpleNamespace(
            raft_cfg=self.tracker.cfg, tp=self.tracker.tp,
            device=self.tracker.device), flower.model, cfg)
        self.tracker.init(traffic.template, self.masks)
        parts["weights_s"] = time.perf_counter() - t
        self.records = []

    def call(self, k):
        """``shared.Shared.call``'s record, with ``tcs`` (chunk, targets,
        n, 6): every target's fit points (template x, y, pre-warped x, y,
        weight, kept)."""
        hs, meta = self.tracker.track_chunk(
            self.chunks[k % len(self.chunks)])
        self.records.append({
            "k": k, "H": hs.astype(np.float64),
            "ok": np.asarray(meta["global_H_success"], bool),
            "frac": np.asarray(meta["inlier_frac"], np.float64),
            "lg": np.asarray(meta["last_good_H2init"], np.float32),
            "n_lost": np.asarray(meta["N_lost"], np.int64),
            "tcs": np.asarray(meta["tcs"], np.float32)})
        return hs

    def counters(self):
        """The launch counters the metrics confirm their calls by: M's and
        C's."""
        return {name: getattr(self.kernels, name).launches
                for name in ("gma_aggregate", "local_corr_build")}


def build(cell, traffic, device, parts, flow=None):
    """The program for ``cell``; ``flow``: flow-config keys set over the
    configuration's (a control on the program's own path)."""
    return SharedGma(cell, traffic, device, parts, flow)


def frames_flops(cell, traffic_spec, records):
    """Model operations of the recorded calls (``harness/gma_work.py``)."""
    return gma_work.records_flops(cell.config, traffic_spec, records)


def reference_net(cell, device, precision):
    """GMA's plain reference on the configuration's weights: RAFT-large's
    trained tensors and the additions drawn as ``assumed`` states."""
    state = torch.load(str(cell.root / cell.config["weights"]),
                       map_location="cpu", weights_only=True)
    a = cell.config["assumed"]
    state = rgma.graft_state(state, a["gma_seed"], a["gru_new_rows_scale"],
                             a["gamma"])
    return rgma.GmaWeightedRaft(state, cell.config["model"], device,
                                precision)


def _kept_flow(ref):
    """Wrap the reference step's TC selection so that it keeps the flow
    and the weights its fits read (the same for every target): returns
    the dict they land in."""
    kept = {}
    inner = ref.one._tcs

    def _tcs(flow, weights, valid):
        kept.update(flow=flow.reshape(-1, 2), weights=weights.reshape(-1),
                    raw=(flow, weights))
        return inner(flow, weights, valid)
    ref.one._tcs = _tcs
    return kept


def compare(cell, traffic, records, window, seed, device, precision="fp32"):
    """``shared.compare`` with GMA's reference, and each target's fit
    points held to the reference's flow and weights: ``h_gap_px``,
    ``h_gap_median_px``, ``ok_flips``, ``ladder_breaks`` as there;
    ``flow_gap_px`` and ``flow_gap_median_px`` (the largest and the median
    over the sample's frame-targets of their median flow gap, px) and
    ``weight_gap_median``. With ``precision`` other than 'fp32' the
    reference at that precision takes the program's place (a control),
    judged by the float32 reference."""
    tp = cell.config["tracker"]
    n = cell.limits["check"]["frames"]
    frames = shared.by_frame(records)
    chunk = len(records[0]["H"])
    tcs = [t for r in records for t in r["tcs"]]
    in_window = {records[i]["k"] for i in window}
    pos = [p for p, fr in enumerate(frames) if fr["f"] // chunk in in_window]
    summary = [{"ok": bool(frames[p]["ok"].all()),
                "pose": traffic.frame_index(frames[p]["f"])} for p in pos]
    picked = [pos[i] for i in online.sample(summary, n, seed)]
    dev = torch.device(device)
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rgb(bgr):
        return to_dev(bgr[:, :, ::-1].copy()).float()[None]

    masks, corners = shared.shared_masks(len(frames[0]["H"]), *traffic.hw)
    width = traffic.template.shape[1]
    template, tmasks = rgb(traffic.template), to_dev(masks)
    ref = rshared.SharedTracker(reference_net(cell, dev, "fp32"), template,
                                tmasks, tp)
    want_flow = _kept_flow(ref)
    ctl = (None if precision == "fp32" else rshared.SharedTracker(
        reference_net(cell, dev, precision), template, tmasks, tp))
    got_flow = None if ctl is None else _kept_flow(ctl)
    eye = np.eye(3)
    gaps, flow_gaps, weight_gaps, flips = [], [], [], 0
    for p in picked:
        fr = frames[p]
        frame = rgb(traffic.frames[traffic.frame_index(fr["f"])])
        h_last = frames[p - 1]["H"] if p else np.stack([eye] * len(masks))
        lg = to_dev(fr["lg"])
        want = ref.step(frame, lg, h_last)
        want.update(want_flow)
        if ctl is None:
            got_H, got_ok, got_tcs = fr["H"], fr["ok"], tcs[p]
        else:
            got = ctl.step(frame, lg, h_last)
            got_H, got_ok = got["H"], got["ok"]
            got_tcs = _reference_tcs(ctl, got_flow, tmasks, lg, tp)
        for t in range(len(masks)):
            gaps.append(online.corner_gap_px(got_H[t], want["H"][t],
                                             corners[t]))
            flips += bool(got_ok[t]) != bool(want["ok"][t])
            if (got_tcs[t][:, 5] > 0).any():    # a target with points
                fg, wg = online_alternate.point_gaps(got_tcs[t], want, width)
                flow_gaps.append(fg)
                weight_gaps.append(wg)
    return {"h_gap_px": max(gaps),
            "h_gap_median_px": float(np.median(gaps)), "ok_flips": flips,
            "ladder_breaks": shared.ladder_breaks(frames,
                                                  tp["no_prewarp_after_n"]),
            "flow_gap_px": max(flow_gaps),
            "flow_gap_median_px": float(np.median(flow_gaps)),
            "weight_gap_median": float(np.median(weight_gaps)),
            "compared": len(picked)}


def _reference_tcs(ctl, kept, tmasks, lg, tp):
    """A control's fit points for every target, as (N, n, 6) rows of the
    program's layout: its flow's TC selection a target (``kept``: the flow
    and weights of its last step)."""
    one = ctl.one
    flow, weights = kept["raw"]
    in_frame = one._in_frame(flow, lg)
    out = []
    for mask in tmasks:
        src, dst, wt, keep = one._tcs(flow, weights,
                                      mask.reshape(-1) & in_frame)
        out.append(np.concatenate([src, dst, wt[:, None], keep[:, None]], 1))
    return out
