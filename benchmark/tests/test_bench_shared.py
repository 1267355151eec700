"""The shared-flow cell on the CPU at a small size (two targets, chunks of
four 64x96 frames): a whole run is correct, the check catches a broken
program, and the cell's readers on synthetic span records and on a trace
without spans."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import spec
from benchmark.harness import trace as tr

from .test_bench_spans import rec

CELL = "woft_fast-1080p-shared8"
SEED = 2**31 + 17          # a seed above 32 signed bits
TINY = {"entry": "shared", "height": 64, "width": 96,
        "octaves": [[16, 1.0], [4, 0.5]], "poses": 4,
        "schedule": "pingpong",
        "step": {"theta": 0.002, "scale": 0.002, "tx": 0.5, "ty": -0.4,
                 "px": 0.0, "py": 0.0},
        "target_frac": 0.5, "targets": 2, "chunk": 4, "warmup_calls": 1,
        "trace_calls": 2}


@pytest.fixture
def tiny(monkeypatch, two_threads):
    """The cell's traffic file read as the small traffic (the entry takes
    ``targets`` and ``chunk`` from it)."""
    real = spec.load_json

    def load(path):
        out = real(path)
        return dict(TINY) if str(path).endswith("shared8-1080p.json") \
            else out
    monkeypatch.setattr(spec, "load_json", load)


def tiny_run():
    return run.run_cell(CELL, SEED, 0.5, 0, device="cpu", traffic=TINY,
                        log=lambda s: None)


def test_whole_run_is_correct(tiny):
    r = tiny_run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 64
    assert set(r["metrics"]) == {"target_frames_per_s", "frame_ms_p95",
                                 "setup_s"}
    assert set(r["checks"]) == set(
        spec.Cell(CELL).limits["check"]["limits"])
    assert r["device"]["platform"] == "cpu"


def _broken(monkeypatch, fault):
    """Break the program's shared step underneath the tracker."""
    import woft_tpu_torch.pipeline as pipeline

    real = pipeline.build_shared_multi_step

    def build(raft_cfg, tp, flow_fn=None):
        step = real(raft_cfg, tp, flow_fn)

        def broken(model, state, masks, h_last, frame):
            new, new_h, hs, meta = step(model, state, masks, h_last, frame)
            if fault == "state unchanged":
                return state, h_last, hs, meta
            # the answers of the passed checks shifted 5 px where they are
            # produced, kept consistently in the state
            shift = torch.eye(3, dtype=hs.dtype)
            shift[0, 2] = 5.0
            oks = meta["global_H_success"]
            hs = torch.where(oks[:, None, None], shift @ hs, hs)
            new = replace(new, prev_h2init=hs[0],
                          last_good_h2init=torch.where(
                              oks[0], hs[0], new.last_good_h2init))
            return new, hs, hs, meta
        return broken
    monkeypatch.setattr(pipeline, "build_shared_multi_step", build)


@pytest.mark.parametrize("fault", ["state unchanged", "answer altered"])
def test_a_broken_step_is_not_correct(fault, monkeypatch, tiny):
    _broken(monkeypatch, fault)
    r = tiny_run()
    assert not r["correct"]
    c = r["checks"]
    if fault == "state unchanged":
        assert c["ladder_breaks"]["value"] > 0
    else:
        assert c["h_gap_median_px"]["value"] > c["h_gap_median_px"]["limit"]


def test_masks_and_corners():
    from benchmark.entries.shared import shared_masks
    masks, corners = shared_masks(8, 1080, 1920)
    assert masks.shape == (8, 1080, 1920)
    for m, c in zip(masks, corners):
        ys, xs = np.nonzero(m)
        assert (xs.min(), ys.min(), xs.max(), ys.max()) == (
            c[0, 0], c[0, 1], c[2, 0], c[2, 1])
        assert m.sum() == 240 * 270            # an eighth wide, half high
    assert not (masks.sum(0) > 1).any()


# -- the readers ------------------------------------------------------------

def chunk_records(frame, base, steps=2, head=(3.0, 30.0)):
    """One ``woft.chunk`` tree of ``steps`` steps: each a flow holding the
    head's dense lookup (``head[0]``), the validity's ``woft.select``, the
    gather's ``woft.select`` holding the head's evaluation (``head[1]``),
    a fit and a check."""
    out = [rec(base, "woft.chunk", None, frame, 800.0),
           rec(base + 1, "woft.upload", base, frame, 6.0)]
    for s in range(steps):
        b = base + 10 * (s + 1)
        out += [rec(b, "woft.step", base, frame, 95.0),
                rec(b + 1, "woft.flow", b, frame, 50.0),
                rec(b + 2, "woft.weight_head", b + 1, frame, head[0]),
                rec(b + 3, "woft.select", b, frame, 1.0),
                rec(b + 4, "woft.select", b, frame, head[1] + 9.0),
                rec(b + 5, "woft.weight_head", b + 4, frame, head[1]),
                rec(b + 6, "woft.fit", b, frame, 4.0),
                rec(b + 7, "woft.check", b, frame, 1.5)]
    out.append(rec(base + 99, "woft.readback", base, frame, 0.3))
    return out


def cell_readers():
    names = [m["name"] for m in spec.benchmark()["per_layer"]
             if CELL in m.get("workloads", ())]
    return {m["name"]: r for m, r in spec.Cell(CELL).metrics(True)
            if m["name"] in names}


@pytest.fixture
def program(monkeypatch):
    from benchmark.harness import spans
    box = {"records": None}
    monkeypatch.setattr(spans, "recorded", lambda: box["records"])
    return box


def traced_run(kernels=(), counters=None, records=()):
    t = tr.Trace(list(kernels), [], (0.0, 1.6), 2, counters or {})
    cell = spec.Cell(CELL)
    traffic = {"chunk": 2, "height": 1080, "width": 1920}
    return run.Run(trace=t, traffic=traffic, cell=cell,
                   records=list(records), window_s=30.0, peak_flops=989e12,
                   flops=cell.entry.frames_flops(cell, traffic, records))


def test_span_readers_per_tracked_frame(program):
    program["records"] = chunk_records(0, 0) + chunk_records(1, 200)
    r = cell_readers()
    run_ = traced_run()
    # 2 traced calls of 2 frames: 4 tracked frames
    assert r["shared_flow_ms_per_frame"].read(run_) == pytest.approx(50.0)
    assert r["shared_head_ms_per_frame"].read(run_) == pytest.approx(33.0)
    # both selects less the head inside the second, the fit, the check
    assert r["shared_targets_ms_per_frame"].read(run_) == pytest.approx(
        1.0 + 9.0 + 4.0 + 1.5)


def test_span_readers_need_one_chunk_tree_a_call(program):
    r = cell_readers()
    spans_ = ("shared_flow_ms_per_frame", "shared_head_ms_per_frame",
              "shared_targets_ms_per_frame")
    for records in (chunk_records(0, 0),                  # one of two calls
                    chunk_records(0, 0) + chunk_records(1, 200, steps=3),
                    [dict(x, name="woft.track") if x["parent"] is None
                     else x for x in chunk_records(0, 0)
                     + chunk_records(1, 200)]):
        program["records"] = records
        assert all(r[n].read(traced_run()) is None for n in spans_)


def test_readers_without_spans_read_nothing(program):
    """A trace without spans (the parent's program, or spans off): the
    span readers and C's roofline read nothing; the share of the peak
    needs a traced run."""
    r = cell_readers()
    assert set(r) == {"shared_flow_ms_per_frame", "shared_head_ms_per_frame",
                      "shared_targets_ms_per_frame",
                      "shared_local_corr_roofline",
                      "shared_launches_per_frame", "device_idle_share",
                      "step_mfu"}
    for records in (None, []):
        program["records"] = records
        for name in ("shared_flow_ms_per_frame", "shared_head_ms_per_frame",
                     "shared_targets_ms_per_frame",
                     "shared_local_corr_roofline",
                     "shared_launches_per_frame"):
            assert r[name].read(traced_run()) is None
    untraced = traced_run(records=[{"H": np.zeros((2, 8, 3, 3))}])
    untraced.trace = None                     # the run's --trace 0 window
    for name in ("step_mfu", "device_idle_share"):
        assert r[name].read(untraced) is None


def test_roofline_one_launch_a_tracked_frame():
    I = tr.Interval
    r = cell_readers()["shared_local_corr_roofline"]
    four = [I("local_corr_bf16_kernel", 0.1 * i, 0.1 * i + 2e-4)
            for i in range(4)]
    got = r.read(traced_run(four, {"local_corr_build": 4}))
    assert 50.0 < got < 70.0                 # 0.124 ms bound over 0.2 ms
    assert r.read(traced_run(four, {"local_corr_build": 3})) is None
    assert r.read(traced_run(four[:3], {"local_corr_build": 3})) is None


def test_step_mfu_counts_every_target_frame():
    from benchmark.harness import shared_work
    r = cell_readers()["step_mfu"]
    # two calls, of 2 and 1 frames of 8 targets
    recs = [{"H": np.zeros((2, 8, 3, 3))}, {"H": np.zeros((1, 8, 3, 3))}]
    run_ = traced_run(records=recs)
    cfg = spec.Cell(CELL).config
    frame = sum(shared_work.frame_flops(cfg["model"], 1080, 1920, 16)
                .values())
    target = sum(shared_work.target_flops(cfg["model"], 500).values())
    assert 4.1e12 < frame + 8 * target < 4.4e12
    want = 100 * (3 * frame + 24 * target) / 30.0 / 989e12
    assert r.read(run_) == pytest.approx(want)


def test_launches_and_idle_per_tracked_frame():
    """Launch calls (kernels and graphs) over the traced calls' frames: 2
    calls of 2 frames; the idle share from the kernels' union."""
    I = tr.Interval
    r = cell_readers()
    calls = ([I("cudaLaunchKernel", 0.01 * i, 0.01 * i + 1e-5)
              for i in range(30)]
             + [I("cudaGraphLaunch", 0.5 + 0.01 * i, 0.5 + 0.01 * i + 1e-5)
                for i in range(10)]
             + [I("aten::add", 0.2, 0.3), I("cudaLaunchKernel", 1.7, 1.8)])
    run_ = traced_run([I("k", 0.0, 0.4), I("k", 0.2, 1.2)])
    run_.trace.calls = calls
    assert r["shared_launches_per_frame"].read(run_) == pytest.approx(10.0)
    assert r["device_idle_share"].read(run_) == pytest.approx(25.0)
