"""The span readers on synthetic traces and span records."""

import pytest

from benchmark.harness import spans
from benchmark.harness import trace as tr
from benchmark.run import Run

I = tr.Interval


def rec(id_, name, parent, frame, ms):
    return {"id": id_, "name": name, "parent": parent, "frame": frame,
            "host_start_ns": 0, "host_end_ns": 1, "device_ms": ms}


def frame_records(frame, base, refine=(30.0,), head=4.0, fit=0.1):
    """One ``woft.track`` tree: the shell, the step, a ``woft.flow`` with
    its ``woft.flow.refine`` a value of ``refine``, the weight head under
    the gather's ``woft.select``, one fit."""
    out = [rec(base, "woft.track", None, frame, 56.0),
           rec(base + 1, "woft.upload", base, frame, 0.5),
           rec(base + 2, "woft.step", base, frame, 55.0),
           rec(base + 3, "woft.select", base + 2, frame, 4.5),
           rec(base + 4, "woft.weight_head", base + 3, frame, head),
           rec(base + 5, "woft.fit", base + 2, frame, fit)]
    for i, ms in enumerate(refine):
        out += [rec(base + 10 + 2 * i, "woft.flow", base + 2, frame, 45.0),
                rec(base + 11 + 2 * i, "woft.flow.refine", base + 10 + 2 * i,
                    frame, ms)]
    return out


def two_frames():
    """Two traced frames on the profiler's clock (seconds): each
    ``woft.track`` holds an upload, a step and a readback; device idle
    gaps fall in the upload (shell), in the step's wait (step), and
    between the frames (client)."""
    calls = []
    for f, t0 in enumerate((0.0, 10.0)):
        calls += [I("woft.track", t0, t0 + 9), I("woft.upload", t0, t0 + 1),
                  I("cudaMemcpyAsync", t0 + 0.2, t0 + 0.8),
                  I("woft.step", t0 + 1, t0 + 8),
                  I("woft.wait", t0 + 7, t0 + 8),
                  I("woft.readback", t0 + 8, t0 + 9)]
    kernels = [I("k", 0.9, 7.0), I("memcpy", 8.0, 8.5),
               I("k", 10.9, 17.0), I("memcpy", 18.0, 18.5)]
    # gaps: [0, 0.9) upload; [7, 8) wait; [8.5, 10.9): its middle 9.7 is
    # between the frames; [17, 18) wait; [18.5, 19.4) readback
    t = tr.Trace(kernels, calls, (0.0, 19.4), 2)
    records = frame_records(0, 0) + frame_records(1, 100, refine=(28, 6),
                                                  head=5.0, fit=0.3)
    return t, records


@pytest.fixture
def program(monkeypatch):
    """Replace the program's recorder by a list the test sets."""
    box = {"records": None}
    monkeypatch.setattr(spans, "recorded", lambda: box["records"])
    return box


def readers():
    from benchmark.harness import spec
    return {m["name"]: r for m, r in spec.Cell("woft-720p-online")
            .metrics(True)}


NEW = ("refine_ms_per_frame", "weight_head_ms_per_frame",
       "fit_stage_ms_per_frame", "shell_idle_ms_per_frame")


def test_stage_device_ms_a_traced_frame(program):
    t, program["records"] = two_frames()
    r = readers()
    run = Run(trace=t)
    # refine summed over the second frame's two flows, then over frames
    assert r["refine_ms_per_frame"].read(run) == pytest.approx(
        (30 + 28 + 6) / 2)
    assert r["weight_head_ms_per_frame"].read(run) == pytest.approx(4.5)
    assert r["fit_stage_ms_per_frame"].read(run) == pytest.approx(0.2)


def test_gaps_go_to_the_innermost_span_at_their_middle(program):
    t, program["records"] = two_frames()
    idle = spans.idle_by_owner(t)
    assert idle == pytest.approx({"shell": 0.9 + 0.9, "step": 2.0,
                                  "client": 2.4})
    run = Run(trace=t)
    assert readers()["shell_idle_ms_per_frame"].read(run) == pytest.approx(
        1.8 * 1e3 / 2)


@pytest.mark.parametrize("fault", ["no_program", "no_trace", "frames",
                                   "two_steps", "root", "missing_stage",
                                   "no_device_ms"])
def test_nothing_to_read_unless_one_tree_a_frame(program, fault):
    t, records = two_frames()
    if fault == "no_program":
        records = None
    elif fault == "no_trace":
        t = None
    elif fault == "frames":
        records = records + frame_records(2, 200)
    elif fault == "two_steps":
        records = records + [rec(300, "woft.step", 0, 0, 1.0)]
    elif fault == "root":
        records = records + [rec(301, "woft.flow", None, 0, 1.0)]
    elif fault == "missing_stage":
        records = [r for r in records if r["id"] != 4]   # frame 0's head
    elif fault == "no_device_ms":
        records = [dict(r, device_ms=None) for r in records]
    program["records"] = records
    r = readers()
    got = {name: r[name].read(Run(trace=t)) for name in NEW}
    if fault == "missing_stage":            # that metric alone
        assert got["weight_head_ms_per_frame"] is None
        assert None not in (got["refine_ms_per_frame"],
                            got["fit_stage_ms_per_frame"],
                            got["shell_idle_ms_per_frame"])
        return
    if fault == "no_device_ms":             # the device readings alone
        assert got["shell_idle_ms_per_frame"] is not None
        del got["shell_idle_ms_per_frame"]
        assert set(got.values()) == {None}
        return
    assert got == dict.fromkeys(NEW)


def test_shell_idle_needs_the_spans_in_the_trace(program):
    t, program["records"] = two_frames()
    t.calls = [c for c in t.calls if c.name != "woft.step"]
    assert readers()["shell_idle_ms_per_frame"].read(Run(trace=t)) is None


def test_a_parent_program_without_spans(monkeypatch):
    """A program whose utils have no span recorder: the readers return
    nothing and do not raise."""
    import builtins
    real = builtins.__import__

    def no_recorder(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "woft_tpu_torch.utils.profiling":
            raise ImportError("cannot import name 'recorded_spans'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_recorder)
    assert spans.recorded() is None
    t, _ = two_frames()
    r = readers()
    for name in NEW:
        assert r[name].read(Run(trace=t)) is None
