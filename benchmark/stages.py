#!/usr/bin/env python3
"""Device ms by stage from the program's spans in a traced run, and what
the spans cost when they are on.

    python3 benchmark/stages.py --workload <cell> --seed <n> \
        --seconds <s> [--span-kernels F] [--cost-windows N --cost-seconds S]

Runs the cell once with ``--trace 1``, as ``run.py`` does, then prints a
``stages`` JSON line and, last, the run's result line. ``stages``: for each
span name its device ms and host ms a traced frame; the device idle a
frame by owner (``harness/spans.py:idle_by_owner``: shell, step, client);
for each traced frame the device ms of ``woft.step`` and the sum of its
direct children's; and the device-side events of the trace whose name
starts with ``woft.`` (there should be none). Then the program is built
again on the same seed's traffic and warmed up: with ``--span-kernels F``
F more frames run under ``torch.profiler`` and ``span_kernels`` gives, for
each innermost ``woft.*`` span, the device ms a frame of the kernels its
host calls launched (each kernel linked to its launching call by the
profiler's correlation, the call to the spans by the profiler's tree of
host events), the five largest by name; with ``--cost-windows N`` it runs
N pairs of windows of ``--cost-seconds``, with and without the spans
recording (``woft_tpu_torch.utils.profiling.recording``), in turns (off,
on, on, off, ...), and ``cost`` gives each window's ms a frame and the
median of the pairs' differences. Needs the card, as a run does.
"""

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def stage_report(trace, records):
    """The ``stages`` line's contents from a traced window and the
    program's span records."""
    from benchmark.harness import spans

    n = trace.frames
    device, host = {}, {}
    for r in records:
        host[r["name"]] = (host.get(r["name"], 0.0)
                           + (r["host_end_ns"] - r["host_start_ns"]) / 1e6)
        if r["device_ms"] is not None:
            device[r["name"]] = device.get(r["name"], 0.0) + r["device_ms"]
    steps = {r["id"]: r for r in records if r["name"] == spans.STEP}
    children = {i: 0.0 for i in steps}
    for r in records:
        if r["parent"] in children and r["device_ms"] is not None:
            children[r["parent"]] += r["device_ms"]
    idle = spans.idle_by_owner(trace)
    return {
        "frames": n, "spans": len(records),
        "device_ms_per_frame": {k: v / n for k, v in sorted(device.items())},
        "host_ms_per_frame": {k: v / n for k, v in sorted(host.items())},
        "idle_ms_per_frame": (None if idle is None else
                              {k: v * 1e3 / n for k, v in idle.items()}),
        "step_and_children_ms": [[steps[i]["device_ms"], children[i]]
                                 for i in steps],
        "device_side_woft_events": sorted({k.name for k in trace.kernels
                                           if k.name.startswith("woft.")}),
    }


def rebuilt(workload, seed):
    """The cell's program on ``seed``'s traffic, warmed up as a run does
    it; returns it and the index of the next call."""
    import torch

    from benchmark.harness import spec, traffic as tf

    dev = torch.device("cuda")
    cell = spec.Cell(workload, ROOT)
    frames = tf.Traffic(cell.traffic, seed, dev)
    program = cell.entry.build(cell, frames, dev, {})
    k = 0
    for _ in range(cell.traffic["warmup_calls"]):
        program.call(k)
        k += 1
    torch.cuda.synchronize()
    return program, k


def span_kernels(program, k, frames, top=5):
    """Device ms a frame of the kernels launched inside each innermost
    ``woft.*`` span over ``frames`` profiled calls (kernels launched
    outside every span under '(none)')."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            program.call(k + i)
        torch.cuda.synchronize()
    by_span = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CPU or not ev.kernels:
            continue
        owner = ev
        while owner is not None and not owner.name.startswith("woft."):
            owner = owner.cpu_parent
        ops = by_span.setdefault("(none)" if owner is None else owner.name,
                                 {})
        for kern in ev.kernels:              # durations in us
            ops[kern.name] = ops.get(kern.name, 0.0) + kern.duration / 1e3
    out = {}
    for name, ops in sorted(by_span.items()):
        ranked = sorted(ops.items(), key=lambda x: -x[1])
        out[name] = {"ms": sum(ops.values()) / frames,
                     "top": [[n[:160], v / frames] for n, v in ranked[:top]]}
    return out, k + frames


def cost(program, k, windows, seconds):
    """Ms a frame of ``windows`` pairs of windows without and with the
    spans recording, in turns, on one program."""
    from woft_tpu_torch.utils import profiling

    rows = []
    for i in range(windows):
        pair = {}
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            scope = profiling.recording() if on else contextlib.nullcontext()
            calls, t0 = 0, time.perf_counter()
            with scope:
                while time.perf_counter() - t0 < seconds:
                    program.call(k)
                    k += 1
                    calls += 1
            pair["on" if on else "off"] = ((time.perf_counter() - t0) * 1e3
                                           / calls)
            profiling.recorded_spans()
            profiling.clear_spans()
        rows.append(pair)
    diffs = [p["on"] - p["off"] for p in rows]
    return {"windows": rows, "seconds": seconds,
            "median_on_minus_off_ms": statistics.median(diffs),
            "median_off_ms": statistics.median(p["off"] for p in rows),
            "median_on_ms": statistics.median(p["on"] for p in rows)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--span-kernels", type=int, default=0)
    ap.add_argument("--cost-windows", type=int, default=0)
    ap.add_argument("--cost-seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import run as brun
    from benchmark.harness import spans, trace as tr

    brun.cache_dirs(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    traced, record = [], tr.record

    def keep(*a, **kw):
        traced.append(record(*a, **kw))
        return traced[-1]

    tr.record = keep
    try:
        result = brun.run_cell(args.workload, args.seed, args.seconds, 1)
    finally:
        tr.record = record
    report = {"stages": stage_report(traced[0], spans.recorded() or [])}
    if args.span_kernels or args.cost_windows:
        program, k = rebuilt(args.workload, args.seed)
        if args.span_kernels:
            report["span_kernels"], k = span_kernels(program, k,
                                                     args.span_kernels)
        if args.cost_windows:
            report["cost"] = cost(program, k, args.cost_windows,
                                  args.cost_seconds)
        program.close()
    print(json.dumps(report), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
