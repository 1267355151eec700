#!/usr/bin/env python3
"""Readings that set a cell's correctness limits, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        [--control-seeds 1 2 3] [--controls C ...] [--calls 80]

For each seed: the cell's traffic, the program built and warmed up as a
run does it, ``--calls`` calls (at least a run's sample), then the
numbers the check compares, of the program against the float32 reference
(the lower reading) and, on ``--control-seeds``, of each control against
the float32 reference (the upper reading). A control is
``reference:<precision>`` (the reference at that precision in the
program's place, ``reference/precision.py``) or ``program:<key>=<value>``
(the program with a flow-config key set: its own lower-precision path);
by default the configuration's ``control``. One JSON line a reading on
standard output. Needs the card, as a run does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def parse_control(text):
    """'reference:int8' -> ('reference', 'int8', None); 'program:precision=
    default' -> ('program', 'fp32', {'precision': 'default'})."""
    kind, _, arg = text.partition(":")
    if kind == "reference":
        return kind, arg, None
    if kind == "program":
        key, _, value = arg.partition("=")
        return kind, "fp32", {key: value}
    raise ValueError(f"a control is reference:<precision> or "
                     f"program:<key>=<value>, not {text!r}")


def readings(name, seeds, control_seeds, calls, device="cuda", traffic=None,
             out=print, controls=None):
    import torch

    from benchmark.harness import spec, traffic as tf

    cell = spec.Cell(name, ROOT)
    tspec = dict(cell.traffic if traffic is None else traffic)
    dev = torch.device(device)
    if dev.type == "cuda":
        from woft_tpu_torch.ops import kernels
        kernels.build()
    controls = controls or [cell.config["control"]]
    warm = tspec["warmup_calls"]

    def track(frames, flow=None):
        program = cell.entry.build(cell, frames, dev, {}, flow)
        for k in range(warm + calls):
            program.call(k)
        program.close()
        return program.records

    for seed in sorted(set(seeds) | set(control_seeds)):
        t = time.perf_counter()
        frames = tf.Traffic(tspec, seed, dev)
        window = list(range(warm, warm + calls))
        todo = ([("program", "fp32", None)] if seed in seeds else []) + (
            [(c, *parse_control(c)[1:]) for c in controls]
            if seed in control_seeds else [])
        tracked = {}
        for what, prec, flow in todo:
            key = json.dumps(flow)
            if key not in tracked:
                tracked[key] = track(frames, flow)
            records = tracked[key]
            got = cell.entry.compare(cell, frames, records, window, seed, dev,
                                     prec)
            out(json.dumps({"cell": name, "seed": seed, "reading": what,
                            **got, "seconds": time.perf_counter() - t}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=None)
    ap.add_argument("--calls", type=int, default=80)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from benchmark.run import cache_dirs
    cache_dirs(ROOT)
    readings(args.workload, args.seeds, args.control_seeds, args.calls,
             out=lambda s: print(s, flush=True), controls=args.controls)


if __name__ == "__main__":
    main()
