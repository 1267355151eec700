#!/usr/bin/env python3
"""GMA's grafted additions swept on the benchmark cell's traffic.

Run from the repository root on a machine with an NVIDIA GPU and ``nvcc``:

    python3 tools/torch_gma_sweep.py SEED SCALE,GAMMA [SCALE,GAMMA ...]

No GMA checkpoint is in the repository, so ``flow/wrapper.py:load_model``
grafts GMA's additions onto the trained RAFT-large export: the
SepConvGRU's new input rows at ``GMA_ROWS_SCALE`` times torch's default
bound and ``gamma = GMA_GAMMA``. For each (scale, gamma) pair the tool sets
both (in the loader and in the configuration's ``assumed`` section the
reference reads), builds the program of the cell ``woft_gma-1080p-shared8``
as a run does, tracks a few chunks of the seed's traffic and prints the
check's numbers against the float32 reference (``entries/shared_gma.py:
compare``), with target 0's passed checks; then again with the
aggregation's term removed (gamma set to 0 in the built model), which
tells how far the aggregation moves the flow. Unless ``SKIP_BASE`` is set
in the environment it first runs ``woft_fast-1080p-shared8`` on the same
traffic, the same network without GMA. One JSON line a reading. Imports no
JAX.
"""

import json
import os
import sys
import time

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

CALLS = 4           # chunks tracked after the warm-up, 32 frames


def log(*a):
    print(*a, flush=True)


def track(cell, frames, dev, zero=False):
    """The cell's program on ``frames``: (records, window indices)."""
    import torch

    from woft_tpu_torch.ops import kernels

    t = time.perf_counter()
    program = cell.entry.build(cell, frames, dev, {})
    log(f"  build {time.perf_counter() - t:.2f} s")
    if zero:
        with torch.no_grad():
            program.tracker.model.update_block.aggregator.gamma.zero_()
    warm = cell.traffic["warmup_calls"]
    for k in range(warm):
        program.call(k)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for k in range(warm, warm + CALLS):
        program.call(k)
    log(f"  call ms {(time.perf_counter() - t) / CALLS * 1e3:.2f}, M "
        f"launches so far {kernels.gma_aggregate.launches}")
    program.close()
    return program.records, list(range(warm, warm + CALLS))


def main():
    from benchmark.run import cache_dirs
    cache_dirs(ROOT)
    import torch

    from benchmark.harness import spec, traffic as tf
    from woft_tpu_torch.flow import wrapper
    from woft_tpu_torch.ops import kernels

    seed = int(sys.argv[1])
    settings = [tuple(map(float, a.split(","))) for a in sys.argv[2:]]
    kernels.build()
    dev = torch.device("cuda")
    base = spec.Cell("woft_fast-1080p-shared8", ROOT)
    frames = tf.Traffic(base.traffic, seed, dev)

    def ok0(records):
        return int(sum(r["ok"][:, 0].sum() for r in records[2:]))

    if not os.environ.get("SKIP_BASE"):
        records, window = track(base, frames, dev)
        got = base.entry.compare(base, frames, records, window, seed, dev)
        log(json.dumps({"cell": base.name, "ok0": ok0(records), **got}))
    for scale, gamma in settings:
        cell = spec.Cell("woft_gma-1080p-shared8", ROOT)
        wrapper.GMA_ROWS_SCALE, wrapper.GMA_GAMMA = scale, gamma
        cell.config["assumed"].update(gru_new_rows_scale=scale, gamma=gamma)
        for zero in (False, True):
            records, window = track(cell, frames, dev, zero)
            t = time.perf_counter()
            got = cell.entry.compare(cell, frames, records, window, seed, dev)
            log(json.dumps({"scale": scale, "gamma": gamma, "zeroed": zero,
                            "ok0": ok0(records), **got,
                            "check_s": time.perf_counter() - t}))


if __name__ == "__main__":
    main()
