#!/usr/bin/env python3
"""Run one cell of the benchmark once on the card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. The cell's configuration, traffic, limits and
metrics are found by name (``harness/spec.py``). A run:

1. set-up: imports the program (``woft_tpu_torch``) and builds its kernels
   (``build/torch_kernels/`` in the checkout), renders the seed's frames,
   builds and initialises the program, and warms it up on the first frames
   of the traffic; ``setup_s`` is the time from the process's start to the
   first timed call;
2. the window: calls the program in a closed loop for ``--seconds``
   seconds (host clock; each call ends holding the answer on the host);
3. with ``--trace 1``, a profiled window of a few more calls;
4. the check: after the program's state is freed, the reference
   (``reference/``) recomputes a sample of the window's answers drawn from
   the seed; each compared number is printed beside its limit, last on
   standard error and as the result line's last key;
5. one JSON line: ``correct``, ``attempted``, ``failed``, the end-to-end
   metrics (``--trace 0``) or the per-layer metrics (``--trace 1``), the
   device, and with ``--trace 1`` a breakdown of the traced window.

It exits non-zero with no result when there is no CUDA device or fewer
than the cell asks for, when a module of JAX or of the JAX package is
loaded after the set-up or at the end, and on any error.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "woft_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``woft_tpu_torch`` passes)."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def guard(when):
    found = forbidden_modules()
    if found:
        raise ImportError(f"{when}: modules {found} are loaded; the benchmark "
                          "measures the PyTorch port alone")


def cache_dirs(root):
    """Every build and kernel cache in fixed directories of the checkout."""
    build = Path(root) / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


class Run:
    """What a run hands the metric readers: the cell, its traffic, the
    window's per-call latencies (s), its length (s), the calls and target
    answers in it, the set-up time, the window's records, the traced
    window (or None), the operations of the window's frames and the
    configuration's peak."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(name, seed, seconds, trace, device="cuda", root=ROOT,
             traffic=None, log=None, bench=None):
    """One run of cell ``name``; returns the result dict. ``traffic``
    replaces the cell's traffic parameters (the CPU tests' small frames),
    ``bench`` the benchmark's contents (``spec.Cell``). ``log(str)``
    receives the progress lines (standard error)."""
    import numpy as np
    import torch

    from benchmark.harness import spec, stats, trace as tr, traffic as tf
    from benchmark.harness import work

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    parts = {"import_s": time.perf_counter() - START}
    cell = spec.Cell(name, root, bench)
    tspec = dict(cell.traffic if traffic is None else traffic)
    dev = torch.device(device)

    t = time.perf_counter()
    import woft_tpu_torch  # noqa: F401  the program under test
    from woft_tpu_torch.ops import kernels
    parts["import_s"] += time.perf_counter() - t
    t = time.perf_counter()
    if dev.type == "cuda":
        kernels.build()
    parts["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    frames = tf.Traffic(tspec, seed, dev)
    parts["frames_s"] = time.perf_counter() - t

    program = cell.entry.build(cell, frames, dev, parts)
    t = time.perf_counter()
    k = 0
    for _ in range(tspec["warmup_calls"]):
        program.call(k)
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    parts["warmup_s"] = time.perf_counter() - t
    guard("after the set-up")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    setup_s = time.perf_counter() - START
    lat, first = [], len(program.records)
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        t0 = time.perf_counter()
        program.call(k)
        lat.append(time.perf_counter() - t0)
        k += 1
    window_s = time.perf_counter() - t_start
    window = list(range(first, len(program.records)))
    calls = len(lat)
    per_call = cell.entry.FRAMES_PER_CALL

    traced = None
    if trace:
        def frames_in_trace(n, span):
            nonlocal k
            for _ in range(n):
                with span():
                    program.call(k)
                k += 1
        n0 = len(program.records)
        traced = tr.record(frames_in_trace, tspec["trace_calls"],
                           program.counters)
        traced.records = program.records[n0:]

    memory = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
              else 0)
    guard("after the window")
    records = program.records
    program.close()
    del program
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    answers = [records[i]["H"] for i in window]
    failed = sum(not np.isfinite(h).all() for h in answers)
    t = time.perf_counter()
    got = cell.entry.compare(cell, frames, records, window, seed, dev)
    parts["check_s"] = time.perf_counter() - t
    got["failed"] = failed
    limits = cell.limits["check"]["limits"]
    checks = {key: {"value": got[key], "limit": lim}
              for key, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    fmt = cell.config["number_format"]
    run = Run(cell=cell, traffic=tspec, latencies_s=lat, window_s=window_s,
              calls=calls, answers=calls * per_call, setup_s=setup_s,
              records=[records[i] for i in window], trace=traced,
              flops=cell.entry.frames_flops(
                  cell, tspec, [records[i] for i in window]),
              peak_flops=work.PEAK_FLOPS[fmt])
    metrics = {}
    for entry, reader in cell.metrics(trace):
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    if lat:
        log(f"window: {calls} calls in {window_s:.3f} s; latency median "
            f"{stats.percentile(lat, 50) * 1e3:.3f} ms, p95 "
            f"{stats.percentile(lat, 95) * 1e3:.3f} ms over {len(lat)} "
            f"calls")
    log("set-up: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": 1, "memory_peak_bytes": int(memory)}
    result = {"correct": bool(correct), "attempted": calls * per_call,
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if traced is not None:
        device_info["busy_s"] = tr.busy_s(traced)
        device_info["window_s"] = traced.window_s
        result["breakdown"] = tr.breakdown(traced)
    result["setup_parts"] = parts
    guard("at the end")
    for key, c in checks.items():
        log(f"check {key}: {c['value']} (limit {c['limit']})")
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import spec

    chips = next(w["chips"] for w in spec.benchmark(ROOT)["workloads"]
                 if w["name"] == args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, args.trace)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
