"""The traced window: ``torch.profiler`` over a few frames, and its
reduction to device intervals, launch calls and a breakdown.

Device operations are the kernels and the copies and fills the profiler
records on the device. Kernel names map to layers by ``CATEGORIES``
(first match on a lower-case substring; the convolution keys include
cuDNN's layout transposes).
"""

from dataclasses import dataclass, field

CATEGORIES = (
    ("copy", ("memcpy", "memset")),
    ("kernel G (fused GRU)", ("gru_update_kernel",)),
    ("kernel I (flow head)", ("flow_head_kernel",)),
    ("kernel H (motion tail)", ("motion_stage",)),
    ("kernel B (corr lookup)", ("corr_lookup_kernel",)),
    ("kernel C (local volume)", ("local_corr_",)),
    ("kernel E (exact local lookup)", ("local_lookup_exact_kernel",)),
    ("kernels D/F (fine local lookup)", ("local_lookup_fine_kernel",)),
    ("kernel A (pre-warp)", ("warp_bilinear_kernel",)),
    ("convolution", ("fprop", "conv", "cudnn", "winograd", "fft", "cf32",
                     "nchwtonhwc", "nhwctonchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "matmul")),
    ("qr / solve", ("geqrf", "orgqr", "trsm", "getrf", "potrf", "cusolver",
                    "magma")),
    ("normalisation", ("batch_norm", "norm", "softmax")),
    ("reduction", ("reduce",)),
    ("gather / index", ("index", "gather", "scatter", "sort", "scan")),
)
OTHER = "elementwise / other"

# host calls that put work on the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch",
                "cudaLaunchCooperativeKernel")
FRAME_SPAN = "benchmark.frame"
NAME_CHARS = 160


def category(name):
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return OTHER


@dataclass
class Interval:
    name: str
    start: float          # seconds, on the profiler's clock
    end: float


@dataclass
class Trace:
    """What a traced window holds: device ``kernels``, host ``calls``
    (every CPU-side event), the ``window`` [start, end) of the traced
    frames, their count, and the program's launch counters over it."""
    kernels: list
    calls: list
    window: tuple
    frames: int
    counters: dict = field(default_factory=dict)

    @property
    def window_s(self):
        return self.window[1] - self.window[0]


def union(intervals, lo, hi):
    """Sorted disjoint [start, end) pieces covered by ``intervals`` within
    [lo, hi)."""
    spans = sorted((max(i.start, lo), min(i.end, hi)) for i in intervals
                   if i.end > lo and i.start < hi)
    out = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(trace):
    """Seconds in which some kernel ran, within the window."""
    return sum(e - s for s, e in union(trace.kernels, *trace.window))


def idle_gaps(trace):
    """[(start, end)] within the window where no kernel ran."""
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in union(trace.kernels, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def kernel_seconds(trace, match):
    """Summed device seconds of the kernels whose name ``match`` accepts."""
    return sum(k.end - k.start for k in trace.kernels if match(k.name))


def innermost_calls(calls, points):
    """For each time in ``points`` (sorted), the innermost host call open
    then (the latest-started one with start <= t < end), or None: one
    sweep over the calls' starts and ends."""
    marks = sorted([(c.start, 1, i) for i, c in enumerate(calls)]
                   + [(c.end, 0, i) for i, c in enumerate(calls)]
                   + [(t, 2, j) for j, t in enumerate(points)])
    stack, ended, out = [], set(), [None] * len(points)
    for _, kind, i in marks:
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            ended.add(i)
        else:
            while stack and stack[-1] in ended:
                stack.pop()
            out[i] = calls[stack[-1]] if stack else None
    return out


def breakdown(trace, top=10):
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing then (the innermost host call open at
    the gap's middle, or 'python' where none was)."""
    ops = {}
    for k in trace.kernels:
        name = k.name[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (k.end - k.start)
    gaps = idle_gaps(trace)
    calls = [c for c in trace.calls if c.name != FRAME_SPAN]
    owners = innermost_calls(calls, [(s + e) / 2 for s, e in gaps])
    by_call = {}
    for (s, e), c in zip(gaps, owners):
        name = (c.name if c is not None else "python")[:NAME_CHARS]
        by_call[name] = by_call.get(name, 0.0) + (e - s)

    def ranked(d):
        return [[n, v] for n, v in sorted(d.items(), key=lambda x: -x[1])
                ][:top]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(by_call)}


def record(run_frames, n_frames, counters=None):
    """Run ``run_frames(n, span)`` under ``torch.profiler`` (CPU and CUDA
    activity), each frame inside ``span()``; returns its ``Trace``.
    ``counters()``, when given, reads the program's launch counters; the
    trace keeps their change over the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    before = counters() if counters else {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_frames(n_frames, lambda: record_function(FRAME_SPAN))
        torch.cuda.synchronize()
    after = counters() if counters else {}
    kernels, calls, frames = [], [], []
    for ev in prof.events():
        iv = Interval(ev.name, ev.time_range.start / 1e6,
                      ev.time_range.end / 1e6)
        on_device = ev.device_type == torch.autograd.DeviceType.CUDA
        if ev.name == FRAME_SPAN:
            if not on_device:          # not the span's mirror on the device
                frames.append(iv)
        elif on_device:
            kernels.append(iv)
        else:
            calls.append(iv)
    if len(frames) != n_frames or not kernels:
        raise RuntimeError(f"the profiler recorded {len(frames)} of "
                           f"{n_frames} frames and {len(kernels)} kernels")
    window = (min(f.start for f in frames), max(f.end for f in frames))
    return Trace(kernels, calls, window, n_frames,
                 {k: after[k] - before.get(k, 0) for k in after})
