"""Profiling: the program's stage spans, and a Chrome trace of N steps.

``span(name, device)`` marks a stage of the program (``woft.track``,
``woft.step``, ``woft.flow.refine``, ...). It is off by default, and then
costs one flag check: no event, no record, no synchronisation. It is on
while a ``torch.profiler`` session records, or inside ``recording()``.
When on, a span

- opens a FUNCTION-scope profiler range of its name
  (``_RecordFunctionFast``: a host event on the trace's clock; unlike
  ``record_function``'s user-scope range it leaves no mirror on the
  device's timeline, so the trace's device intervals stay the kernels'),
- records a timing ``torch.cuda.Event`` on the current stream of its CUDA
  ``device`` at entry and at exit (none for a CPU device or None),
- notes ``time.perf_counter_ns()`` at entry and at exit,
- appends a record to a bounded in-memory deque: its name, its parent's
  id, its frame id, the host stamps and the two events.

A span opened while no other is open (``woft.track`` in the tracker's
shell) starts a new frame id; every span nested in it carries that id and
its parent's. A span never synchronises: ``recorded_spans()`` resolves
each span's device ms (stream time between its two events) after one
synchronise a device, and ``clear_spans()`` empties the deque.

``trace_step`` records N steps under ``torch.profiler`` (CPU activity, and
CUDA's where a card is present) and writes a Chrome trace to ``log_dir``
(open it in Perfetto or ``chrome://tracing``; the JAX package writes an
xprof trace); the spans show in it by name.
"""

import collections
import contextlib
import itertools
import logging
import os
import threading
import time

import torch

logger = logging.getLogger(__name__)

MAX_SPANS = 1 << 16     # records kept; the oldest drop out first


class _Record:
    __slots__ = ("id", "name", "parent", "frame", "start_ns", "end_ns",
                 "device", "events", "device_ms")

    def __init__(self, id_, name, parent, frame):
        self.id, self.name, self.parent, self.frame = id_, name, parent, frame
        self.start_ns = self.end_ns = self.device = self.events = None
        self.device_ms = None


class _Recorder:
    """The spans of the process: the deque of records, each thread's stack
    of open spans, and a pool of timing events a device."""

    def __init__(self, maxlen=MAX_SPANS):
        self.on = 0                     # open ``recording()`` scopes
        self.records = collections.deque(maxlen=maxlen)
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count()
        self.frames = itertools.count()
        self.pool = collections.defaultdict(list)

    def stack(self):
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s

    def events(self, index):
        with self.lock:
            free = self.pool[index]
            if len(free) >= 2:
                return free.pop(), free.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def release(self, record):
        """Return a closed record's events to the pool (the lock held)."""
        if record.events is not None and record.end_ns is not None:
            self.pool[record.device].extend(record.events)
            record.events = None

    def append(self, record):
        with self.lock:
            if len(self.records) == self.records.maxlen:
                self.release(self.records[0])
            self.records.append(record)


_RECORDER = _Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "device", "record", "range", "stream")

    def __init__(self, name, device):
        self.name = name
        self.device = (torch.device(device) if device is not None
                       else None)

    def __enter__(self):
        rec = _RECORDER
        stack = rec.stack()
        parent = stack[-1] if stack else None
        r = _Record(next(rec.ids), self.name,
                    None if parent is None else parent.id,
                    next(rec.frames) if parent is None else parent.frame)
        self.record = r
        self.range = torch._C._profiler._RecordFunctionFast(self.name)
        self.range.__enter__()
        self.stream = None
        if self.device is not None and self.device.type == "cuda":
            r.device = (self.device.index if self.device.index is not None
                        else torch.cuda.current_device())
            r.events = rec.events(r.device)
            self.stream = torch.cuda.current_stream(r.device)
            r.events[0].record(self.stream)
        stack.append(r)
        rec.append(r)
        r.start_ns = time.perf_counter_ns()
        return r

    def __exit__(self, *exc):
        r = self.record
        end = time.perf_counter_ns()
        if self.stream is not None:
            r.events[1].record(self.stream)
        r.end_ns = end                  # closed: both events recorded
        _RECORDER.stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name, device=None):
    """A context manager marking a stage of the program (see the module
    docstring). ``device``: the CUDA device whose current stream the
    span's events time; None or a CPU device records host times only."""
    if not (_RECORDER.on or torch.autograd._profiler_enabled()):
        return _OFF
    return _Span(name, device)


@contextlib.contextmanager
def recording():
    """Turn the spans on without a profiler: per-stage device and host
    times for ``recorded_spans()``."""
    rec = _RECORDER
    with rec.lock:
        rec.on += 1
    try:
        yield
    finally:
        with rec.lock:
            rec.on -= 1


def recorded_spans():
    """The closed spans in the order they opened: dicts with ``id``,
    ``name``, ``parent`` (an id or None), ``frame``, ``host_start_ns``,
    ``host_end_ns`` (``time.perf_counter_ns``) and ``device_ms`` (the
    stream time between the span's two events, None without a CUDA
    device). Synchronises each device that holds unresolved events once."""
    rec = _RECORDER
    with rec.lock:
        closed = [r for r in rec.records if r.end_ns is not None]
    pending = [r for r in closed if r.events is not None]
    for index in {r.device for r in pending}:
        torch.cuda.synchronize(index)
    with rec.lock:
        for r in pending:
            if r.events is not None:
                r.device_ms = r.events[0].elapsed_time(r.events[1])
                rec.release(r)
    return [{"id": r.id, "name": r.name, "parent": r.parent,
             "frame": r.frame, "host_start_ns": r.start_ns,
             "host_end_ns": r.end_ns, "device_ms": r.device_ms}
            for r in closed]


def clear_spans():
    """Forget every recorded span (open ones keep their ids)."""
    rec = _RECORDER
    with rec.lock:
        for r in rec.records:
            rec.release(r)
        rec.records.clear()


def trace_step(step_fn, args, *, log_dir="woft_trace", n=3):
    """Run ``step_fn(*args)`` ``n`` times under ``torch.profiler``.

    Returns the last result; the Chrome trace lands in
    ``log_dir/trace.json``. Chain-dependent steps should pass updated args
    themselves."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        out = None
        for _ in range(n):
            out = step_fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return out
