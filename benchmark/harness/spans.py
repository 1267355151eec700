"""The program's stage spans in the traced window.

The profiled window of a ``--trace 1`` run turns on the spans of
``woft_tpu_torch.utils.profiling``: a tracked frame is one tree rooted at
``woft.track``, with ``woft.upload``, ``woft.step`` and ``woft.readback``
under it and the step's stages under ``woft.step``. Each span holds its
device ms (stream time between the CUDA events at its entry and exit)
and is a host event of its name in the trace (``Trace.calls``).

A reader gets nothing (None) from a program without spans, and unless
the recorder holds exactly one tree a traced frame, each rooted at
``woft.track`` with one ``woft.step``.
"""

from benchmark.harness import trace as tr

TRACK, STEP = "woft.track", "woft.step"
PREFIX = "woft."


def recorded():
    """The program's closed spans, or None where it records none."""
    try:
        from woft_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    return recorded_spans()


def frame_trees(run):
    """The traced frames' span trees ([record] a frame, in order), or
    None."""
    t = run.trace
    records = recorded() if t is not None else None
    if not records:
        return None
    trees = {}
    for r in records:
        trees.setdefault(r["frame"], []).append(r)
    trees = list(trees.values())
    for tree in trees:
        roots = [r["name"] for r in tree if r["parent"] is None]
        if roots != [TRACK] or sum(r["name"] == STEP for r in tree) != 1:
            return None
    return trees if len(trees) == t.frames else None


def device_ms_per_frame(run, name):
    """Device ms of the spans named ``name``, summed over the traced
    frames' trees, a frame; None where a tree holds none."""
    trees = frame_trees(run)
    if trees is None:
        return None
    ms = [[r["device_ms"] for r in tree if r["name"] == name]
          for tree in trees]
    if not all(ms) or any(v is None for m in ms for v in m):
        return None
    return sum(map(sum, ms)) / run.trace.frames


def idle_by_owner(trace):
    """Seconds of the traced window's device idle gaps by who held the
    host at each gap's middle (the innermost ``woft.*`` host event open
    then, the rule of ``trace.breakdown``): 'shell' (inside ``woft.track``
    but outside ``woft.step``), 'step' (inside ``woft.step``) and 'client'
    (outside every ``woft.track``). None unless the trace holds one
    ``woft.track`` and one ``woft.step`` event a traced frame."""
    spans = [c for c in trace.calls if c.name.startswith(PREFIX)]
    tracks = [c for c in spans if c.name == TRACK]
    steps = [c for c in spans if c.name == STEP]
    if len(tracks) != trace.frames or len(steps) != trace.frames:
        return None
    gaps = tr.idle_gaps(trace)
    owners = tr.innermost_calls(spans, [(s + e) / 2 for s, e in gaps])

    def inside(c, outer):
        return any(o.start <= c.start and c.end <= o.end for o in outer)

    out = {"shell": 0.0, "step": 0.0, "client": 0.0}
    for (s, e), c in zip(gaps, owners):
        if c is None or not inside(c, tracks):
            out["client"] += e - s
        elif inside(c, steps):
            out["step"] += e - s
        else:
            out["shell"] += e - s
    return out
