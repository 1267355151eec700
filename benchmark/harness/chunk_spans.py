"""The program's stage spans in the traced window of a chunked cell.

A traced call of ``SharedMultiTracker.track_chunk`` is one span tree rooted
at ``woft.chunk``, with ``woft.upload``, one ``woft.step`` a frame of the
chunk and ``woft.readback`` under it, and each step's stages under its
``woft.step`` (``harness/spans.py`` reads the one-step trees of
``woft.track`` and finds none here). Readings are device ms a tracked
frame: a traced call's over the traffic's ``chunk``.

A reader gets nothing (None) from a program without spans, and unless
the recorder holds exactly one tree a traced call, each rooted at
``woft.chunk`` with ``chunk`` ``woft.step`` spans.
"""

from benchmark.harness import spans

CHUNK = "woft.chunk"


def chunk_trees(run):
    """The traced calls' span trees ([record] a call, in order), or
    None."""
    t = run.trace
    records = spans.recorded() if t is not None else None
    if not records:
        return None
    trees = {}
    for r in records:
        trees.setdefault(r["frame"], []).append(r)
    trees = list(trees.values())
    for tree in trees:
        roots = [r["name"] for r in tree if r["parent"] is None]
        steps = sum(r["name"] == spans.STEP for r in tree)
        if roots != [CHUNK] or steps != run.traffic["chunk"]:
            return None
    return trees if len(trees) == t.frames else None


def _under(by_id, record, name):
    """Whether a span named ``name`` encloses ``record`` (``by_id``: its
    tree's records by id)."""
    parent = record["parent"]
    while parent is not None:
        if by_id[parent]["name"] == name:
            return True
        parent = by_id[parent]["parent"]
    return False


def device_ms_per_frame(run, names, less=()):
    """Device ms of the spans named in ``names``, less those named ``a``
    inside a span named ``b`` for each (a, b) of ``less``, summed over the
    traced calls' trees, a tracked frame; None where a tree holds none of
    ``names`` or a span of them has no device time."""
    trees = chunk_trees(run)
    if trees is None:
        return None
    total = 0.0
    for tree in trees:
        by_id = {r["id"]: r for r in tree}
        ms = [r["device_ms"] for r in tree if r["name"] in names]
        cut = [r["device_ms"] for r in tree for a, b in less
               if r["name"] == a and _under(by_id, r, b)]
        if not ms or any(v is None for v in ms + cut):
            return None
        total += sum(ms) - sum(cut)
    return total / (run.trace.frames * run.traffic["chunk"])
