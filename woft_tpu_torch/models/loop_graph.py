"""The block-local forward's volume and refinement loop replayed as one CUDA
graph.

On the block-local path (kernels C, D, E) the refinement loop launches
some eighty small kernels an iteration, faster on the card than the host
can issue them, so the device idles inside the loop whenever the host
falls behind, and every stall of the host shows in the frame's time.
``run`` captures the volume's build, the GRU's context terms and the
iterations once per shape and then replays them with one launch a frame:
the same kernels on the same operands, so the results are bit for bit
those of the eager code.

A graph reads its operands from fixed addresses: ``run`` copies the
frame's inputs into the graph's own, and returns the graph's outputs,
which the next replay overwrites. They are read on the stream that
replays, before the next replay is queued there, as the forward does.

Host-side work inside the captured code does not run again on a replay:
the launch counters of ``ops/kernels.py`` are advanced by what the capture
counted, and bf16 weights that the precision scope rounds once a pass are
rounded inside the graph, on every replay.
"""

import collections
import weakref

import torch

from ..ops import kernels
from . import layers

MAX_GRAPHS = 4          # graphs kept a model; the oldest is dropped first

_graphs = weakref.WeakKeyDictionary()     # model -> OrderedDict(key -> entry)


class _Entry:
    __slots__ = ("graph", "inputs", "outputs", "launches")


def _capture(fn, inputs):
    """A CUDA graph of ``fn`` on copies of ``inputs`` -> ``_Entry``."""
    entry = _Entry()
    entry.inputs = tuple(t.clone() for t in inputs)
    entry.graph = torch.cuda.CUDAGraph()
    before = kernels.launch_counters()
    try:
        # rounded weights are made inside the graph
        with layers.fresh_pass(), torch.cuda.graph(
                entry.graph, capture_error_mode="thread_local"):
            entry.outputs = fn(*entry.inputs)
    finally:
        after = kernels.launch_counters()
        for wrapper, n in before.items():
            wrapper.launches = n
    entry.launches = {w: after[w] - n for w, n in before.items()
                      if after[w] != n}
    return entry


def run(model, key, fn, *inputs):
    """``fn(*inputs)``, replayed from a CUDA graph kept on ``model`` under
    ``key``, which names everything ``fn`` reads besides ``inputs`` (the
    shapes, strides and dtypes of the inputs are added to it). The first
    call with a key runs ``fn`` eagerly, which warms up the libraries the
    capture needs, and then captures it; later calls replay. ``inputs``:
    CUDA tensors; ``fn`` reads no other changing tensor, syncs nothing with
    the host and returns tensors or structures of them. Returns the
    graph's outputs (overwritten by the next replay)."""
    key = (key, tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                     for t in inputs))
    graphs = _graphs.setdefault(model, collections.OrderedDict())
    entry = graphs.get(key)
    if entry is None:
        out = fn(*inputs)
        graphs[key] = _capture(fn, inputs)
        while len(graphs) > MAX_GRAPHS:
            graphs.popitem(last=False)
        return out
    graphs.move_to_end(key)
    for dst, src in zip(entry.inputs, inputs):
        dst.copy_(src)
    entry.graph.replay()
    for wrapper, n in entry.launches.items():
        wrapper.launches += n
    return entry.outputs


def captured(model):
    """The number of graphs kept for ``model``."""
    return len(_graphs.get(model, ()))
