"""The program's stage spans (``woft_tpu_torch/utils/profiling.py``) on the
CPU: off by default, one ``woft.track`` tree a tracked frame under
``torch.profiler`` or ``recording()``, FUNCTION-scope host events in the
profiler's trace (no user annotation, so nothing mirrored on a device's
timeline), and a tracker whose answers do not move when they are on.

The shell runs a tiny seeded WeightedRAFT (2 iterations, one 32-channel
weight-head layer) on 64x96 frames, or oracle flow through the step's
``flow_fn`` seam: zero flow passes the inlier check, random flow fails it
and sends the frame down the local fallback.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from woft_tpu_torch.config import Config
from woft_tpu_torch.flow.wrapper import RaftFlow
from woft_tpu_torch.tracker import woft as tw
from woft_tpu_torch.utils import profiling

H_IMG, W_IMG = 64, 96

# (name, parent's name) of a frame's spans, with their counts: a frame
# whose check passed, on oracle flow (no network spans)
SHELL = Counter({("woft.track", None): 1, ("woft.upload", "woft.track"): 1,
                 ("woft.step", "woft.track"): 1,
                 ("woft.readback", "woft.track"): 1})
STEP = Counter({("woft.prewarp", "woft.step"): 1,
                ("woft.flow", "woft.step"): 1,
                ("woft.select", "woft.step"): 2,
                ("woft.fit", "woft.step"): 1,
                ("woft.check", "woft.step"): 1,
                ("woft.wait", "woft.step"): 1})
FALLBACK = Counter({("woft.fallback", "woft.step"): 1,
                    ("woft.select", "woft.fallback"): 2,
                    ("woft.flow", "woft.fallback"): 1,
                    ("woft.fit", "woft.fallback"): 1})
NETWORK = ("woft.flow.encode", "woft.flow.volume", "woft.flow.refine",
           "woft.flow.upsample")


@pytest.fixture(autouse=True)
def _two_threads_and_no_spans():
    """Two intra-op threads (several workers share the machine), and an
    empty recorder before and after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    profiling.clear_spans()
    yield
    profiling.clear_spans()
    torch.set_num_threads(n)


def tiny_config():
    conf = Config()
    conf.tracker_class = tw.WOFTTracker
    flow = Config()
    flow.of_class = RaftFlow
    flow.raft_type = "weighted"
    flow.class_params = Config()
    flow.class_params.small = False
    flow.class_params.weight_head_structure = [(32, 3)]
    flow.iters = 2
    flow.padding_mode = "nopad"
    conf.flow_config = flow
    conf.tracker_params = tw.TrackerParams(padding_mode="nopad",
                                           subsample_n=100)
    return conf


def clip(n):
    rng = np.random.default_rng(3)
    template = rng.integers(0, 256, (H_IMG, W_IMG, 3), dtype=np.uint8)
    mask = np.zeros((H_IMG, W_IMG), bool)
    mask[16:48, 24:72] = True
    frames = [np.roll(template, (t % 2, t % 3), axis=(0, 1))
              for t in range(1, n + 1)]
    return template, mask, frames


def tracker(oracle=None):
    """A shell on the tiny network, or on oracle flow: ``oracle["bad"]``
    set, the flow is random (the check fails), else zero."""
    t = tw.WOFTTracker(tiny_config(), device="cpu")
    if oracle is not None:
        rng = np.random.default_rng(0)

        def flow_fn(model, img1, img2, template_feats=None):
            shape = (1, H_IMG, W_IMG)
            flow = (torch.from_numpy(rng.uniform(
                -20, 20, shape + (2,)).astype(np.float32))
                if oracle["bad"] else torch.zeros(shape + (2,)))
            return flow, torch.ones(shape + (1,))

        t._step = tw.build_track_step(t.raft_cfg, t.tp, flow_fn=flow_fn)
    return t


def trees(records):
    """{frame id: Counter of (name, parent's name)}."""
    by_id = {r["id"]: r for r in records}
    out = {}
    for r in records:
        parent = by_id[r["parent"]]["name"] if r["parent"] is not None \
            else None
        out.setdefault(r["frame"], Counter())[(r["name"], parent)] += 1
    return out


def test_off_by_default_records_nothing():
    template, mask, frames = clip(2)
    t = tracker({"bad": False})
    t.init(template, mask)
    for f in frames:
        t.track(f)
    assert profiling.recorded_spans() == []
    assert profiling.span("woft.x") is profiling.span("woft.y")
    with profiling.recording():
        pass
    t.track(frames[0])
    assert profiling.recorded_spans() == []


def test_one_track_tree_a_frame_under_the_profiler():
    """Three oracle frames (the second fails its check): three trees, one
    frame id each, with the spans of the table and their parents; the
    spans are host events of FUNCTION scope in the profiler's trace."""
    template, mask, frames = clip(3)
    oracle = {"bad": False}
    t = tracker(oracle)
    t.init(template, mask)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i, f in enumerate(frames):
            oracle["bad"] = i == 1
            _, meta = t.track(f)
            assert bool(meta.global_H_success) == (i != 1)
    records = profiling.recorded_spans()
    got = trees(records)
    assert len(got) == 3
    ok = SHELL + STEP
    assert list(got.values()) == [ok, ok + FALLBACK, ok]
    for r in records:
        assert r["host_start_ns"] <= r["host_end_ns"]
        assert r["device_ms"] is None           # no CUDA device
    events = [e for e in prof.events() if e.name.startswith("woft.")]
    assert Counter(e.name for e in events) == Counter(
        r["name"] for r in records)
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation


def test_network_spans_and_answers_unchanged_when_recording():
    """The tiny network on the sparse weight head: the flow network's
    stages nest in ``woft.flow``, the weight head in the Sobol gather's
    ``woft.select``; H and the meta are bit-identical with the spans off
    and on."""
    template, mask, frames = clip(2)
    runs = []
    for on in (False, True):
        profiling.clear_spans()
        t = tracker()
        t.init(template, mask)
        out = []
        if on:
            with profiling.recording():
                out = [t.track(f) for f in frames]
        else:
            out = [t.track(f) for f in frames]
        runs.append((out, profiling.recorded_spans()))
    (off, none), (on, records) = runs
    assert none == []
    for (H0, m0), (H1, m1) in zip(off, on):
        np.testing.assert_array_equal(H0, H1)
        assert vars(m0).keys() == vars(m1).keys()
        for k in vars(m0):
            np.testing.assert_array_equal(getattr(m0, k), getattr(m1, k))
    for tree in trees(records).values():
        assert tree[("woft.track", None)] == 1
        for name in NETWORK:
            assert tree[(name, "woft.flow")] == 1, name
        assert tree[("woft.weight_head", "woft.select")] == 1


def test_nesting_frames_and_clearing():
    """A span opened outside any other starts a frame id; nested spans
    carry it and their parent's id; ``clear_spans`` empties the deque."""
    with profiling.recording():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
        with profiling.span("c"):
            pass
    a, b, c = profiling.recorded_spans()
    assert (a["name"], b["name"], c["name"]) == ("a", "b", "c")
    assert a["parent"] is None and b["parent"] == a["id"]
    assert b["frame"] == a["frame"] != c["frame"]
    profiling.clear_spans()
    assert profiling.recorded_spans() == []


def shared_tracker():
    """``SharedMultiTracker`` on the tiny network, two targets."""
    from woft_tpu_torch.pipeline import SharedMultiTracker

    flower = RaftFlow(tiny_config().flow_config, device="cpu")
    return SharedMultiTracker(flower.model, flower.cfg,
                              tw.TrackerParams(subsample_n=100),
                              device="cpu")


def two_masks():
    masks = np.zeros((2, H_IMG, W_IMG), bool)
    masks[0, 16:48, 8:40] = True
    masks[1, 16:48, 56:88] = True
    return masks


def test_one_chunk_tree_a_traced_track_chunk():
    """A traced ``track_chunk`` of T frames is one ``woft.chunk`` tree with
    the upload, T ``woft.step`` spans and the readback under it, each
    step's stages and the network's under the step; a traced ``track`` of
    the shared tracker is one ``woft.track`` tree like the shell's."""
    template, _, frames = clip(3)
    t = shared_tracker()
    t.init(template, two_masks())
    with profile(activities=[ProfilerActivity.CPU]):
        t.track_chunk(np.stack(frames))
        t.track(frames[0])
    chunk, single = trees(profiling.recorded_spans()).values()
    step = Counter({("woft.prewarp", "woft.step"): 1,
                    ("woft.flow", "woft.step"): 1,
                    ("woft.select", "woft.step"): 2,
                    ("woft.fit", "woft.step"): 1,
                    ("woft.check", "woft.step"): 1,
                    ("woft.weight_head", "woft.select"): 1})
    step.update({(name, "woft.flow"): 1 for name in NETWORK})
    want = Counter({("woft.chunk", None): 1,
                    ("woft.upload", "woft.chunk"): 1,
                    ("woft.step", "woft.chunk"): 3,
                    ("woft.readback", "woft.chunk"): 1})
    for _ in range(3):
        want.update(step)
    assert chunk == want
    assert single == SHELL + step


def test_shared_tracker_records_nothing_when_off():
    """Tracing off, ``track_chunk`` records no span; its answers equal
    those of a run recording its spans, bit for bit."""
    template, _, frames = clip(2)
    runs = []
    for on in (False, True):
        t = shared_tracker()
        t.init(template, two_masks())
        if on:
            with profiling.recording():
                runs.append(t.track_chunk(np.stack(frames)))
        else:
            runs.append(t.track_chunk(np.stack(frames)))
            assert profiling.recorded_spans() == []
    (hs0, m0), (hs1, m1) = runs
    np.testing.assert_array_equal(hs0, hs1)
    for k in m0:
        np.testing.assert_array_equal(m0[k], m1[k])
    assert profiling.recorded_spans()
