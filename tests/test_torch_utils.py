"""The port's host utilities against ``woft_tpu``'s on the CPU: the rest of
``geometry/bbox.py``, ``ops/interpolation.py``, ``utils/io.py``,
``utils/timing.py`` and ``utils/vis.py``.

Held bit for bit (float64, or the same integer images): the bbox helpers,
``bilinear_interpolate`` and ``forward_interpolate``, ``flow_to_image``
and the drawing helpers, the png flow files, the frame readers and
writers. Held within 1e-5 with equal NaN positions: ``interp_flow``,
``flow_warp_coords`` and ``chain_flow`` (float32 bilinear sampling in two
libraries). Without ``cv2``, each function that needs it raises an
``ImportError`` naming itself. The small utilities (``random_utils``,
``logging_utils``, ``notifications``, ``profiling``): the same draws, log
lines and notification lines as the JAX package's; the profiler's trace
written on the CPU.
"""

import builtins
import gzip
import pickle
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.geometry import bbox as jbbox
from woft_tpu.ops import interpolation as jinterp
from woft_tpu.utils import io as jio
from woft_tpu.utils import vis as jvis
from woft_tpu_torch.geometry import bbox as tbbox
from woft_tpu_torch.ops import interpolation as tinterp
from woft_tpu_torch.utils import io as tio
from woft_tpu_torch.utils import timing as ttiming
from woft_tpu_torch.utils import vis as tvis

from test_torch_window import textured

INTERP_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several worker processes run the suite at once; two intra-op
    threads while this module runs, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


# ---------------------------------------------------------------------------
# geometry/bbox.py
# ---------------------------------------------------------------------------

def _box(mod, xywh):
    return mod.Bbox.from_xywh(xywh)


@pytest.mark.parametrize("xywh", [(10.4, 20.6, 30.2, 15.5), (-3, 5, 40, 41),
                                  (0.5, 0.5, 7, 9)])
def test_bbox_points_and_crops_match_jax(xywh):
    bt, bj = _box(tbbox, xywh), _box(jbbox, xywh)
    assert bt.as_points() == bj.as_points()
    rt, rj = bt.rounded_to_int(), bj.rounded_to_int()
    assert rt.as_xywh() == rj.as_xywh()
    assert all(isinstance(v, int) for v in rt.as_xyxy())
    pts = np.asarray(bt.as_points(), float).T
    assert (tbbox.Bbox.from_points(pts).as_xywh()
            == jbbox.Bbox.from_points(pts).as_xywh())
    img = np.arange(80 * 90 * 3).reshape(80, 90, 3)
    np.testing.assert_array_equal(bt.crop_image(img), bj.crop_image(img))


def test_bbox_homography_helpers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-5, 105, (2, 50))
    for axis in (None, 0):
        np.testing.assert_array_equal(tbbox.in_bounds(x, 0, 100, axis),
                                      jbbox.in_bounds(x, 0, 100, axis))
    H = np.array([[1.02, 0.03, 4.5], [-0.02, 0.98, -3.0], [1e-4, 2e-4, 1.0]])
    corners = np.array([[10, 60, 60, 10], [20, 20, 70, 70]], float)
    dt, dj = tbbox.decompose_h(H, corners), jbbox.decompose_h(H, corners)
    np.testing.assert_array_equal(dt.translation2target,
                                  dj.translation2target)
    np.testing.assert_array_equal(dt.no_translation2target,
                                  dj.no_translation2target)
    A = H[:2]
    np.testing.assert_array_equal(tbbox.a2h(A), jbbox.a2h(A))
    assert tbbox.a2h(None) is None
    with pytest.raises(ValueError):
        tbbox.a2h(H)
    H2 = np.array([[0.97, -0.05, -2.0], [0.04, 1.01, 6.0], [0, -1e-4, 1.0]])
    for t in (0.0, 0.3, 1.0):
        np.testing.assert_array_equal(tbbox.h_interpolate(H, H2, t),
                                      jbbox.h_interpolate(H, H2, t))
    np.testing.assert_array_equal(tbbox.compose_h(H, H2),
                                  jbbox.compose_h(H, H2))
    assert tbbox.compose_h(H, None) is None


def test_h_coord_system_graph_matches_jax():
    rng = np.random.default_rng(1)
    hs = [np.eye(3) + rng.normal(0, 0.01, (3, 3)) for _ in range(3)]
    graphs = []
    for mod in (tbbox, jbbox):
        g = mod.HCoordSystemGraph()
        g.add_mutating("a", "b", hs[0])
        g = g.add("b", "c", hs[1]).add("d", "c", hs[2])
        graphs.append(g)
    for src, dst in (("a", "c"), ("d", "a"), ("c", "c"), ("b", "d")):
        np.testing.assert_array_equal(graphs[0].get(src, dst),
                                      graphs[1].get(src, dst))
    with pytest.raises(RuntimeError, match="No known transformation"):
        graphs[0].get("a", "zz")
    copy = graphs[0].copy()
    copy.add_mutating("c", "e", hs[0])
    with pytest.raises(RuntimeError):
        graphs[0].get("a", "e")


# ---------------------------------------------------------------------------
# ops/interpolation.py
# ---------------------------------------------------------------------------

def _flow(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, (h, w, 2))).astype(np.float32)


def _assert_nan_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=INTERP_ATOL,
                               equal_nan=True)


def test_interp_flow_and_coords_match_jax():
    flow = _flow(20, 30, 2)
    rng = np.random.default_rng(3)
    coords = np.stack([rng.uniform(-3, 33, 400),
                       rng.uniform(-3, 23, 400)]).astype(np.float32)
    coords[:, :4] = [[0, 29, 29.0, 12.5], [0, 19, 0.0, 19.0]]   # the edges
    ft, ct = torch.from_numpy(flow), torch.from_numpy(coords)
    got = tinterp.interp_flow(ft, ct)
    want = jinterp.interp_flow(jnp.asarray(flow), coords)
    assert np.isnan(want).any() and not np.isnan(want[:, :4]).any()
    _assert_nan_close(got, want)
    _assert_nan_close(tinterp.interp_flow(ft, ct, occlusion_nan=False),
                      jinterp.interp_flow(jnp.asarray(flow), coords,
                                          occlusion_nan=False))
    _assert_nan_close(tinterp.flow_warp_coords(ct, ft),
                      jinterp.flow_warp_coords(coords, jnp.asarray(flow)))


def test_chain_flow_matches_jax():
    ab, bc = _flow(24, 32, 4), _flow(24, 32, 5)
    _assert_nan_close(tinterp.chain_flow(torch.from_numpy(ab),
                                         torch.from_numpy(bc)),
                      jinterp.chain_flow(jnp.asarray(ab), jnp.asarray(bc)))


def test_host_interpolation_is_bit_equal():
    rng = np.random.default_rng(6)
    for im in (rng.normal(size=(15, 20)), rng.normal(size=(15, 20, 3))):
        x, y = rng.uniform(-2, 22, 100), rng.uniform(-2, 17, 100)
        np.testing.assert_array_equal(tinterp.bilinear_interpolate(im, x, y),
                                      jinterp.bilinear_interpolate(im, x, y))
    flow = _flow(16, 24, 7)
    got = tinterp.forward_interpolate(flow)
    np.testing.assert_array_equal(got, jinterp.forward_interpolate(flow))
    assert got.dtype == np.float32 and got.shape == flow.shape


# ---------------------------------------------------------------------------
# utils/vis.py
# ---------------------------------------------------------------------------

def test_flow_to_image_is_bit_equal():
    """The Baker wheel colouring, as ``tests/test_eval.py`` holds the JAX
    package's to the reference's: BGR, and clipped."""
    flow = np.random.default_rng(0).normal(0, 5, (32, 48, 2)).astype(
        np.float32)
    np.testing.assert_array_equal(tvis.baker_colorwheel(),
                                  jvis.baker_colorwheel())
    np.testing.assert_array_equal(
        tvis.flow_to_image(flow, convert_to_bgr=True),
        jvis.flow_to_image(flow, convert_to_bgr=True))
    np.testing.assert_array_equal(tvis.flow_to_image(flow, clip_flow=3.0),
                                  jvis.flow_to_image(flow, clip_flow=3.0))


def test_drawing_helpers_are_bit_equal(cv2):
    """The helpers the demo and the debug overlays draw with, on the same
    images: equal pixels."""
    img = textured(60, 80, seed=1)
    img2 = textured(60, 80, seed=2)
    mask = np.zeros((60, 80), np.uint8)
    mask[10:40, 20:70] = 255
    flow = np.random.default_rng(3).normal(0, 4, (60, 80, 2)).astype(
        np.float32)
    weights = np.random.default_rng(4).uniform(0, 1, (60, 80))
    colors = np.concatenate([tvis.cv2_colormap(weights, 0, 1).reshape(-1, 3),
                             (mask.reshape(-1, 1) > 0) * 255], axis=1)
    corners = np.array([[10.5, 60.2, 60.0, 10.0], [10.0, 12.0, 50.5, 48.0]])
    cases = [
        ("blend_mask", (img, mask), dict(fill=False, contour_thickness=2)),
        ("blend_mask", (img, mask), {}),
        ("cv2_colormap", (weights,), dict(vmin=0, vmax=1)),
        ("vis_alignment_plain", (img, img2), {}),
        ("vis_flow_align", (flow, img, img2),
         dict(grid_sz=10, arrow_color=colors, pt_radius=3, show_flow=False)),
        ("vis_flow_align", (flow, img, img2), dict(grid_sz=30)),
        ("vis_flow_arrows", (flow, img), dict(weights=weights)),
        ("name_fig", ([img, img2], ["a", "b"]), {}),
        ("griddify", ([img, img2, img], 2), {}),
        ("draw_corners", (img, corners, (0, 255, 0)), dict(with_tl=True)),
        ("vis_alignment", (img, img2, np.eye(3) + 0.01, (20, 10, 40, 25)),
         dict(margin=0.2)),
        ("vis_flow", (flow, img, img2), dict(grid_sz=10, arrow_color="rand")),
        ("cv2_colorbar", (img, 0.0, 1.0), {}),
        ("cv2_hatch", (img, mask > 0), {}),
        ("checkerboard", (12, 20), {}),
    ]
    for name, args, kwargs in cases:
        got = getattr(tvis, name)(*args, **kwargs)
        want = getattr(jvis, name)(*args, **kwargs)
        for g, w in zip(got if isinstance(got, (list, tuple)) else [got],
                        want if isinstance(want, (list, tuple)) else [want]):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_flow_gui_probe_matches_jax(cv2):
    img = textured(40, 50, seed=5)
    flow = _flow(40, 50, 8)
    mask = np.ones((40, 50))
    gt, gj = tvis.FlowGUI(img, img, flow, mask), jvis.FlowGUI(img, img, flow,
                                                               mask)
    for xy in ((10.3, 20.7), (49.0, 39.0), (60.0, 5.0)):
        (pt, vt), (pj, vj) = gt.probe(*xy), gj.probe(*xy)
        assert vt == vj
        _assert_nan_close(pt, pj)


# ---------------------------------------------------------------------------
# utils/io.py and utils/timing.py
# ---------------------------------------------------------------------------

def test_flow_png_reads_across_packages(cv2, tmp_path):
    flow = np.random.default_rng(9).uniform(-40, 40, (20, 30, 2))
    valid = (np.arange(600).reshape(20, 30) % 3 > 0).astype(np.float32)
    tio.write_flow_png(tmp_path / "t.png", flow, valid)
    jio.write_flow_png(tmp_path / "j.png", flow, valid)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png")\
        .read_bytes()
    for reader in (tio.read_flow_png, jio.read_flow_png):
        got, got_valid = reader(tmp_path / "t.png")
        np.testing.assert_array_equal(got_valid, valid)
        # the cast to uint16 truncates: 1/32 px steps, rounded down
        assert ((flow - got) >= -1e-9).all() and (flow - got).max() < 1 / 32


def test_frame_readers_and_writers_match_jax(cv2, tmp_path):
    frames = [textured(24, 32, seed=s) for s in range(3)]
    for pkg, io in (("t", tio), ("j", jio)):
        writer = io.VideoWriter(tmp_path / pkg)
        for f in frames:
            writer.write(f)
        writer.release()
    names = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert names == ["00000.jpg", "00001.jpg", "00002.jpg"]
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    for reverse in (False, True):
        ct = tio.GeneralVideoCapture(tmp_path / "t", reverse=reverse)
        cj = jio.GeneralVideoCapture(tmp_path / "t", reverse=reverse)
        while True:
            (okt, ft), (okj, fj) = ct.read(), cj.read()
            assert okt == okj
            if not okt:
                break
            np.testing.assert_array_equal(ft, fj)
            assert ct.frame_src == cj.frame_src
        ct.release()
    assert tio.get_frames(tmp_path / "t") == jio.get_frames(tmp_path / "t")
    mp4 = tmp_path / "clip.mp4"
    writer = tio.VideoWriter(mp4, fps=10)
    for f in frames:
        writer.write(f)
    writer.release()
    assert mp4.stat().st_size > 0


def test_frame_lookup_helpers_match_jax():
    assert (tio.video_seek_frame("01:02:03", fps=25)
            == jio.video_seek_frame("01:02:03", fps=25) == 25 * 3723)
    paths = [f"/clips/{i:05d}.jpg" for i in range(5, 40, 5)]
    assert tio.video_seek_frame_name(15, paths) == \
        jio.video_seek_frame_name(15, paths) == 2
    with pytest.raises(ValueError):
        tio.video_seek_frame_name(7, paths)


def test_lookahead_iter_matches_jax():
    for io in (tio, jio):
        it = io.LookaheadIter(range(5))
        la = it.lookahead()
        assert (next(la), next(la)) == (0, 1)
        assert next(it) == 0 and it.peek() == 1
        assert list(it) == [1, 2, 3, 4]
        assert it.peek("end") == "end"
        with pytest.raises(StopIteration):
            it.peek()


def test_pickle_loaders(tmp_path):
    blob = {"a": np.arange(4), "t": torch.arange(3.0)}
    (tmp_path / "x.pkl").write_bytes(pickle.dumps(blob))
    with gzip.open(tmp_path / "x.pklz", "wb") as f:
        f.write(pickle.dumps(blob))
    for name in ("x.pkl", "x.pklz"):
        got = tio.load_maybe_gzipped_pkl(tmp_path / name)
        np.testing.assert_array_equal(got["a"], blob["a"])
        assert torch.equal(got["t"], blob["t"])
    with pytest.raises(ValueError):
        tio.load_maybe_gzipped_pkl(tmp_path / "x.npz")
    with open(tmp_path / "x.pkl", "rb") as f:
        got = tio.CPU_Unpickler(f).load()
    assert torch.equal(got["t"], blob["t"])


def test_timing():
    t = ttiming.time_measurer("ms")
    time.sleep(0.01)
    assert 10 <= t() < 1000
    with ttiming.time_measurer("us") as t:
        pass
    assert t() >= 0


def test_cv2_users_name_themselves_without_cv2(monkeypatch, tmp_path):
    """Without OpenCV the host I/O and drawing raise, naming the function;
    nothing skips quietly."""
    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("No module named 'cv2'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    from woft_tpu_torch import pipeline
    from woft_tpu_torch.eval import pot

    img = np.zeros((8, 8, 3), np.uint8)
    (tmp_path / "0.jpg").write_bytes(b"")
    calls = {
        "GeneralVideoCapture": lambda: tio.GeneralVideoCapture(tmp_path),
        "read_flow_png": lambda: tio.read_flow_png(tmp_path / "0.png"),
        "VideoWriter": lambda: tio.VideoWriter(tmp_path / "o").write(img),
        "blend_mask": lambda: tvis.blend_mask(img, img[..., 0]),
        "vis_flow_align": lambda: tvis.vis_flow_align(
            np.zeros((8, 8, 2)), img, img),
        "mask_from_corners": lambda: pot.mask_from_corners(
            (8, 8), np.zeros((4, 2))),
        "evaluate_pot_sequence": lambda: pot.evaluate_pot_sequence(
            None, [tmp_path / "0.jpg"], np.zeros((1, 4, 2))),
        "_frame_source": lambda: next(pipeline._frame_source(tmp_path)),
    }
    for name, call in calls.items():
        with pytest.raises(ImportError, match=name):
            call()


def test_tmp_np_seed_matches_jax():
    """The same draws inside the block as ``woft_tpu``'s, numpy's global
    state restored after it, and ``None`` leaves the stream alone."""
    from woft_tpu.utils.random_utils import tmp_np_seed as jseed
    from woft_tpu_torch.utils import tmp_np_seed
    np.random.seed(5)
    before = np.random.get_state()[1].copy()
    with tmp_np_seed(42):
        got = np.random.rand(6)
    assert np.array_equal(np.random.get_state()[1], before)
    with jseed(42):
        want = np.random.rand(6)
    np.testing.assert_array_equal(got, want)
    with tmp_np_seed(None):
        a = np.random.rand(3)
    np.random.seed(5)
    np.testing.assert_array_equal(a, np.random.rand(3))


def test_sparse_exception_logger_matches_jax():
    """One line a distinct message, the OOM and missing-file spam folded
    by prefix, as the JAX class logs them."""
    import logging
    from woft_tpu.utils.logging_utils import SparseExceptionLogger as J
    from woft_tpu_torch.utils import SparseExceptionLogger as T

    errors = [RuntimeError("CUDA out of memory. Tried 2 GiB"),
              RuntimeError("CUDA out of memory. Tried 4 GiB"),
              FileNotFoundError(2, "No such file or directory", "a.png"),
              FileNotFoundError(2, "No such file or directory", "b.png"),
              ValueError("bad frame"), ValueError("bad frame"),
              KeyError("gt")]

    class Lines(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    out = {}
    for name, cls in (("jax", J), ("torch", T)):
        log = logging.getLogger(f"sparse_{name}")
        log.propagate = False
        handler = Lines()
        log.addHandler(handler)
        sparse = cls(log, extra_starts=("bad",))
        for e in errors:
            sparse("frame", e)
        log.removeHandler(handler)
        out[name] = handler.lines
    assert out["torch"] == out["jax"]
    assert len(out["torch"]) == 4


def test_send_notification_writes_the_file(tmp_path, monkeypatch):
    """``WOFT_NOTIFY_FILE`` receives the host-tagged line, as the JAX
    package's; ``with_notification`` reports a crash past its minimum
    runtime and re-raises."""
    import socket
    from woft_tpu.utils import notifications as jn
    from woft_tpu_torch.utils import send_notification, with_notification
    path = tmp_path / "notify.log"
    monkeypatch.delenv("WOFT_NOTIFY_CMD", raising=False)
    monkeypatch.setenv("WOFT_NOTIFY_FILE", str(path))
    assert send_notification("job done")
    assert jn.send_notification("job done")

    @with_notification(min_runtime_s=0.0)
    def crash():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        crash()
    lines = path.read_text().splitlines()
    tag = f"[{socket.gethostname()}] "
    assert lines[:2] == [tag + "job done"] * 2
    assert lines[2].startswith(tag + "crash crashed after")
    assert "RuntimeError('boom')" in lines[2]


def test_stage_timer_and_trace_step(tmp_path):
    """The program's stage spans (``span``, which replaced the stage
    timer) in ``trace_step``'s output: the step runs n times under
    ``torch.profiler``, each stage inside a span, and the Chrome trace
    written on the CPU holds the spans' ``woft.*`` names beside the
    operators; the recorder holds one tree a step."""
    import json
    from woft_tpu_torch.utils import (clear_spans, recorded_spans, span,
                                      trace_step)
    calls = []

    def step(x):
        calls.append(1)
        with span("woft.step"):
            with span("woft.fit"):
                return x @ x

    clear_spans()
    out = trace_step(step, (torch.ones(32, 32),), log_dir=str(tmp_path),
                     n=3)
    assert len(calls) == 3 and torch.equal(out, torch.full((32, 32), 32.0))
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert any(n and "matmul" in n for n in names)
    assert names.count("woft.step") == names.count("woft.fit") == 3
    spans = recorded_spans()
    clear_spans()
    assert len({s["frame"] for s in spans}) == 3
    assert [s["name"] for s in spans] == ["woft.step", "woft.fit"] * 3
