"""The port's entry points against ``woft_tpu``'s on the CPU: the repaired
reference API (``track(debug=...)``, ``compute_flow(vis=...,
src_img_identifier=...)``), the flow cache, the streaming loop
``track_video`` and its frame source, ``WOFT_demo_torch.py`` and
``eval_woft_torch.py``.

Tolerances: ``track_video`` within 0.05 px at the target's corners of
``woft_tpu.pipeline.track_video`` on a directory of pngs (lossless, so
both packages decode the same pixels; a jpg directory takes the JAX
package's native decoder where it is built), the uint8 upload within 1e-6
of the float32 one, ``sync_every`` 1 and 8 equal; a cached flow returned
as its float16 values exactly, in either package. The scripts run on a
tiny port config (2 iterations, one 32-channel weight-head layer) on
96x128 frames.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.flow import cache as jcache
from woft_tpu.geometry import np_h_proj
from woft_tpu.tracker import woft as jw
from woft_tpu.tracker import window_step as jws
from woft_tpu_torch import pipeline as tpipe
from woft_tpu_torch.config import load_config
from woft_tpu_torch.flow import cache as tcache
from woft_tpu_torch.flow.wrapper import RaftFlow
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_to_jax_numpy
from woft_tpu_torch.tracker import window as twin
from woft_tpu_torch.tracker import window_step as tws
from woft_tpu_torch.tracker import woft as tw

from test_torch_tracker import CORNER_TOL
from test_torch_window import textured, walk

ROOT = Path(__file__).resolve().parent.parent
H_IMG, W_IMG = 96, 128
CORNERS = np.array([[32, 95, 95, 32], [24, 24, 71, 71]], float)
UINT8_TOL = 1e-6

TINY_CONFIG = """
import sys
sys.path.insert(0, {root!r})
from {pkg}.config import Config
from {pkg}.tracker import TrackerParams, WOFTTracker


def get_config():
    conf = Config()
    conf.tracker_class = WOFTTracker
    flow = Config()
    from {pkg}.flow.wrapper import RaftFlow
    flow.of_class = RaftFlow
    flow.raft_type = "weighted"
    flow.class_params = Config()
    flow.class_params.small = False
    flow.class_params.weight_head_structure = [(32, 3)]
    flow.iters = 2
    flow.padding_mode = "nopad"
    conf.flow_config = flow
    conf.tracker_params = TrackerParams(padding_mode="nopad",
                                        subsample_n=100)
    return conf
"""


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several worker processes run the suite at once; two intra-op
    threads while this module runs, the count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def clip(cv2, tmp_path_factory):
    """A 6-frame 96x128 walk as jpgs and as pngs, with its template mask."""
    template = textured(H_IMG, W_IMG, seed=1)
    frames, _ = walk(template, 5, step=(1.0, -0.5))
    root = tmp_path_factory.mktemp("clip")
    for ext in ("jpg", "png"):
        (root / ext).mkdir()
        for i, f in enumerate([template] + frames):
            cv2.imwrite(str(root / ext / f"{i:04d}.{ext}"), f)
    mask = np.zeros((H_IMG, W_IMG), bool)
    mask[24:72, 32:96] = True
    return root, mask


@pytest.fixture(scope="module")
def tiny_configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("configs")
    out = {}
    for pkg in ("woft_tpu_torch", "woft_tpu"):
        out[pkg] = d / f"tiny_{pkg}.py"
        out[pkg].write_text(TINY_CONFIG.format(root=str(ROOT), pkg=pkg))
    return out


# ---------------------------------------------------------------------------
# the repaired reference API
# ---------------------------------------------------------------------------

def test_track_takes_debug_by_keyword_and_position(clip, tiny_configs):
    """``WOFTTracker.track(input_img, debug=False, img_identifier=None)``:
    ``debug`` by keyword and by position; with it the four overlays come
    back as BGR images of the frame's height."""
    tracker = tw.WOFTTracker(load_config(tiny_configs["woft_tpu_torch"]),
                             device="cpu")
    template = textured(H_IMG, W_IMG, seed=1)
    frames, _ = walk(template, 2)
    tracker.init(template, clip[1])
    H1, meta1 = tracker.track(frames[0], debug=True)
    H2, meta2 = tracker.track(frames[1], False, ("seq", 0, 1))
    assert not hasattr(meta2, "debug_vis")
    assert set(meta1.debug_vis) == {"pw_flow", "local_flow", "composition",
                                    "template_points"}
    for name, im in meta1.debug_vis.items():
        assert im.dtype == np.uint8 and im.ndim == 3 and im.std() > 0, name
        assert im.shape[0] in (H_IMG, 3 * H_IMG), name
    assert meta1.debug_vis["pw_flow"].shape == (H_IMG, 2 * W_IMG, 3)
    H3, meta3 = tracker.track(frames[1], True)
    assert hasattr(meta3, "debug_vis") and np.isfinite(H3).all()


def test_window_track_takes_debug_and_draws_nothing():
    conf = load_config(ROOT / "woft_tpu_torch" / "configs" / "WOFT_window.py")
    conf.flow_config.iters = 1
    conf.window_size = 64
    tracker = twin.WOFTWindowTracker(conf, device="cpu")
    template = textured(H_IMG, W_IMG, seed=2)
    frames, _ = walk(template, 2)
    mask = np.zeros((H_IMG, W_IMG), np.uint8)
    mask[30:70, 40:90] = 1
    tracker.init(template, mask)
    for args, kwargs in (((True,), {}), ((), dict(debug=True,
                                                   img_identifier=None))):
        H, meta = tracker.track(frames[0], *args, **kwargs)
        assert np.isfinite(H).all() and not hasattr(meta, "debug_vis")


def test_compute_flow_takes_vis_and_identifier(tiny_configs):
    """``compute_flow(src, dst, mode, vis, src_img_identifier, numpy_out,
    do_sigmoid)`` in the reference's order; ``vis`` changes nothing, and
    an identifier without a cache directory computes the flow."""
    flower = RaftFlow(load_config(tiny_configs["woft_tpu_torch"]).flow_config,
                      device="cpu")
    a, b = textured(64, 96, seed=3), textured(64, 96, seed=4)
    want = flower.compute_flow(a, b, "flow", numpy_out=True)
    for got in (flower.compute_flow(a, b, "flow", True, ("d", "s", 0), True),
                flower.compute_flow(a, b, mode="flow", vis=True,
                                    src_img_identifier=("d", "s", 0),
                                    numpy_out=True, do_sigmoid=False)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the flow cache
# ---------------------------------------------------------------------------

def test_cache_files_read_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    flow = rng.normal(0, 4, (12, 20, 2)).astype(np.float32)
    weights = rng.normal(0, 2, (12, 20)).astype(np.float32)
    ident = ("synthetic", "seq01", 7)
    img = textured(12, 20, seed=6)
    for writer, reader in ((tcache.FlowCache(tmp_path / "t"),
                            jcache.FlowCache(tmp_path / "t")),
                           (jcache.FlowCache(tmp_path / "j"),
                            tcache.FlowCache(tmp_path / "j"))):
        path = writer.store(ident, flow, weights)
        assert path.name == "7-8.npz" and path.parent.name == "seq01"
        f, w = reader.load(img, ident)
        np.testing.assert_array_equal(f, flow.astype(np.float16))
        np.testing.assert_array_equal(w, weights.astype(np.float16))
    # the reference's own layout: (2, H, W) flow and (1, H, W) weights
    ref = tmp_path / "r" / "synthetic" / "seq01" / "7-8.npz"
    ref.parent.mkdir(parents=True)
    np.savez(ref, half_flow=flow.transpose(2, 0, 1).astype(np.float16),
             half_weights=weights[None].astype(np.float16))
    for cache in (tcache.FlowCache(tmp_path / "r"),
                  jcache.FlowCache(tmp_path / "r")):
        f, w = cache.load(img, ident)
        np.testing.assert_array_equal(f, flow.astype(np.float16))
        np.testing.assert_array_equal(w, weights.astype(np.float16))
    assert tcache.identify_image(img) == jcache.identify_image(img)
    with pytest.raises(FileNotFoundError):
        tcache.FlowCache(tmp_path / "t").load(img, ("synthetic", "seq01", 8))


def test_compute_flow_reads_the_cache(tiny_configs, tmp_path):
    """On a hit ``compute_flow`` returns the cached float16 values (the
    weights through ``weights_postprocessing_fn`` and the sigmoid), in
    both modes, as the JAX wrapper does; a miss computes the flow."""
    from woft_tpu.config import load_config as jload_config

    rng = np.random.default_rng(8)
    flow = rng.normal(0, 4, (64, 96, 2)).astype(np.float32)
    weights = rng.normal(0, 2, (64, 96)).astype(np.float32)
    a, b = textured(64, 96, seed=3), textured(64, 96, seed=4)
    tcache.FlowCache(tmp_path).store(("d", "s", 3), flow, weights)
    f16, w16 = flow.astype(np.float16), weights.astype(np.float16)

    conf = load_config(tiny_configs["woft_tpu_torch"]).flow_config
    conf.flow_cache_dir = tmp_path
    conf.weights_postprocessing_fn = lambda w: 2.0 * w
    flower = RaftFlow(conf, device="cpu")
    jconf = jload_config(tiny_configs["woft_tpu"]).flow_config
    jconf.flow_cache_dir = tmp_path
    jconf.weights_postprocessing_fn = lambda w: 2.0 * w
    jflower = jconf.of_class(jconf)

    kw = dict(src_img_identifier=("d", "s", 3), numpy_out=True)
    fl, wt = flower.compute_flow(a, b, "flow", **kw)
    np.testing.assert_array_equal(fl, f16.astype(np.float32).transpose(2, 0, 1))
    np.testing.assert_array_equal(wt, 2.0 * w16.astype(np.float32))
    for mode in ("flow", "TC"):
        got = flower.compute_flow(a, b, mode, do_sigmoid=True, **kw)
        want = jflower.compute_flow(a, b, mode, do_sigmoid=True, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    miss = flower.compute_flow(a, b, "flow", src_img_identifier=("d", "s", 4),
                               numpy_out=True)
    conf.flow_cache_dir = None
    for g, w in zip(miss, flower.compute_flow(a, b, "flow", numpy_out=True)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# track_video and its frame source
# ---------------------------------------------------------------------------

def test_frame_source_decodes_in_order_as_rgb(clip, cv2):
    root, _ = clip
    want = [cv2.imread(str(p))[:, :, ::-1]
            for p in sorted((root / "jpg").iterdir())]
    for as_uint8 in (False, True):
        got = list(tpipe._frame_source(root / "jpg", n_threads=3, prefetch=2,
                                       as_uint8=as_uint8))
        assert tpipe.LAST_SOURCE == "threaded"
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == (np.uint8 if as_uint8 else np.float32)
            assert g.flags.c_contiguous
            np.testing.assert_array_equal(g, w)
    got = list(tpipe._frame_source(root / "png"))
    assert tpipe.LAST_SOURCE == "cv2" and len(got) == len(want)
    source = tpipe._frame_source(root / "jpg", n_threads=2, prefetch=4)
    next(source)
    source.close()                     # cancels the decodes not yet started


def test_frame_source_raises_on_an_undecodable_jpg(tmp_path):
    (tmp_path / "0000.jpg").write_bytes(b"not a jpeg")
    with pytest.raises(OSError, match="cannot decode"):
        next(tpipe._frame_source(tmp_path))


def test_track_video_matches_jax(clip):
    """``track_video`` on the png clip against ``woft_tpu``'s, both on one
    set of seeded weights, 1 iteration, the device step under
    ``no_local_h`` as in the JAX package's tests (with the dense weight
    head); the uint8 upload, the fetch cadence and ``max_frames``."""
    from woft_tpu.models.raft import RaftConfig as JRaftConfig
    from woft_tpu.pipeline import track_video as jtrack_video

    root, mask = clip
    cfg = traft.RaftConfig(iters=1)
    model = traft.init_raft_params(cfg, seed=3)
    params = jax.tree_util.tree_map(
        jnp.asarray, params_to_jax_numpy(model.state_dict()))
    # the dense weight head: the sparse head's patch convolutions cost
    # seconds a frame on the CPU, and this test is about the streaming loop
    kw = dict(redetection="always", no_local_h=True, sparse_weights=False)
    tp = tw.TrackerParams(**kw)
    wp = tws.window_params_for_mask(mask, size=64, min_px=20.0)
    jtp = jw.TrackerParams(**kw)
    jwp = jws.window_params_for_mask(mask, size=64, min_px=20.0)

    hs = tpipe.track_video(model, cfg, tp, wp, root / "png", mask)
    assert tpipe.LAST_SOURCE == "cv2"
    hj = jtrack_video(params, JRaftConfig(iters=1), jtp, jwp, root / "png",
                      mask)
    assert hs.shape == hj.shape == (6, 3, 3) and hs.dtype == np.float64
    np.testing.assert_array_equal(hs[0], np.eye(3))
    err = max(np.linalg.norm(np_h_proj(a, CORNERS) - np_h_proj(b, CORNERS),
                             axis=0).max() for a, b in zip(hs, hj))
    assert err < CORNER_TOL

    hu = tpipe.track_video(model, cfg, tp, wp, root / "png", mask,
                           uint8_upload=True, sync_every=1)
    np.testing.assert_allclose(hu, hs, rtol=0, atol=UINT8_TOL)
    h8 = tpipe.track_video(model, cfg, tp, wp, root / "jpg", mask,
                           sync_every=8)
    assert tpipe.LAST_SOURCE == "threaded"
    h1 = tpipe.track_video(model, cfg, tp, wp, root / "jpg", mask,
                           sync_every=1, max_frames=4)
    assert h1.shape == (4, 3, 3)
    np.testing.assert_array_equal(h1, h8[:4])


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------

def test_demo_headless_debug(clip, tiny_configs, tmp_path):
    """``WOFT_demo_torch.py --device cpu --headless --debug`` on the jpg
    clip: the overlays, the four debug images a frame, and a
    ``homographies.npz`` that ``woft_tpu``'s POT reader takes; then
    ``eval_woft_torch.py --pot-ref`` scores the run."""
    import cv2
    from woft_tpu.eval.pot import corners_from_homographies

    root, _ = clip
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "WOFT_demo_torch.py"), str(root / "jpg"),
         "--headless", "--out", str(out), "--config",
         str(tiny_configs["woft_tpu_torch"]), "--bbox", "30,20,60,50",
         "--max-frames", "3", "--debug", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path),
             "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Tracker exception" not in proc.stderr
    ref = np.load(out / "homographies.npz")
    assert ref["H"].shape == (3, 3, 3) and np.isfinite(ref["H"]).all()
    np.testing.assert_array_equal(ref["corners"], [[30, 20], [90, 20],
                                                   [90, 70], [30, 70]])
    corners = corners_from_homographies(ref["H"], ref["corners"])
    assert corners.shape == (3, 4, 2) and np.isfinite(corners).all()
    for i in range(3):
        im = cv2.imread(str(out / f"{i:05d}.jpg"))
        assert im.shape == (H_IMG, W_IMG, 3)
        for name in ("pw_flow", "local_flow", "composition",
                     "template_points"):
            im = cv2.imread(str(out / f"{i + 1:05d}_debug_{name}.jpg"))
            assert im is not None and im.std() > 0, (i, name)

    metrics = _run_main(ROOT / "eval_woft_torch.py", [
        "--images", str(root / "jpg"), "--config",
        str(tiny_configs["woft_tpu_torch"]), "--pot-ref",
        str(out / "homographies.npz"), "--frames", "3", "--device", "cpu"])
    assert metrics["frames"] == 3 and np.isfinite(metrics["mean_px"])


def _run_main(script, argv, env=None):
    """Run a root script's ``main`` in this process; -> its JSON line."""
    import contextlib
    import io
    import os

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        spec = importlib.util.spec_from_file_location(script.stem, script)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        buf = io.StringIO()
        saved = sys.argv
        sys.argv = [str(script)] + argv
        try:
            with contextlib.redirect_stdout(buf):
                rc = (module.main(argv) if script.stem.endswith("_torch")
                      else module.main())
        finally:
            sys.argv = saved
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_eval_prints_the_reference_keys(clip, tiny_configs):
    """``eval_woft_torch.py --device cpu`` and ``eval_woft.py`` on the same
    base frame and tiny config: the same JSON keys, the same counts."""
    root, _ = clip
    argv = ["--images", str(root / "png"), "--frames", "3", "--seqs", "1"]
    got = _run_main(ROOT / "eval_woft_torch.py", argv + [
        "--config", str(tiny_configs["woft_tpu_torch"]), "--device", "cpu"])
    want = _run_main(ROOT / "eval_woft.py", argv + [
        "--config", str(tiny_configs["woft_tpu"])], env={"WOFT_CPU": "1"})
    assert list(got) == list(want)
    assert got["seqs"] == want["seqs"] == 1
    assert got["frames"] == want["frames"] == 3
    assert all(np.isfinite(v) for v in got.values())
