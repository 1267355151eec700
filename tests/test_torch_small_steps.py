"""RAFT-small (``RaftConfig(small=True)``, 'weighted') through the
full-frame tracker steps against ``woft_tpu``'s on the CPU: the single step
(``build_track_step``), the shared-flow step x2 (``SharedMultiTracker``),
and a ``train_wraft_torch.py --small`` checkpoint served by ``WOFT.py``'s
config with ``class_params.small`` set. The window steps are in
``test_torch_small_window.py``, which takes its inputs from here.

RAFT-small has no convex-upsampling mask, so every step takes the dense
weight head under ``WOFT.py``'s ``nopad`` and ``sparse_weights``, as the
reference's does (before that gate the port's steps asked for the sparse
head and the forward raised ``ValueError``).

One set of seeded weights (the port's ``init_raft_params``, with the
trainer's one-layer 32-channel weight head) is carried across by
``params_to_jax_numpy`` (the JAX package's eager initialisation of the
same network takes 18 s); 96x128 frames of a homography walk, 2
iterations. The networks are untrained, so the flows are poor and the
checks may fail: what is held is agreement, per-frame H within 0.05 px
(``CORNER_TOL``) at each target box's corners and equal ok flags.
"""

import logging
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_window import CORNER_TOL, corner_err, textured, walk

import train_wraft_torch
from woft_tpu.models import raft as jraft
from woft_tpu.models.convert import load_torch_checkpoint
from woft_tpu.pipeline import SharedMultiTracker as JShared
from woft_tpu.tracker import woft as jw
from woft_tpu_torch.config import load_config
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_to_jax_numpy
from woft_tpu_torch.pipeline import SharedMultiTracker
from woft_tpu_torch.tracker import woft as tw

ROOT = Path(__file__).resolve().parent.parent
HEAD = ((32, 3),)              # the weight head ``--small`` trains
ITERS = 2
H_IMG, W_IMG = 96, 128
BOXES = ((24, 72, 32, 96), (8, 56, 56, 120))       # y0, y1, x0, x1


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs; the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def box_masks(boxes=BOXES):
    masks = np.zeros((len(boxes), H_IMG, W_IMG), bool)
    for m, (y0, y1, x0, x1) in zip(masks, boxes):
        m[y0:y1, x0:x1] = True
    return masks


def box_corners(box):
    y0, y1, x0, x1 = box
    return np.array([[x0, x1 - 1, x1 - 1, x0], [y0, y0, y1 - 1, y1 - 1]],
                    float)


def rgb(bgr):
    """(1, H, W, 3) float32 RGB numpy frame of a BGR uint8 one."""
    return np.ascontiguousarray(bgr[..., ::-1]).astype(np.float32)[None]


@pytest.fixture(scope="module")
def small():
    """The configs, the port's seeded model and its JAX tree, and a 3-frame
    walk (BGR uint8) from a textured template."""
    kw = dict(small=True, variant="weighted", iters=ITERS,
              weight_head_structure=HEAD)
    jcfg, tcfg = jraft.RaftConfig(**kw), traft.RaftConfig(**kw)
    model = traft.init_raft_params(tcfg, seed=5)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                params_to_jax_numpy(model.state_dict()))
    template = textured(H_IMG, W_IMG, seed=2)
    frames, _ = walk(template, 3)
    return SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, model=model,
                           template=template, frames=frames)


def _held(ok_t, ok_j, Ht, Hj, box):
    assert np.isfinite(Ht).all()
    assert bool(ok_t) == bool(ok_j)
    assert corner_err(Ht, Hj, box_corners(box)) < CORNER_TOL


def test_single_step_matches_jax(small):
    """``build_track_step`` under ``WOFT.py``'s tracker parameters with
    ``redetection='never'``, so that every frame runs both flows on the
    dense head: the main one (``H_global_cur2init``, its check then
    failing) and the local fallback on padded inputs, whose H the step
    returns. (The untrained network's flow passes its own check on this
    walk, so the default ladder would not reach the fallback; the round
    trip below runs the default one.)"""
    mask = box_masks()[0]
    tp = tw.TrackerParams(redetection="never")
    jtp = jw.TrackerParams(redetection="never")
    tstep = tw.build_track_step(small.tcfg, tp)
    jstep = jw.build_track_step(small.jcfg, jtp)
    tstate = tw.tracker_init_state(small.model, small.tcfg, tp,
                                   torch.from_numpy(rgb(small.template)),
                                   torch.from_numpy(mask))
    jstate = jw.tracker_init_state(small.jp, small.jcfg, jtp,
                                   jnp.asarray(rgb(small.template)),
                                   jnp.asarray(mask))
    for f in small.frames:
        # a fresh frame buffer each call: the jitted JAX step donates its
        # state, which holds the previous frame
        tstate, Ht, mt = tstep(small.model, tstate,
                               torch.from_numpy(rgb(f)))
        jstate, Hj, mj = jstep(small.jp, jstate, jnp.asarray(rgb(f)))
        _held(mt["global_H_success"], mj["global_H_success"], Ht.numpy(),
              np.asarray(Hj), BOXES[0])
        assert corner_err(mt["H_global_cur2init"].numpy(),
                          np.asarray(mj["H_global_cur2init"]),
                          box_corners(BOXES[0])) < CORNER_TOL
        assert mt["N_lost"] == int(mj["N_lost"])


def test_shared_step_matches_jax(small):
    """``SharedMultiTracker`` with two targets: one RAFT-small flow a frame,
    the dense head, each target's fit against the JAX package's."""
    masks = box_masks()
    tracker = SharedMultiTracker(small.model, small.tcfg, tw.TrackerParams(),
                                 device="cpu")
    jtracker = JShared(small.jp, small.jcfg, jw.TrackerParams())
    tracker.init(small.template, masks)
    jtracker.init(small.template, masks)
    for f in small.frames:
        hs, meta = tracker.track(f)
        jhs, jmeta = jtracker.track(f)
        assert hs.shape == (2, 3, 3)
        for k, box in enumerate(BOXES):
            _held(meta["global_H_success"][k], jmeta["global_H_success"][k],
                  hs[k], jhs[k], box)


def _train_small(tmp_path, monkeypatch):
    """Two ``--small --train-flow`` steps on the CPU at 32x32, batch 1,
    one iteration; the checkpoint's path."""
    import cv2
    images = tmp_path / "imgs"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(images / f"{i}.png"),
                    rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    out = tmp_path / "small.pt"
    monkeypatch.setattr(sys, "argv", [
        "train_wraft_torch.py", "--images", str(images), "--size", "32x32",
        "--batch", "1", "--steps", "2", "--iters", "1", "--small",
        "--train-flow", "--log-every", "1", "--out", str(out),
        "--device", "cpu"])
    assert train_wraft_torch.main() == 0
    return out


def test_small_checkpoint_tracks_in_both(small, tmp_path, monkeypatch,
                                         caplog):
    """The round trip: a ``train_wraft_torch.py --small`` checkpoint, named
    by ``WOFT_WRAFT_TORCH_CKPT``, loads strictly (no partial-match warning)
    into ``WOFT.py``'s flow config with ``class_params.small`` set, whose
    three 128-channel head layers give way to the checkpoint's one
    32-channel layer; ``WOFTTracker`` tracks a frame with it. The JAX
    package reads the same file (``load_torch_checkpoint``) and its step,
    whose head structure comes from its config alone, gives the same H."""
    out = _train_small(tmp_path, monkeypatch)
    monkeypatch.setenv("WOFT_WRAFT_TORCH_CKPT", str(out))
    conf = load_config(ROOT / "woft_tpu_torch" / "configs" / "WOFT.py")
    conf.flow_config.class_params.small = True
    conf.flow_config.iters = ITERS
    assert Path(conf.flow_config.model) == out
    with caplog.at_level(logging.INFO, logger="woft_tpu_torch"):
        tracker = tw.WOFTTracker(conf, device="cpu")
    assert "partial match" not in caplog.text
    assert "has the weight head ((32, 3),)" in caplog.text
    assert tracker.raft_cfg == small.tcfg
    state = torch.load(str(out), weights_only=True)
    own = tracker.flower.model.state_dict()
    assert set(own) == set(state)
    assert all(torch.equal(own[k], v) for k, v in state.items())

    mask = box_masks()[0]
    tracker.init(small.template, mask)
    H, meta = tracker.track(small.frames[0])

    jp = jax.tree_util.tree_map(jnp.asarray, load_torch_checkpoint(str(out)))
    jstate = jw.tracker_init_state(jp, small.jcfg, jw.TrackerParams(),
                                   jnp.asarray(rgb(small.template)),
                                   jnp.asarray(mask))
    jstep = jw.build_track_step(small.jcfg, jw.TrackerParams())
    _, Hj, mj = jstep(jp, jstate, jnp.asarray(rgb(small.frames[0])))
    _held(meta.global_H_success, mj["global_H_success"], H, np.asarray(Hj),
          BOXES[0])
