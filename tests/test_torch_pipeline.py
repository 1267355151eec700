"""The port's per-window multi-target tracker and chunk loops against
``woft_tpu``'s on the CPU: ``MultiTargetTracker`` (the batched window
step, one WeightedRAFT forward with B = N) against the JAX tracker's
``vmap``, the batch against the port's own single-target window step,
the three chunk loops against per-frame stepping (and the full-frame
chunk against the JAX chunk), their ``bgr_u8`` uploads, and the sparse
weight head at B > 1. The networks carry one seeded ``init_raft_params``
state across (``test_torch_window.py``'s fixture).

Tolerance: per-frame H within 0.05 px at each target box's corners, as
in the other tracker tests; a chunk against per-frame steps of the same
package to 1e-5 in the entries (the same operations); a batch against
single steps within 1e-3 px at the corners (the same operations, but a
convolution library may pick another algorithm for a batch of N, summing
in another order: 5e-5 px seen).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from test_torch_window import (CORNER_TOL, corner_err, textured, walk,
                               weights)  # noqa: F401  (fixture)

from woft_tpu.models import raft as jraft
from woft_tpu.tracker import window_step as jws
from woft_tpu.tracker import woft as jw
from woft_tpu_torch import pipeline as tpl
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.tracker import window_step as tws
from woft_tpu_torch.tracker import woft as tw

H_IMG, W_IMG = 96, 128
BOXES = ((30, 70, 40, 100), (10, 50, 8, 56))          # y0, y1, x0, x1
TOL = 1e-5
BATCH_TOL_PX = 1e-3


def box_corners(box):
    y0, y1, x0, x1 = box
    return np.array([[x0, x1 - 1, x1 - 1, x0], [y0, y0, y1 - 1, y1 - 1]],
                    float)


def box_masks(boxes, h=H_IMG, w=W_IMG):
    masks = np.zeros((len(boxes), h, w), bool)
    for m, (y0, y1, x0, x1) in zip(masks, boxes):
        m[y0:y1, x0:x1] = True
    return masks


@pytest.fixture(scope="module")
def dense(weights):
    """The port's model and config (dense float32, 2 iterations) on the
    shared seeded weights, the JAX twins, and a 3-frame walk (BGR uint8)
    at 96 x 128 with two targets."""
    state_dict, jp, _ = weights
    tcfg = traft.RaftConfig(iters=2)
    model = traft.init_raft_params(tcfg)
    model.load_state_dict(state_dict)
    jcfg = jraft.RaftConfig(variant="weighted", iters=2)
    template = textured(H_IMG, W_IMG, seed=2)
    frames, _ = walk(template, 3)
    return dict(model=model, tcfg=tcfg, jp=jp, jcfg=jcfg, template=template,
                frames=frames, masks=box_masks(BOXES))


WP = dict(size=64, margin=0.4, min_px=20)


def rgb(bgr):
    return torch.from_numpy(np.ascontiguousarray(
        bgr[..., ::-1]).astype(np.float32))[None]


def port_states(d, tp, wp):
    return tws.stack_window_states([
        tws.window_init_state(d["model"], d["tcfg"], tp, wp,
                              rgb(d["template"]), m) for m in d["masks"]])


def test_multi_target_tracker_matches_jax(dense):
    """``MultiTargetTracker`` against the JAX package's (``vmap`` of the
    window step) over a 3-frame walk, two targets, 64 x 64 windows."""
    from woft_tpu.pipeline import MultiTargetTracker as JMulti

    tracker = tpl.MultiTargetTracker(dense["model"], dense["tcfg"],
                                     tw.TrackerParams(),
                                     tws.WindowParams(**WP), device="cpu")
    jtracker = JMulti(dense["jp"], dense["jcfg"], jw.TrackerParams(),
                      jws.WindowParams(**WP))
    tracker.init(dense["template"], dense["masks"])
    jtracker.init(dense["template"], dense["masks"])
    for f in dense["frames"]:
        hs, meta = tracker.track(f)
        jhs, jmeta = jtracker.track(f)
        assert hs.shape == (2, 3, 3) and np.isfinite(hs).all()
        np.testing.assert_array_equal(meta["global_H_success"],
                                      jmeta["global_H_success"])
        np.testing.assert_array_equal(meta["N_lost"], jmeta["N_lost"])
        np.testing.assert_allclose(meta["h_crop"], jmeta["h_crop"],
                                   rtol=1e-4, atol=1e-4)
        for k, box in enumerate(BOXES):
            assert corner_err(hs[k], jhs[k], box_corners(box)) < CORNER_TOL


def test_window_batch_equals_single_steps(dense):
    """The batch (B = N forward) against the port's own single-target
    ``no_local_h`` window step, target by target, over the walk."""
    tp = tw.TrackerParams(no_local_h=True)
    wp = tws.WindowParams(**WP)
    batch = tws.build_window_batch_step(dense["tcfg"], tp, wp)
    single = tws.build_window_track_step(dense["tcfg"], tp, wp)
    states = port_states(dense, tp, wp)
    singles = [tws.window_init_state(dense["model"], dense["tcfg"], tp, wp,
                                     rgb(dense["template"]), m)
               for m in dense["masks"]]
    for f in dense["frames"]:
        states, hs, meta = batch(dense["model"], states, rgb(f))
        for k, box in enumerate(BOXES):
            singles[k], h, m = single(dense["model"], singles[k], rgb(f))
            assert corner_err(hs[k].numpy(), h.numpy(),
                              box_corners(box)) < BATCH_TOL_PX
            assert bool(meta["global_H_success"][k]) == bool(
                m["global_H_success"])
            assert int(meta["N_lost"][k]) == int(m["N_lost"])
            assert corner_err(states["h_last_good"][k].numpy(),
                              singles[k]["h_last_good"].numpy(),
                              box_corners(box)) < BATCH_TOL_PX


def test_batched_window_refuses_local_corr():
    """The batched window tracker takes the dense correlation only, and
    says so, rather than switching quietly."""
    cfg = traft.RaftConfig(corr_impl="local", precision="bf16")
    with pytest.raises(ValueError, match="corr_impl='dense'"):
        tws.build_window_batch_step(cfg, tw.TrackerParams(),
                                    tws.WindowParams(**WP))
    with pytest.raises(ValueError, match="corr_impl='dense'"):
        tpl.MultiTargetTracker(traft.init_raft_params(cfg), cfg,
                               tw.TrackerParams(), tws.WindowParams(**WP),
                               device="cpu")


def test_no_local_h_window_step_keeps_tensors(dense):
    """With ``no_local_h`` the window step returns tensors in ``meta`` and
    the state (no host sync); the default step keeps host values."""
    wp = tws.WindowParams(**WP)
    for no_local_h in (True, False):
        tp = tw.TrackerParams(no_local_h=no_local_h)
        step = tws.build_window_track_step(dense["tcfg"], tp, wp)
        state = tws.window_init_state(dense["model"], dense["tcfg"], tp, wp,
                                      rgb(dense["template"]),
                                      dense["masks"][0])
        state, H, meta = step(dense["model"], state, rgb(dense["frames"][0]))
        kinds = {isinstance(v, torch.Tensor) for v in
                 (state["lost"], state["n_lost"], meta["global_H_success"],
                  meta["lost"], meta["N_lost"])}
        assert kinds == {no_local_h}


def test_sparse_weight_head_batch_equals_single(dense):
    """``weight_head_at`` and ``up_mask`` of a B = 2 forward equal those of
    two B = 1 forwards (rows ``b*H1*W1 + cell``)."""
    model, cfg = dense["model"], dense["tcfg"]
    imgs = [rgb(f) for f in dense["frames"][:2]]
    feats = traft.encode_template(model, cfg, rgb(dense["template"]))
    both = traft.weighted_raft_forward(
        model, cfg, None, torch.cat(imgs), template_feats=tuple(
            torch.cat([f, f]) for f in feats), sparse_weight_head=True)
    cells = torch.tensor([0, 5, 17, 95, 40])
    n_cells = (H_IMG // 8) * (W_IMG // 8)
    for b, img in enumerate(imgs):
        one = traft.weighted_raft_forward(model, cfg, None, img,
                                          template_feats=feats,
                                          sparse_weight_head=True)
        np.testing.assert_allclose(
            both["weight_head_at"](cells + b * n_cells).numpy(),
            one["weight_head_at"](cells).numpy(), atol=TOL)
        np.testing.assert_allclose(both["up_mask"][b].numpy(),
                                   one["up_mask"][0].numpy(), atol=TOL)


def frames_chunk(d):
    """The walk as a (T, 1, H, W, 3) chunk: float32 RGB and BGR uint8."""
    bgr = np.stack(d["frames"])
    return (torch.from_numpy(np.ascontiguousarray(bgr[..., ::-1]).astype(
        np.float32))[:, None], torch.from_numpy(bgr)[:, None])


def test_multi_track_chunk_matches_per_frame(dense):
    """``build_multi_track_chunk`` equals per-frame batched steps, and its
    ``bgr_u8`` form (BGR uint8 uploads, converted on the device) equals
    the float32 chunk; ``MultiTargetTracker.track_chunk`` returns (T, N)
    arrays."""
    tp = tw.TrackerParams()
    wp = tws.WindowParams(**WP)
    f32, u8 = frames_chunk(dense)
    step = tws.build_window_batch_step(dense["tcfg"],
                                       tw.TrackerParams(no_local_h=True), wp)
    states = port_states(dense, dataclasses.replace(tp, no_local_h=True), wp)
    want = []
    for f in f32:
        states, hs, _ = step(dense["model"], states, f)
        want.append(hs)
    chunk = tpl.build_multi_track_chunk(dense["tcfg"], tp, wp)
    s_chk, hs_chk, meta = chunk(
        dense["model"],
        port_states(dense, dataclasses.replace(tp, no_local_h=True), wp), f32)
    assert hs_chk.shape == (3, 2, 3, 3)
    assert meta["global_H_success"].shape == (3, 2)
    np.testing.assert_allclose(hs_chk.numpy(), torch.stack(want).numpy(),
                               atol=TOL)
    for key in ("h_last_good", "n_lost", "prev_window"):
        np.testing.assert_allclose(s_chk[key].numpy(), states[key].numpy(),
                                   atol=TOL)
    chunk_u8 = tpl.build_multi_track_chunk(dense["tcfg"], tp, wp,
                                           bgr_u8=True)
    _, hs_u8, _ = chunk_u8(
        dense["model"],
        port_states(dense, dataclasses.replace(tp, no_local_h=True), wp), u8)
    assert torch.equal(hs_u8, hs_chk)

    tracker = tpl.MultiTargetTracker(dense["model"], dense["tcfg"], tp, wp,
                                     device="cpu")
    tracker.init(dense["template"], dense["masks"])
    hs_t, meta_t = tracker.track_chunk(np.stack(dense["frames"]))
    assert hs_t.shape == (3, 2, 3, 3) and meta_t["N_lost"].shape == (3, 2)
    np.testing.assert_allclose(hs_t, hs_chk.numpy(), atol=TOL)


def test_full_track_chunk_matches_jax_and_per_frame(dense):
    """``build_full_track_chunk`` (the full-frame step, ``no_local_h``)
    equals per-frame steps and its ``bgr_u8`` form, and matches the JAX
    package's chunk (``lax.scan``) within 0.05 px, target box of 40 x 60."""
    from woft_tpu.pipeline import build_full_track_chunk as jchunk

    box = BOXES[0]
    mask = box_masks((box,))[0]
    f32, u8 = frames_chunk(dense)
    template = rgb(dense["template"])
    tp = tw.TrackerParams()
    tp_nl = dataclasses.replace(tp, no_local_h=True)

    def init():
        return tw.tracker_init_state(dense["model"], dense["tcfg"], tp_nl,
                                     template, torch.from_numpy(mask))

    step = tw.build_track_step(dense["tcfg"], tp_nl)
    state, want = init(), []
    for f in f32:
        state, h, _ = step(dense["model"], state, f)
        want.append(h)
    chunk = tpl.build_full_track_chunk(dense["tcfg"], tp)
    s_chk, hs, meta = chunk(dense["model"], init(), f32)
    assert hs.shape == (3, 3, 3) and meta["global_H_success"].shape == (3,)
    np.testing.assert_allclose(hs.numpy(), torch.stack(want).numpy(),
                               atol=TOL)
    assert int(s_chk.n_lost) == int(state.n_lost)
    _, hs_u8, _ = tpl.build_full_track_chunk(dense["tcfg"], tp, bgr_u8=True)(
        dense["model"], init(), u8)
    assert torch.equal(hs_u8, hs)

    jtp = jw.TrackerParams()
    jstate = jw.tracker_init_state(dense["jp"], dense["jcfg"], jtp,
                                   jnp.asarray(template.numpy()),
                                   jnp.asarray(mask))
    _, jhs, jmeta = jchunk(dense["jcfg"], jtp)(dense["jp"], jstate,
                                               jnp.asarray(f32.numpy()))
    np.testing.assert_array_equal(meta["global_H_success"].numpy(),
                                  np.asarray(jmeta["global_H_success"]))
    for t in range(3):
        assert corner_err(hs[t].numpy(), np.asarray(jhs[t]),
                          box_corners(box)) < CORNER_TOL


def test_shared_multi_chunk_matches_per_frame(dense):
    """``build_shared_multi_chunk`` equals per-frame shared steps (real
    network, dense float32, two targets), its ``bgr_u8`` form equals the
    float32 chunk, and ``SharedMultiTracker.track_chunk`` returns the
    same (T, N) arrays."""
    tp = tw.TrackerParams(no_local_h=True)
    f32, u8 = frames_chunk(dense)
    masks = torch.from_numpy(dense["masks"]).reshape(2, -1)
    template = rgb(dense["template"])

    def init():
        return (tw.tracker_init_state(dense["model"], dense["tcfg"], tp,
                                      template, masks[0].reshape(H_IMG,
                                                                 W_IMG)),
                torch.eye(3).repeat(2, 1, 1))

    step = tw.build_shared_multi_step(dense["tcfg"], tp)
    (state, h_last), want = init(), []
    for f in f32:
        state, h_last, hs, _ = step(dense["model"], state, masks, h_last, f)
        want.append(hs)
    chunk = tpl.build_shared_multi_chunk(dense["tcfg"], tp)
    state0, h_last0 = init()
    _, h_last_c, hs_c, meta = chunk(dense["model"], state0, masks, h_last0,
                                    f32)
    assert hs_c.shape == (3, 2, 3, 3)
    assert meta["inlier_frac"].shape == (3, 2)
    np.testing.assert_allclose(hs_c.numpy(), torch.stack(want).numpy(),
                               atol=TOL)
    np.testing.assert_allclose(h_last_c.numpy(), h_last.numpy(), atol=TOL)
    state0, h_last0 = init()
    _, _, hs_u8, _ = tpl.build_shared_multi_chunk(
        dense["tcfg"], tp, bgr_u8=True)(dense["model"], state0, masks,
                                        h_last0, u8)
    assert torch.equal(hs_u8, hs_c)

    tracker = tpl.SharedMultiTracker(dense["model"], dense["tcfg"],
                                     tw.TrackerParams(), device="cpu")
    tracker.init(dense["template"], dense["masks"])
    hs_t, meta_t = tracker.track_chunk(np.stack(dense["frames"]))
    assert meta_t["global_H_success"].shape == (3, 2)
    np.testing.assert_allclose(hs_t, hs_c.numpy(), atol=TOL)
