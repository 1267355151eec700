"""The port's shared-flow multi-target tracking against ``woft_tpu``'s on
the CPU: ``build_shared_multi_step`` on oracle flow (grouped fits, the
per-target ladder and the control target's pre-warp reset),
``SharedMultiTracker`` with the real network (dense float32 over a walk,
block-local bf16 on one frame with the JAX side's Pallas kernels in
interpret mode), and the batched pieces under it: the Sobol gather, TC
selection and inlier check over N targets, and kernel A's plain version
warping one source by N homographies.

Tolerance: per-frame H within 0.05 px at each target box's corners, the
bound of the other tracker tests; grouped and ungrouped fits, and a
target of the shared step against the single-target step on its mask,
to 1e-3 in the entries (the JAX package's own bound for the latter).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from test_torch_window import (CORNER_TOL, corner_err, textured, walk,
                               weights)  # noqa: F401  (fixture)

from woft_tpu.models import raft as jraft
from woft_tpu.ops import sampling as jsamp
from woft_tpu.tracker import woft as jw
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.ops import sampling as tsamp
from woft_tpu_torch.ops import warp as twarp
from woft_tpu_torch.pipeline import SharedMultiTracker
from woft_tpu_torch.tracker import woft as tw


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once, and torch's
    default of one intra-op thread a core makes this module's many small
    operations wait on each other's threads. Two threads while the module
    runs, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


H_IMG, W_IMG = 96, 128
BOXES = ((10, 40, 10, 50), (50, 90, 20, 60), (20, 70, 70, 120))  # y0,y1,x0,x1


def box_masks(boxes, h=H_IMG, w=W_IMG):
    masks = np.zeros((len(boxes), h, w), bool)
    for m, (y0, y1, x0, x1) in zip(masks, boxes):
        m[y0:y1, x0:x1] = True
    return masks


def box_corners(box):
    y0, y1, x0, x1 = box
    return np.array([[x0, x1 - 1, x1 - 1, x0], [y0, y0, y1 - 1, y1 - 1]],
                    float)


def tiny_flow(xp):
    """``tests/test_pipeline.py``'s deterministic near-zero flow."""
    def flow_fn(params, img1, img2, template_feats=None):
        H, W = img2.shape[1:3]
        if xp is torch:
            gy = torch.sin(torch.arange(H) / 17.0)[None, :, None, None]
            gx = torch.cos(torch.arange(W) / 13.0)[None, None, :, None]
            flow = 0.05 * torch.cat([gx + 0 * gy, gy + 0 * gx], -1)
            return flow * torch.ones(1, H, W, 2), torch.ones(1, H, W, 1)
        gy = jnp.sin(jnp.arange(H) / 17.0)[None, :, None, None]
        gx = jnp.cos(jnp.arange(W) / 13.0)[None, None, :, None]
        flow = 0.05 * jnp.concatenate([gx + 0 * gy, gy + 0 * gx], -1)
        return flow * jnp.ones((1, H, W, 2)), jnp.ones((1, H, W, 1))
    return flow_fn


def frames_np():
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (1, H_IMG, W_IMG, 3)).astype(np.float32)
    frame = rng.uniform(0, 255, (1, H_IMG, W_IMG, 3)).astype(np.float32)
    return base, frame


def torch_shared(tp, flow_fn, masks, base, frame):
    """One port shared step from the init state; -> (h_last, hs, meta)."""
    step = tw.build_shared_multi_step(traft.RaftConfig(iters=1), tp,
                                      flow_fn=flow_fn)
    state = tw.tracker_init_state(None, None, tp, torch.from_numpy(base),
                                  torch.from_numpy(masks[0]), encode=False)
    h_last = torch.eye(3).repeat(len(masks), 1, 1)
    _, h_last2, hs, meta = step(None, state, torch.from_numpy(masks),
                                h_last, torch.from_numpy(frame))
    return h_last2, hs, meta


@pytest.fixture(scope="module")
def shared_oracle():
    """The JAX and the port shared step on three masks, zero-ish oracle
    flow, ``redetection='always'``, ``no_local_h``."""
    from woft_tpu.tracker.woft import build_shared_multi_step

    base, frame = frames_np()
    masks = box_masks(BOXES)
    jtp = jw.TrackerParams(padding_mode="nopad", redetection="always",
                           no_local_h=True)
    jstep = build_shared_multi_step(jraft.RaftConfig(iters=1), jtp,
                                    flow_fn=tiny_flow(jnp))
    jstate = jw.tracker_init_state({}, None, jtp, jnp.asarray(base),
                                   jnp.asarray(masks[0]), encode=False)
    _, _, jhs, jmeta = jstep({}, jstate, jnp.asarray(masks.reshape(3, -1)),
                             jnp.tile(jnp.eye(3), (3, 1, 1)),
                             jnp.asarray(frame))
    ttp = tw.TrackerParams(redetection="always", no_local_h=True)
    _, hs, meta = torch_shared(ttp, tiny_flow(torch), masks, base, frame)
    return dict(base=base, frame=frame, masks=masks, ttp=ttp,
                jhs=np.asarray(jhs), jmeta=jmeta, hs=hs, meta=meta)


def test_shared_multi_step_matches_jax(shared_oracle):
    """Each target's H and check against the JAX step's."""
    hs, meta = shared_oracle["hs"], shared_oracle["meta"]
    assert hs.shape == (3, 3, 3)
    assert meta["global_H_success"].shape == meta["inlier_frac"].shape == (3,)
    np.testing.assert_array_equal(
        meta["global_H_success"].numpy(),
        np.asarray(shared_oracle["jmeta"]["global_H_success"]))
    np.testing.assert_allclose(meta["inlier_frac"].numpy(),
                               np.asarray(shared_oracle["jmeta"]
                                          ["inlier_frac"]), atol=1e-6)
    for t, box in enumerate(BOXES):
        assert corner_err(hs[t].numpy(), shared_oracle["jhs"][t],
                          box_corners(box)) < CORNER_TOL


def test_shared_multi_grouped_fits_equal_ungrouped(shared_oracle):
    """``multi_fit_chunk=2`` on 3 targets: two groups, the second padded
    with an all-False mask whose fit is dropped; the same H and checks."""
    tp = dataclasses.replace(shared_oracle["ttp"], multi_fit_chunk=2)
    _, hs_c, meta_c = torch_shared(tp, tiny_flow(torch),
                                   shared_oracle["masks"],
                                   shared_oracle["base"],
                                   shared_oracle["frame"])
    assert hs_c.shape == (3, 3, 3)
    np.testing.assert_allclose(hs_c.numpy(), shared_oracle["hs"].numpy(),
                               atol=1e-3)
    np.testing.assert_array_equal(
        meta_c["global_H_success"].numpy(),
        shared_oracle["meta"]["global_H_success"].numpy())


def test_shared_multi_target_equals_single_step(shared_oracle):
    """Target t equals ``build_track_step(no_local_h=True)`` on mask t:
    both see the same pre-warp (identity) and the same flow."""
    step = tw.build_track_step(traft.RaftConfig(iters=1),
                               shared_oracle["ttp"],
                               flow_fn=tiny_flow(torch))
    for t, mask in enumerate(shared_oracle["masks"]):
        state = tw.tracker_init_state(
            None, None, shared_oracle["ttp"],
            torch.from_numpy(shared_oracle["base"]), torch.from_numpy(mask),
            encode=False)
        _, h_ref, _ = step(None, state,
                           torch.from_numpy(shared_oracle["frame"]))
        np.testing.assert_allclose(shared_oracle["hs"][t].numpy(),
                                   h_ref.numpy(), atol=1e-3)


def test_shared_multi_needs_no_local_h():
    with pytest.raises(ValueError, match="local fallback"):
        tw.build_shared_multi_step(traft.RaftConfig(iters=1),
                                   tw.TrackerParams())


# the redetection ladder: frame 1 every target fits a translation; frame 2
# target 1's flow is garbage; frames 3-5 target 0's (the control's)
FAILING = (None, 1, 0, 0, 0)


def ladder_flow(t):
    """Frame t's oracle flow (numpy): a translation that grows with t
    everywhere, garbage inside the failing target's box."""
    shift = np.array([3.0 + t, -2.0 - 0.5 * t], np.float32)
    flow = np.broadcast_to(shift, (1, H_IMG, W_IMG, 2)).copy()
    k = FAILING[t]
    if k is not None:
        y0, y1, x0, x1 = BOXES[k]
        ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float32)
        key = xs * 131.0 + ys
        flow[0, y0:y1, x0:x1, 0] = np.sin(key * 12.9898) * 25.0
        flow[0, y0:y1, x0:x1, 1] = np.cos(key * 78.233) * 25.0
    return flow


def test_shared_multi_ladder_matches_jax():
    """A failed fit keeps that target's last H while the others move on;
    after ``no_prewarp_after_n`` (1) misses of target 0 in a row the shared
    pre-warp resets to the identity, in both packages."""
    from woft_tpu.tracker.woft import build_shared_multi_step

    rng = np.random.default_rng(5)
    base = rng.uniform(0, 255, (1, H_IMG, W_IMG, 3)).astype(np.float32)
    frames = rng.uniform(0, 255, (len(FAILING), 1, H_IMG, W_IMG, 3)
                         ).astype(np.float32)
    masks = box_masks(BOXES)
    ones = np.ones((1, H_IMG, W_IMG, 1), np.float32)
    kw = dict(redetection="inliers", no_local_h=True, no_prewarp_after_n=1)

    jtp = jw.TrackerParams(padding_mode="nopad", **kw)
    jstep = build_shared_multi_step(
        jraft.RaftConfig(iters=1), jtp,
        flow_fn=lambda p, i1, i2, tf=None: (p["flow"], p["w"]))
    jstate = jw.tracker_init_state({}, None, jtp, jnp.asarray(base),
                                   jnp.asarray(masks[0]), encode=False)
    jh_last = jnp.tile(jnp.eye(3), (3, 1, 1))

    prewarped = []

    def flow_fn(params, img1, img2, template_feats=None):
        prewarped.append(img2)
        return params["flow"], params["w"]

    ttp = tw.TrackerParams(**kw)
    tstep = tw.build_shared_multi_step(traft.RaftConfig(iters=1), ttp,
                                       flow_fn=flow_fn)
    tstate = tw.tracker_init_state(None, None, ttp, torch.from_numpy(base),
                                   torch.from_numpy(masks[0]), encode=False)
    th_last = torch.eye(3).repeat(3, 1, 1)
    tmasks = torch.from_numpy(masks)
    for t, failing in enumerate(FAILING):
        flow = ladder_flow(t)
        h_in = th_last.clone()
        jstate, jh_last, jhs, jmeta = jstep(
            {"flow": jnp.asarray(flow), "w": jnp.asarray(ones)}, jstate,
            jnp.asarray(masks.reshape(3, -1)), jh_last,
            jnp.asarray(frames[t]))
        tstate, th_last, ths, tmeta = tstep(
            {"flow": torch.from_numpy(flow), "w": torch.from_numpy(ones)},
            tstate, tmasks, th_last, torch.from_numpy(frames[t]))
        oks = tmeta["global_H_success"].numpy()
        np.testing.assert_array_equal(oks, [k != failing for k in range(3)])
        np.testing.assert_array_equal(oks,
                                      np.asarray(jmeta["global_H_success"]))
        assert int(tstate.n_lost) == int(jstate.n_lost)
        for k, box in enumerate(BOXES):
            assert corner_err(ths[k].numpy(), jhs[k],
                              box_corners(box)) < CORNER_TOL
            if k == failing:        # the failing target's H stays put
                assert torch.equal(ths[k], h_in[k])
            else:                   # the others move on
                assert not torch.allclose(ths[k], h_in[k])
    assert int(tstate.n_lost) == 3
    frame_t = [torch.from_numpy(f) for f in frames]
    # frames 3 and 4: pre-warped by the control's last good H (frame 2's)
    for t in (2, 3):
        assert not torch.equal(prewarped[t], frame_t[t])
    # frame 5: two misses in a row before it: the identity pre-warp
    assert torch.equal(prewarped[4], frame_t[4])


@pytest.mark.parametrize("impl", ["dense-float32", "local-bf16"])
def test_shared_multi_tracker_matches_jax(weights, impl):
    """``SharedMultiTracker`` with the real network against the JAX
    package's, the same seeded weights, three targets: dense float32 over
    a 3-frame walk, block-local bf16 (the JAX side's Pallas kernels in
    interpret mode) on one frame, 64 x 96 frames."""
    from test_corr_impls import _interpret_pallas
    from woft_tpu.ops.pallas import local_corr as plc
    from woft_tpu.ops.pallas import local_lookup as pll
    from woft_tpu.pipeline import SharedMultiTracker as JShared

    state_dict, jp, _ = weights
    local = impl == "local-bf16"
    precision = "bf16" if local else "highest"
    tcfg = traft.RaftConfig(iters=2, corr_impl="local" if local else "dense",
                            precision=precision)
    jcfg = jraft.RaftConfig(variant="weighted", iters=2,
                            corr_impl="local" if local else "onehot",
                            local_margin=tcfg.local_margin,
                            local_pallas=local, precision=precision)
    model = traft.init_raft_params(tcfg)
    model.load_state_dict(state_dict)
    boxes = ((8, 40, 12, 60), (24, 56, 40, 88), (4, 36, 56, 92))
    masks = box_masks(boxes, 64, 96)
    template = textured(64, 96, seed=4)
    frames, _ = walk(template, 1 if local else 3)

    tracker = SharedMultiTracker(model, tcfg, tw.TrackerParams(),
                                 device="cpu")
    tracker.init(template, masks)
    with _interpret_pallas(plc, pll):
        jtracker = JShared(jp, jcfg, jw.TrackerParams())
        jtracker.init(template, masks)
        for f in frames:
            hs, meta = tracker.track(f)
            jhs, jmeta = jtracker.track(f)
            assert hs.shape == (3, 3, 3) and np.isfinite(hs).all()
            np.testing.assert_array_equal(meta["global_H_success"],
                                          jmeta["global_H_success"])
            assert meta["global_H_success"].all()
            for k, box in enumerate(boxes):
                assert corner_err(hs[k], jhs[k],
                                  box_corners(box)) < CORNER_TOL


@pytest.mark.parametrize("density", [0.001, 0.05, 0.6])
def test_batched_sobol_gather_equals_rows(density):
    """(N, P) masks give each row's indices and validity as the JAX
    function on that row alone (sparse, fewer than 500, dense rows)."""
    rng = np.random.default_rng(7)
    valid = rng.uniform(size=(3, 4000)) < density
    valid[1] = rng.uniform(size=4000) < 0.3       # mixed regimes in a batch
    idx, ok = tsamp.masked_sobol_gather(torch.from_numpy(valid), 500)
    assert idx.shape == ok.shape == (3, 500)
    for t in range(3):
        j_idx, j_ok = jsamp.masked_sobol_gather(jnp.asarray(valid[t]), 500)
        np.testing.assert_array_equal(ok[t].numpy(), np.asarray(j_ok))
        np.testing.assert_array_equal(idx[t].numpy()[np.asarray(j_ok)],
                                      np.asarray(j_idx)[np.asarray(j_ok)])


def test_sparse_weights_batch_equals_rows():
    """``_sparse_point_weights`` for a batch of targets that asks for more
    cells than the grid has (the head evaluated at every cell, gathered)
    equals the sparse evaluation a target at a time, on one shared flow
    and on a flow a target."""
    g = torch.Generator().manual_seed(2)
    H1, W1 = 6, 10
    for B in (1, 3):
        logit_of = torch.randn(B * H1 * W1, generator=g)
        calls = []

        def head_at(rows):
            calls.append(rows.numel())
            return logit_of[rows] * 1.0

        up_mask = torch.randn(B, H1, W1, 576, generator=g)
        idx = torch.randint(0, 8 * H1 * 8 * W1, (3, 40), generator=g)
        got = tw._sparse_point_weights(head_at, up_mask, idx, 8 * W1, H1, W1)
        assert calls == [B * H1 * W1]        # 3 x 40 x 9 rows > the cells
        for t in range(3):
            b = t if B > 1 else 0            # target t's flow
            want = tw._sparse_point_weights(
                lambda r, b=b: logit_of[r + b * H1 * W1], up_mask[b:b + 1],
                idx[t:t + 1], 8 * W1, H1, W1)
            torch.testing.assert_close(got[t], want[0], rtol=0, atol=1e-6)


def test_batched_success_check_sums_per_target():
    """The inlier fraction of a batch sums each target's own points: a
    target with every point an inlier and one with none give 1 and 0,
    where sums over the whole batch would give 0.5 to both."""
    n = 50
    pts = torch.rand(2, n, 2) * 100
    shifted = pts.clone()
    shifted[1] += 50.0                            # target 1: all outliers
    H = torch.eye(3).repeat(2, 1, 1)
    ok, frac = tw._success_check(tw.TrackerParams(), H, pts, shifted,
                                 torch.ones(2, n))
    np.testing.assert_array_equal(frac.numpy(), [1.0, 0.0])
    np.testing.assert_array_equal(ok.numpy(), [True, False])


def test_plain_warp_one_source_n_homographies():
    """The plain warp (kernel A's plain version) of one source by N
    homographies equals N single warps, bilinear and nearest, and the
    pre-warp entry point takes the same broadcast."""
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.uniform(0, 255, (1, 48, 64, 3)).astype(
        np.float32))
    hs = torch.tensor([[[0.5, 0.0, 3.0], [0.0, 0.5, -2.0], [0, 0, 1]],
                       [[1.1, 0.1, -5.0], [-0.05, 0.9, 4.0], [1e-3, 0, 1]],
                       [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0, 0, 1]]],
                      dtype=torch.float32)
    for mode in ("bilinear", "nearest"):
        got = twarp.warp_perspective(src, hs, (32, 40), mode=mode)
        assert got.shape == (3, 32, 40, 3)
        for k in range(3):
            want = twarp.warp_perspective(src, hs[k], (32, 40), mode=mode)
            assert torch.equal(got[k], want[0])
    fast = twarp.warp_perspective_fast(src, hs, (32, 40))
    assert torch.equal(fast, twarp.warp_perspective(src, hs, (32, 40)))
    pts = torch.from_numpy(rng.uniform(-10, 70, (3, 200, 2)).astype(
        np.float32))
    batched = twarp.warp_validity_at(hs, (48, 64), pts)
    for k in range(3):
        assert torch.equal(batched[k],
                           twarp.warp_validity_at(hs[k], (48, 64), pts[k]))


def test_no_local_h_full_step_keeps_tensors():
    """With ``no_local_h`` the full-frame step returns tensors in ``meta``
    and in the state, never Python bools or ints; the default step keeps
    its host values."""
    base, frame = frames_np()
    mask = torch.from_numpy(box_masks(BOXES[:1])[0])
    for no_local_h in (True, False):
        tp = tw.TrackerParams(no_local_h=no_local_h)
        step = tw.build_track_step(traft.RaftConfig(iters=1), tp,
                                   flow_fn=tiny_flow(torch))
        state = tw.tracker_init_state(None, None, tp, torch.from_numpy(base),
                                      mask, encode=False)
        state, H, meta = step(None, state, torch.from_numpy(frame))
        kinds = {isinstance(v, torch.Tensor) for v in
                 (state.lost, state.n_lost, meta["global_H_success"],
                  meta["lost"], meta["N_lost"])}
        assert kinds == {no_local_h}
        assert bool(meta["global_H_success"])
