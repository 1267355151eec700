"""The port's tracker against ``woft_tpu``'s on the CPU.

Oracle flow enters through the ``flow_fn`` seam of ``build_track_step``, so
these tests run the whole step — pre-warp, TC validity, Sobol-500 gather,
weighted-QR fit, inlier check, fallback and lost-counter ladder — on
controlled flow. Tolerance: projected template corners within 0.05 px of
the JAX tracker's and of the truth (float32 QR fits of 500 points in two
libraries). One test runs the real WeightedRAFT (sparse head on the main
flow, dense head on the fallback flow) in both packages with the same
weights, and one walks both packages' ``WOFT_fast`` trackers (block-local
correlation; the JAX side's Pallas kernels in interpret mode) over a
homography walk, in float32 and in bf16.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.geometry import np_h_proj
from woft_tpu.models import raft as jraft
from woft_tpu.tracker import woft as jw
from woft_tpu_torch.config import load_config
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_to_jax_numpy
from woft_tpu_torch.ops.warp import warp_perspective
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


ROOT = Path(__file__).resolve().parent.parent
H_IMG, W_IMG = 96, 128
CORNERS = np.array([[32, 24], [96, 24], [96, 72], [32, 72]], float).T
CORNER_TOL = 0.05


def template_frame():
    return np.random.default_rng(0).uniform(
        0, 255, (H_IMG, W_IMG, 3)).astype(np.float32)


def target_mask():
    mask = np.zeros((H_IMG, W_IMG), bool)
    mask[24:72, 32:96] = True
    return mask


def corner_err(Ha, Hb):
    return np.linalg.norm(np_h_proj(np.asarray(Ha, np.float64), CORNERS)
                          - np_h_proj(np.asarray(Hb, np.float64), CORNERS),
                          axis=0).max()


def homography_flow(h, xp):
    """Flow template -> observed for the template->observed map ``h``, with
    weights varying from 0.2 to 1 over the columns."""
    if xp is torch:
        i = torch.arange(H_IMG * W_IMG)
        src = torch.stack([(i % W_IMG).float(), (i // W_IMG).float(),
                           torch.ones(H_IMG * W_IMG)])
    else:
        i = jnp.arange(H_IMG * W_IMG)
        src = jnp.stack([(i % W_IMG).astype(jnp.float32),
                         (i // W_IMG).astype(jnp.float32),
                         jnp.ones(H_IMG * W_IMG)])
    proj = h @ src
    flow = (proj[:2] / proj[2:] - src[:2]).T.reshape(1, H_IMG, W_IMG, 2)
    weights = 0.2 + 0.8 * (src[0] % 7) / 6
    return flow, weights.reshape(1, H_IMG, W_IMG, 1)


def garbage_flow(xp):
    key = (xp.arange(H_IMG * W_IMG) % W_IMG) * 1.0
    flow = xp.stack([xp.sin(key * 12.9898) * 25.0,
                     xp.cos(key * 78.233) * 25.0], -1)
    return (flow.reshape(1, H_IMG, W_IMG, 2) * 1.0,
            xp.ones((1, H_IMG, W_IMG, 1)))


def run_both(tp_kwargs, flow_of, frames, params_of=None, state_hp=None,
             jax_tp_kwargs=None):
    """Drive the JAX and the port step on the same frames.

    ``flow_of(xp, params)`` is the oracle (flow, weights); ``params_of(t,
    state)`` gives frame t's numpy oracle parameters from the state the
    step starts from (they travel as the step's ``params``, so the jitted
    JAX step sees them anew each frame). ``jax_tp_kwargs``: further
    ``TrackerParams`` fields of the JAX step only. Returns per-package
    lists of (H, meta)."""
    template = template_frame()
    mask = target_mask()
    out = {}
    for pkg in ("jax", "torch"):
        xp = torch if pkg == "torch" else jnp

        def flow_fn(params, img1, img2, template_feats=None, xp=xp):
            return flow_of(xp, params)

        if pkg == "jax":
            tp = jw.TrackerParams(**tp_kwargs, **(jax_tp_kwargs or {}))
            step = jw.build_track_step(jraft.RaftConfig(iters=2), tp,
                                       flow_fn=flow_fn)
            state = jw.tracker_init_state({}, None, tp,
                                          jnp.asarray(template)[None],
                                          jnp.asarray(mask), encode=False)
            if state_hp is not None:
                state = jw.TrackerState(
                    state.template_img, None, state.template_mask,
                    state.prev_img, jnp.asarray(state_hp),
                    jnp.asarray(state_hp), state.lost, state.n_lost)
        else:
            tp = tw.TrackerParams(**tp_kwargs)
            step = tw.build_track_step(traft.RaftConfig(iters=2), tp,
                                       flow_fn=flow_fn)
            state = tw.tracker_init_state(None, None, tp,
                                          torch.from_numpy(template)[None],
                                          torch.from_numpy(mask),
                                          encode=False)
            if state_hp is not None:
                state.prev_h2init = torch.from_numpy(state_hp)
                state.last_good_h2init = torch.from_numpy(state_hp)
        res = []
        for t, f in enumerate(frames):
            params = {} if params_of is None else {
                k: xp.asarray(v) if xp is jnp else torch.from_numpy(v)
                for k, v in params_of(t, state).items()}
            frame = (torch.from_numpy(f)[None] if pkg == "torch"
                     else jnp.asarray(f)[None])
            state, H, meta = step(params, state, frame)
            res.append((np.asarray(H), {k: np.asarray(v)
                                        for k, v in meta.items()}))
        out[pkg] = res
    return out["jax"], out["torch"]


def _last_good(state, no_prewarp_after_n):
    if int(np.asarray(state.n_lost)) > no_prewarp_after_n:
        return np.eye(3, dtype=np.float32)
    return np.asarray(state.last_good_h2init, np.float32)


def _oracle(xp, params):
    return homography_flow(params["h"], xp)


@pytest.mark.parametrize("estimator", ["wls_qr", "plain_qr"])
def test_sequence_matches_jax(estimator):
    """A homography walk: per-frame H of both trackers, and the truth."""
    truths = []
    for t in range(1, 5):
        c, s = np.cos(0.01 * t) * (1 + 0.01 * t), np.sin(0.01 * t)
        truths.append(np.array([[c, -s, 1.5 * t], [s, c, -1.0 * t],
                                [1e-5 * t, 0, 1]], np.float32))  # cur->tmpl
    template = torch.from_numpy(template_frame())[None]
    frames = [warp_perspective(template, torch.from_numpy(
        np.linalg.inv(h).astype(np.float32)))[0].numpy() for h in truths]

    def params_of(t, state):
        h = _last_good(state, 10) @ np.linalg.inv(truths[t])
        return {"h": h.astype(np.float32)}

    jres, tres = run_both({"estimator": estimator}, _oracle, frames,
                          params_of)
    for (Hj, mj), (Ht, mt), truth in zip(jres, tres, truths):
        assert bool(mt["global_H_success"]) and bool(mj["global_H_success"])
        assert corner_err(Ht, Hj) < CORNER_TOL
        assert corner_err(Ht, truth) < CORNER_TOL


def test_lost_counter_and_fallback_match_jax():
    """Garbage flow: the check fails, the local fallback runs, the lost
    counter climbs, and past ``no_prewarp_after_n`` the pre-warp resets."""
    jres, tres = run_both({"no_prewarp_after_n": 2},
                          lambda xp, params: garbage_flow(xp),
                          [template_frame()] * 5)
    for i, ((Hj, mj), (Ht, mt)) in enumerate(zip(jres, tres)):
        assert bool(mt["lost"]) and bool(mj["lost"])
        assert int(mt["N_lost"]) == int(mj["N_lost"]) == i + 1
        assert np.isfinite(Ht).all()
        assert corner_err(Ht, Hj) < CORNER_TOL
        np.testing.assert_allclose(mt["last_good_H2init"],
                                   mj["last_good_H2init"], atol=1e-6)
    np.testing.assert_array_equal(tres[-1][1]["last_good_H2init"], np.eye(3))


def test_local_h_in_meta_matches_host_fallback():
    """On the frames whose check fails, ``meta`` carries the fallback's H
    as ``H_local_cur2init``, as the JAX step's ``host_fallback`` path (the
    one its ``WOFTTracker`` takes at 1280x720) does; on the others the key
    is absent in both. A homography walk whose flow is garbage on frames 1
    and 3."""
    truths = []
    for t in range(1, 6):
        c, s = np.cos(0.01 * t) * (1 + 0.01 * t), np.sin(0.01 * t)
        truths.append(np.array([[c, -s, 1.5 * t], [s, c, -1.0 * t],
                                [1e-5 * t, 0, 1]], np.float32))
    template = torch.from_numpy(template_frame())[None]
    frames = [warp_perspective(template, torch.from_numpy(
        np.linalg.inv(h).astype(np.float32)))[0].numpy() for h in truths]
    failing = {1, 3}

    def params_of(t, state):
        h = _last_good(state, 10) @ np.linalg.inv(truths[t])
        return {"h": h.astype(np.float32),
                "garbage": np.array(t in failing, np.float32)}

    def flow_of(xp, params):
        flow, weights = homography_flow(params["h"], xp)
        bad, _ = garbage_flow(xp)
        return xp.where(params["garbage"] > 0, bad, flow), weights

    jres, tres = run_both({}, flow_of, frames, params_of,
                          jax_tp_kwargs={"host_fallback": True})
    for t, ((Hj, mj), (Ht, mt)) in enumerate(zip(jres, tres)):
        assert bool(mt["global_H_success"]) == bool(mj["global_H_success"]) \
            == (t not in failing)
        assert ("H_local_cur2init" in mt) == ("H_local_cur2init" in mj) \
            == (t in failing)
        if t in failing:
            assert corner_err(mt["H_local_cur2init"],
                              mj["H_local_cur2init"]) < CORNER_TOL
            np.testing.assert_array_equal(mt["H_local_cur2init"], Ht)
        assert corner_err(Ht, Hj) < CORNER_TOL


@pytest.mark.parametrize("mode,expect_lost", [("never", True),
                                              ("always", False)])
def test_redetection_modes(mode, expect_lost):
    jres, tres = run_both({"redetection": mode},
                          lambda xp, params: (xp.zeros((1, H_IMG, W_IMG, 2)),
                                              xp.ones((1, H_IMG, W_IMG, 1))),
                          [template_frame()])
    assert bool(tres[0][1]["lost"]) == bool(jres[0][1]["lost"]) == expect_lost


def test_local_fallback_compose_order():
    """The fallback H is prev_h2init after H_flow (cur -> prev first)."""
    A = np.array([[1.0, 0.0, 5.0], [0.0, 1.0, -3.0], [0, 0, 1.0]],
                 np.float32)
    Hp = np.array([[0.95, 0.10, 8.0], [-0.08, 1.05, -6.0],
                   [2e-5, -1e-5, 1.0]], np.float32)
    jres, tres = run_both({"redetection": "never"}, _oracle,
                          [template_frame()], lambda t, state: {"h": A},
                          state_hp=Hp)
    expected = Hp @ np.linalg.inv(A)
    assert corner_err(tres[0][0], expected / expected[2, 2]) < CORNER_TOL
    assert corner_err(tres[0][0], jres[0][0]) < CORNER_TOL


def test_weighted_raft_step_matches_jax():
    """The real network: the main flow with the sparse weight head
    (H_global) and the dense-head fallback flow (H), in both packages with
    one set of weights."""
    jcfg = jraft.RaftConfig(variant="weighted", iters=2)
    tcfg = traft.RaftConfig(iters=2)
    model = traft.init_raft_params(tcfg, seed=3)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                params_to_jax_numpy(model.state_dict()))
    template = template_frame()
    mask = target_mask()
    h = np.array([[1.0, 0.01, 1.5], [0.0, 1.0, -0.8], [0, 0, 1.0]],
                 np.float32)
    frame = warp_perspective(torch.from_numpy(template)[None],
                             torch.from_numpy(h))

    jtp = jw.TrackerParams(redetection="never")
    jstep = jw.build_track_step(jcfg, jtp)
    jstate = jw.tracker_init_state(jp, jcfg, jtp, jnp.asarray(template)[None],
                                   jnp.asarray(mask))
    _, Hj, mj = jstep(jp, jstate, jnp.asarray(frame.numpy()))

    ttp = tw.TrackerParams(redetection="never")
    tstep = tw.build_track_step(tcfg, ttp)
    tstate = tw.tracker_init_state(model, tcfg, ttp,
                                   torch.from_numpy(template)[None],
                                   torch.from_numpy(mask))
    _, Ht, mt = tstep(model, tstate, frame)
    assert np.isfinite(Ht.numpy()).all()
    assert corner_err(mt["H_global_cur2init"].numpy(),
                      mj["H_global_cur2init"]) < CORNER_TOL
    assert corner_err(Ht.numpy(), Hj) < CORNER_TOL


# bf16 mode: the two packages' flows differ by bf16 rounding noise (about
# 2e-3 px at this size, see tests/test_torch_raft.py), and the 500-point fit
# passes it on at that size: 2.6e-3 px measured at the template corners
# (6e-5 px in float32). The float32 tolerance holds with 20x headroom.
BF16_CORNER_TOL = 0.05


@pytest.mark.parametrize("precision,tol", [("highest", CORNER_TOL),
                                           ("bf16", BF16_CORNER_TOL)])
def test_woft_fast_walk_matches_jax(precision, tol):
    """The slice as a whole: ``WOFTTracker`` under the port's
    ``configs/WOFT_fast.py`` against the JAX step under
    ``woft_tpu/configs/WOFT_fast.py`` (Pallas path, interpret mode), the
    same seeded weights, per-frame H over a homography walk."""
    from test_corr_impls import _interpret_pallas
    from woft_tpu.config import load_config as jload_config
    from woft_tpu.ops.pallas import local_corr as plc
    from woft_tpu.ops.pallas import local_lookup as pll

    jconf = jload_config(ROOT / "woft_tpu" / "configs" / "WOFT_fast.py")
    tconf = load_config(ROOT / "woft_tpu_torch" / "configs" / "WOFT_fast.py")
    for key in ("corr_impl", "local_margin", "precision"):
        assert getattr(tconf.flow_config, key) == getattr(jconf.flow_config,
                                                          key)
    assert tconf.flow_config.precision == "bf16"
    tconf.flow_config.iters = 2
    tconf.flow_config.precision = precision
    tracker = tw.WOFTTracker(tconf, device="cpu")
    assert tracker.flower.cfg.corr_impl == "local"

    jcfg = jraft.RaftConfig(
        variant="weighted", iters=2, corr_impl=str(jconf.flow_config.corr_impl),
        local_margin=int(jconf.flow_config.local_margin), local_pallas=True,
        precision=precision)
    jp = jax.tree_util.tree_map(
        jnp.asarray, params_to_jax_numpy(tracker.flower.model.state_dict()))

    template = template_frame().round().astype(np.uint8)         # BGR
    frames = []
    for t in range(1, 3):
        c, s = np.cos(0.01 * t) * (1 + 0.01 * t), np.sin(0.01 * t)
        h = np.array([[c, -s, 1.5 * t], [s, c, -1.0 * t], [1e-5 * t, 0, 1]],
                     np.float32)
        f = warp_perspective(torch.from_numpy(template.astype(np.float32))[None],
                             torch.from_numpy(np.linalg.inv(h)))[0]
        frames.append(f.round().clamp(0, 255).numpy().astype(np.uint8))

    def rgb(bgr):
        return jnp.asarray(bgr[..., ::-1].astype(np.float32))[None]

    tracker.init(template, target_mask())
    with _interpret_pallas(plc, pll):
        jstep = jw.build_track_step(jcfg, jconf.tracker_params)
        jstate = jw.tracker_init_state(jp, jcfg, jconf.tracker_params,
                                       rgb(template),
                                       jnp.asarray(target_mask()))
        for f in frames:
            jstate, Hj, mj = jstep(jp, jstate, rgb(f))
            Ht, mt = tracker.track(f)
            assert np.isfinite(Ht).all()
            assert bool(mt.global_H_success) == bool(mj["global_H_success"])
            assert corner_err(mt.H_global_cur2init,
                              mj["H_global_cur2init"]) < tol
            assert corner_err(Ht, Hj) < tol


def test_woft_fast_fused_walk_matches_jax():
    """The fused slice as a whole: ``build_track_step`` with ``WOFT_fast``'s
    ``RaftConfig`` plus ``gru_fused`` and ``tail_fused`` against the JAX
    step with ``gru_pallas`` and ``tail_pallas`` (all Pallas kernels in
    interpret mode), the same seeded weights, over the homography walk. The
    main flow (template features, sparse head) passes the check on these
    frames; ``redetection='never'`` then sends every frame through the
    local-flow fallback (dense head) as well."""
    from test_corr_impls import _interpret_pallas
    from woft_tpu.ops.pallas import gru as pgru
    from woft_tpu.ops.pallas import local_corr as plc
    from woft_tpu.ops.pallas import local_lookup as pll
    from woft_tpu.ops.pallas import update_tail as ptail

    tcfg = traft.RaftConfig(iters=2, corr_impl="local", precision="bf16",
                            gru_fused=True, tail_fused=True)
    jcfg = jraft.RaftConfig(variant="weighted", iters=2, corr_impl="local",
                            local_margin=tcfg.local_margin, local_pallas=True,
                            precision="bf16", gru_pallas=True,
                            tail_pallas=True)
    model = traft.init_raft_params(tcfg, seed=0)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                params_to_jax_numpy(model.state_dict()))
    template = template_frame().round()
    frames = []
    for t in range(1, 3):
        c, s = np.cos(0.01 * t) * (1 + 0.01 * t), np.sin(0.01 * t)
        h = np.array([[c, -s, 1.5 * t], [s, c, -1.0 * t], [1e-5 * t, 0, 1]],
                     np.float32)
        f = warp_perspective(torch.from_numpy(template)[None],
                             torch.from_numpy(np.linalg.inv(h)))
        frames.append(f.round().clamp(0, 255))
    mask = target_mask()
    for mode in ("inliers", "never"):
        ttp = tw.TrackerParams(redetection=mode)
        jtp = jw.TrackerParams(redetection=mode)
        tstep = tw.build_track_step(tcfg, ttp)
        tstate = tw.tracker_init_state(model, tcfg, ttp,
                                       torch.from_numpy(template)[None],
                                       torch.from_numpy(mask))
        with _interpret_pallas(plc, pll, pgru, ptail):
            jstep = jw.build_track_step(jcfg, jtp)
            jstate = jw.tracker_init_state(jp, jcfg, jtp,
                                           jnp.asarray(template)[None],
                                           jnp.asarray(mask))
            for f in frames[:2 if mode == "inliers" else 1]:
                jstate, Hj, mj = jstep(jp, jstate, jnp.asarray(f.numpy()))
                tstate, Ht, mt = tstep(model, tstate, f)
                assert np.isfinite(Ht.numpy()).all()
                assert bool(mt["global_H_success"]) == \
                    bool(mj["global_H_success"]) == (mode == "inliers")
                assert corner_err(mt["H_global_cur2init"].numpy(),
                                  mj["H_global_cur2init"]) < BF16_CORNER_TOL
                assert corner_err(Ht.numpy(), Hj) < BF16_CORNER_TOL


def test_woft_tracker_shell_cpu():
    conf = load_config(ROOT / "woft_tpu_torch" / "configs" / "WOFT.py")
    conf.flow_config.iters = 2
    tracker = tw.WOFTTracker(conf, device="cpu")
    img = template_frame().astype(np.uint8)
    mask = target_mask()
    two_blobs = mask.copy()
    two_blobs[2:6, 2:6] = True
    with pytest.raises(ValueError):
        tracker.init(img, two_blobs)
    tracker.init(img, mask)
    for _ in range(2):
        H, meta = tracker.track(img)
        assert H.shape == (3, 3) and H.dtype == np.float64
        assert np.isfinite(H).all()
        assert isinstance(meta.global_H_success, bool)
        np.testing.assert_array_equal(meta.estim_H_current2template, H)
