"""The tracker on the rest of the flow-network family, against ``woft_tpu``
on the CPU: the 'orig' RAFT step (``WOFT_origraft``), the visibility mask of
'weighted_masked' (``WOFT_masked``) in the main step, in the local fallback
and dropped by the shared-flow step, and ``RaftFlow``'s outputs and
checkpoint loading under each variant.

Tolerance: projected template corners within 0.05 px of the JAX step's
(float32 fits of 500 points in two libraries, as in
``test_torch_tracker.py``); the wrapper's outputs equal the port's own
forward exactly.
"""

import logging
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.models import raft as jraft
from woft_tpu.tracker import woft as jw
from woft_tpu_torch.config import load_config
from woft_tpu_torch.flow import RaftFlow
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_to_jax_numpy
from woft_tpu_torch.ops.warp import warp_perspective
from woft_tpu_torch.tracker import woft as tw

ROOT = Path(__file__).resolve().parent.parent
FLOW_CONFIGS = ROOT / "woft_tpu_torch" / "configs" / "flow"
WEIGHTS = ROOT / "weights"
CORNER_TOL = 0.05
H_IMG, W_IMG = 64, 96
CORNERS = np.array([[24, 16], [71, 16], [71, 47], [24, 47]], float).T
TRUTH = np.array([[1.0, 0.01, 1.5], [0.0, 1.0, -0.8], [0, 0, 1.0]],
                 np.float32)                       # template -> frame


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs (torch's default of one a
    core makes small operations wait on each other's threads under the
    suite's parallel workers); the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def corner_err(Ha, Hb, corners=CORNERS):
    def proj(H):
        p = np.asarray(H, np.float64) @ np.vstack([corners, np.ones(4)])
        return p[:2] / p[2:]
    return np.linalg.norm(proj(Ha) - proj(Hb), axis=0).max()


def scene(h_img=H_IMG, w_img=W_IMG):
    template = np.random.default_rng(0).uniform(
        0, 255, (h_img, w_img, 3)).astype(np.float32)
    mask = np.zeros((h_img, w_img), bool)
    mask[16:48, 24:72] = True
    frame = warp_perspective(torch.from_numpy(template)[None],
                             torch.from_numpy(TRUTH)).numpy()
    return template, mask, frame


def step_pair(jcfg, tcfg, model, jp, tp_kwargs, hw=(H_IMG, W_IMG)):
    """One frame through both packages' steps with the real network (the
    local fallback runs too under ``redetection='never'``). Returns ((H,
    H_global) port, (H, H_global) JAX)."""
    template, mask, frame = scene(*hw)
    jtp = jw.TrackerParams(**tp_kwargs)
    jstate = jw.tracker_init_state(jp, jcfg, jtp, jnp.asarray(template)[None],
                                   jnp.asarray(mask))
    _, Hj, mj = jw.build_track_step(jcfg, jtp)(jp, jstate,
                                               jnp.asarray(frame))
    ttp = tw.TrackerParams(**tp_kwargs)
    tstate = tw.tracker_init_state(model, tcfg, ttp,
                                   torch.from_numpy(template)[None],
                                   torch.from_numpy(mask))
    _, Ht, mt = tw.build_track_step(tcfg, ttp)(model, tstate,
                                               torch.from_numpy(frame))
    return ((Ht.numpy(), mt["H_global_cur2init"].numpy()),
            (np.asarray(Hj), np.asarray(mj["H_global_cur2init"])))


def carried(tcfg, seed=3):
    model = traft.init_raft_params(tcfg, seed=seed)
    return model, jax.tree_util.tree_map(
        jnp.asarray, params_to_jax_numpy(model.state_dict()))


# --------------------------------------------------------------------------
# the real network: 'orig' and 'weighted_masked'
# --------------------------------------------------------------------------

def test_origraft_step_matches_jax():
    """``WOFT_origraft``: the 'orig' RAFT (no weight head: uniform weights,
    the dense path), plain QR, ``RAFT`` padding of a 68x100 frame (padded
    to 72x104), the fallback flow too."""
    jcfg = jraft.RaftConfig(variant="orig", iters=2)
    tcfg = traft.RaftConfig(variant="orig", iters=2)
    model, jp = carried(tcfg)
    (Ht, Hgt), (Hj, Hgj) = step_pair(
        jcfg, tcfg, model, jp, dict(estimator="plain_qr",
                                    padding_mode="RAFT",
                                    redetection="never"), hw=(68, 100))
    assert np.isfinite(Ht).all() and np.isfinite(Hgt).all()
    assert corner_err(Hgt, Hgj) < CORNER_TOL
    assert corner_err(Ht, Hj) < CORNER_TOL


def test_masked_step_matches_jax():
    """``WOFT_masked``: WeightedRAFT with the mask head (dense weight head,
    the sparse gate closed), the visibility mask in the main step and the
    fallback. The head's last layer is scaled so that the mask has large
    logits of both signs, and both packages must keep the same pixels."""
    mhs = ((32, 3), (32, 3))
    jcfg = jraft.RaftConfig(variant="weighted_masked", iters=2,
                            mask_head_structure=mhs)
    tcfg = traft.RaftConfig(variant="weighted_masked", iters=2,
                            mask_head_structure=mhs)
    model = traft.init_raft_params(tcfg, seed=3)
    template, mask, frame = scene()

    def mask_up():
        return traft.weighted_raft_forward(
            model, tcfg, torch.from_numpy(template)[None],
            torch.from_numpy(frame))["mask_up"][0, 16:48, 24:72]

    last = model.mask_head.net[-1]
    with torch.no_grad():
        last.weight.mul_(400.0)
        # the convex upsample's weights sum to 1 (and its x8 is divided
        # out): the bias moves the upsampled logits by as much. Put the
        # threshold in the widest gap between the middle fifth's logits,
        # so no pixel lies near it
        v = mask_up().flatten().sort().values
        mid = v[int(0.4 * len(v)):int(0.6 * len(v))]
        i = (mid[1:] - mid[:-1]).argmax()
        last.bias.sub_((mid[i] + mid[i + 1]) / 2)
    jp = jax.tree_util.tree_map(jnp.asarray,
                                params_to_jax_numpy(model.state_dict()))
    logits = mask_up()
    share = (logits > 0).float().mean().item()
    assert 0.3 < share < 0.7, share           # the mask decides
    print(f"masked step: {share:.1%} of the target visible, least |logit| "
          f"{logits.abs().min().item():.3g}")
    (Ht, Hgt), (Hj, Hgj) = step_pair(jcfg, tcfg, model, jp,
                                     dict(redetection="never"))
    assert corner_err(Hgt, Hgj) < CORNER_TOL
    assert corner_err(Ht, Hj) < CORNER_TOL


# --------------------------------------------------------------------------
# the visibility mask through the flow seam (oracle flow)
# --------------------------------------------------------------------------

def oracle(xp, with_vis=True):
    """Flow of TRUTH on the left half of the frame, the right half 12 px
    off; visibility 0.9 on the left and 0.1 on the right. ``with_vis``:
    the seam returns (flow, weights, vis), else (flow, weights)."""
    i = xp.arange(H_IMG * W_IMG)
    if xp is torch:
        x, y = (i % W_IMG).float(), (i // W_IMG).float()
        h = torch.from_numpy(TRUTH)
    else:
        x, y = (i % W_IMG).astype(jnp.float32), (i // W_IMG).astype(
            jnp.float32)
        h = jnp.asarray(TRUTH)
    src = xp.stack([x, y, xp.ones_like(x)])
    p = h @ src
    flow = (p[:2] / p[2:] - src[:2]).T
    right = (x >= W_IMG // 2)[:, None]
    flow = flow + 12.0 * right
    vis = 0.9 - 0.8 * right
    shape = (1, H_IMG, W_IMG)
    res = (flow.reshape(*shape, 2), xp.ones((*shape, 1)), vis.reshape(*shape,
                                                                      1))

    def flow_fn(params, img1, img2, template_feats=None):
        return res if with_vis else res[:2]
    return flow_fn


def oracle_steps(with_vis=True):
    """One frame of both packages' steps on the oracle seam, the fallback
    flow too (``redetection='never'``). Returns (port, JAX), each (H,
    H_global)."""
    template, mask, frame = scene()
    jtp = jw.TrackerParams(redetection="never")
    jstate = jw.tracker_init_state({}, None, jtp,
                                   jnp.asarray(template)[None],
                                   jnp.asarray(mask), encode=False)
    _, Hj, mj = jw.build_track_step(jraft.RaftConfig(iters=1), jtp,
                                    flow_fn=oracle(jnp, with_vis))(
        {}, jstate, jnp.asarray(frame))
    ttp = tw.TrackerParams(redetection="never")
    tstate = tw.tracker_init_state(None, None, ttp,
                                   torch.from_numpy(template)[None],
                                   torch.from_numpy(mask), encode=False)
    _, Ht, mt = tw.build_track_step(traft.RaftConfig(iters=1), ttp,
                                    flow_fn=oracle(torch, with_vis))(
        None, tstate, torch.from_numpy(frame))
    return ((Ht.numpy(), mt["H_global_cur2init"].numpy()),
            (np.asarray(Hj), np.asarray(mj["H_global_cur2init"])))


def test_visibility_mask_in_main_step_and_fallback():
    """With the mask the right half's wrong flow is left out of the main
    fit and of the fallback's, so both recover the truth, as JAX's do;
    without it (a two-value seam) both packages are pulled off."""
    (Ht, Hgt), (Hj, Hgj) = oracle_steps(with_vis=True)
    truth_inv = np.linalg.inv(TRUTH)                  # frame -> template
    for H in (Ht, Hgt):
        assert corner_err(H, truth_inv) < CORNER_TOL
    assert corner_err(Hgt, Hgj) < CORNER_TOL
    assert corner_err(Ht, Hj) < CORNER_TOL
    (Ht2, Hgt2), (Hj2, Hgj2) = oracle_steps(with_vis=False)
    assert corner_err(Hgt2, truth_inv) > 1.0
    assert corner_err(Hgt2, Hgj2) < CORNER_TOL


def test_shared_step_drops_the_visibility_mask():
    """The shared-flow multi-target step keeps the flow and weights of the
    seam and drops the mask, as ``woft_tpu``'s does (``[:2]``): the same
    H as JAX's, and as with a two-value seam."""
    template, mask, frame = scene()
    masks = np.stack([mask, np.roll(mask, 8, axis=0)])
    jtp = jw.TrackerParams(redetection="always", no_local_h=True)
    jstep = jw.build_shared_multi_step(jraft.RaftConfig(iters=1), jtp,
                                       flow_fn=oracle(jnp))
    jstate = jw.tracker_init_state({}, None, jtp, jnp.asarray(template)[None],
                                   jnp.asarray(mask), encode=False)
    _, _, jhs, _ = jstep({}, jstate, jnp.asarray(masks.reshape(2, -1)),
                         jnp.tile(jnp.eye(3), (2, 1, 1)), jnp.asarray(frame))
    ttp = tw.TrackerParams(redetection="always", no_local_h=True)
    hs = {}
    for with_vis in (True, False):
        step = tw.build_shared_multi_step(traft.RaftConfig(iters=1), ttp,
                                          flow_fn=oracle(torch, with_vis))
        state = tw.tracker_init_state(None, None, ttp,
                                      torch.from_numpy(template)[None],
                                      torch.from_numpy(mask), encode=False)
        hs[with_vis] = step(None, state, torch.from_numpy(masks),
                            torch.eye(3).repeat(2, 1, 1),
                            torch.from_numpy(frame))[2].numpy()
    for t in range(2):
        assert corner_err(hs[True][t], np.asarray(jhs[t])) < CORNER_TOL
        np.testing.assert_array_equal(hs[True][t], hs[False][t])
    # the mask would have mattered: the full-frame step that keeps it
    assert corner_err(hs[True][0], np.linalg.inv(TRUTH)) > 1.0


# --------------------------------------------------------------------------
# RaftFlow under each variant
# --------------------------------------------------------------------------

def _flow_conf(name, **kw):
    conf = load_config(FLOW_CONFIGS / name)
    conf.iters = 2
    for k, v in kw.items():
        setattr(conf, k, v)
    return conf


@pytest.mark.parametrize("raft_type,n_flow,n_tc", [
    ("weighted", 2, 3), ("orig", 2, 3), ("weighted_masked", 3, 4)])
def test_raft_flow_outputs_by_variant(raft_type, n_flow, n_tc):
    """``compute_flow``'s arity and outputs follow the reference's: None
    weights under 'orig', the mask appended under 'weighted_masked' (mode
    'flow' and 'TC'); the values are the forward's."""
    conf = _flow_conf("wraft_large.py", raft_type=raft_type, model=None)
    flower = RaftFlow(conf, device="cpu")
    assert flower.cfg.variant == raft_type
    rng = np.random.default_rng(6)
    bgr1 = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    bgr2 = np.roll(bgr1, 2, axis=1)
    ref = traft.weighted_raft_forward(
        flower.model, flower.cfg,
        *(torch.from_numpy(b[:, :, ::-1].astype(np.float32))[None]
          for b in (bgr1, bgr2)))
    out = flower.compute_flow(bgr1, bgr2, mode="flow", numpy_out=True,
                              do_sigmoid=True)
    assert len(out) == n_flow
    np.testing.assert_array_equal(out[0], ref["flow_up"][0].permute(2, 0, 1))
    if raft_type == "orig":
        assert out[1] is None
    else:
        np.testing.assert_array_equal(
            out[1], torch.sigmoid(ref["weights_up"][0, ..., 0]))
    if raft_type == "weighted_masked":
        np.testing.assert_array_equal(
            out[2], torch.sigmoid(ref["mask_up"][0, ..., 0]))
    tc = flower.compute_flow(bgr1, bgr2, mode="TC", numpy_out=True)
    assert len(tc) == n_tc
    np.testing.assert_allclose(tc[1] - tc[0], out[0].reshape(2, -1),
                               atol=1e-5)
    assert (tc[2] is None) == (raft_type == "orig")
    if raft_type == "weighted_masked":
        np.testing.assert_array_equal(tc[3],
                                      ref["mask_up"][0].reshape(1, -1))


def test_raft_small_is_not_ported():
    conf = _flow_conf("wraft_large.py")
    conf.class_params.small = True
    with pytest.raises(NotImplementedError, match="RAFT-small is not ported"):
        RaftFlow(conf, device="cpu")


def test_partial_checkpoints_merge(caplog):
    """The v4 weights under 'weighted_masked' load what they have, bit for
    bit, and the mask head keeps its seeded init; the v3 weights under an
    'orig' config drop their weight head. Both log the reference's
    partial-match warning."""
    v4 = torch.load(WEIGHTS / "wraft_tpu_v4_torch.pt", weights_only=True)
    with caplog.at_level(logging.WARNING):
        flower = RaftFlow(_flow_conf("wraft_large.py",
                                     raft_type="weighted_masked",
                                     model=WEIGHTS / "wraft_tpu_v4_torch.pt"),
                          device="cpu")
    assert "partial match" in caplog.text
    sd = flower.model.state_dict()
    for k, v in v4.items():
        assert torch.equal(sd[k], v), k
    seeded = traft.init_raft_params(flower.cfg, seed=0).state_dict()
    mask_keys = [k for k in sd if k.startswith("mask_head.")]
    assert mask_keys
    for k in mask_keys:
        assert torch.equal(sd[k], seeded[k]), k

    caplog.clear()
    v3 = torch.load(WEIGHTS / "wraft_tpu_v3_torch.pt", weights_only=True)
    with caplog.at_level(logging.WARNING):
        flower = RaftFlow(_flow_conf("orig_raft.py",
                                     model=WEIGHTS / "wraft_tpu_v3_torch.pt"),
                          device="cpu")
    assert "partial match" in caplog.text
    assert not hasattr(flower.model, "weight_head")
    sd = flower.model.state_dict()
    assert set(sd) == {k for k in v3 if not k.startswith("weight_head.")}
    for k in sd:
        assert torch.equal(sd[k], v3[k]), k
