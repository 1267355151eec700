"""The port's training step against ``woft_tpu``'s on the CPU: the loss
through the differentiable homography fit and its gradients, the optax
chain written out (``training/train.py:AdamW``), the non-finite skip, the
stand-in masks, and the synthetic pairs' arithmetic on given draws.

The network is RAFT-small with a one-layer weight head, 2 iterations, 64x96
frames, ``precision='highest'``, one seeded JAX tree carried across.
Tolerances: the loss 1e-4 relative. Its gradients, each leaf against the
largest gradient of its part of the network (the feature encoder, the
context encoder, the update block, the weight head): 1e-4 for the flow
network's parts (float32 convolutions in two libraries, then a float32 QR
fit; measured 2.1e-5) and 1e-2 for the weight head (measured 3.6e-3 on its
last layer: the fit ignores a common scale of the weights, so the head's
gradients are sums of the weight map's gradient that nearly cancel, and
the two libraries' float32 fits differ in that gradient by about 1e-4 of
its largest; ``chip_smoke.py`` splits the card-vs-CPU difference of the
same step this way); parameters after three optimizer steps 1e-6
absolute (the same float32 update arithmetic; the schedule and the bias
corrections are powers taken in float32 by both); the synthetic
homographies 1e-3 px at the corners.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from woft_tpu.geometry import homography as jhom
from woft_tpu.models import raft as jraft
from woft_tpu.ops import warp as jwarp
from woft_tpu.training import train as jtrain
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import (params_from_jax_numpy,
                                           params_to_jax_numpy)
from woft_tpu_torch.ops import warp as twarp
from woft_tpu_torch.training import synth as tsynth
from woft_tpu_torch.training import train as ttrain

H_IMG, W_IMG = 64, 96
LOSS_REL = 1e-4
GRAD_REL_HEAD = 1e-2
GRAD_REL_NET = 1e-4
PARAM_ATOL = 1e-6
CORNER_PX = 1e-3
HEAD = ((32, 3),)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs; the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs():
    kw = dict(variant="weighted", iters=2, small=True,
              weight_head_structure=HEAD)
    return jraft.RaftConfig(**kw), traft.RaftConfig(**kw)


@pytest.fixture(scope="module")
def setup():
    """Both configs, the JAX tree, and one numpy batch of two pairs made by
    the port's synthesis (seeded draws)."""
    jcfg, tcfg = _cfgs()
    params = params_to_jax_numpy(traft.init_raft_params(tcfg, seed=0)
                                 .state_dict())
    rng = np.random.default_rng(1)
    imgs = torch.from_numpy(rng.uniform(0, 255, (2, H_IMG, W_IMG, 3))
                            .astype(np.float32))
    batch = tsynth.synth_homography_batch(torch.Generator().manual_seed(2),
                                          imgs, max_corner_shift=0.05)
    return jcfg, tcfg, params, {k: v.numpy() for k, v in batch.items()}


def _model(tcfg, params):
    model = traft.WeightedRAFT(tcfg).eval()
    model.load_state_dict(params_from_jax_numpy(params))
    return model


def _rel_close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err, scale = np.abs(a - b).max(), max(np.abs(b).max(), 1e-12)
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("mode,epe", [("sobol", 0.0), ("grid", 0.5)],
                         ids=["sobol", "grid-epe"])
def test_loss_and_grads_match_jax(setup, mode, epe):
    """``woft_loss`` and its gradients, weight head only and the whole net
    (``train_flow``: every leaf), against ``jax.value_and_grad``; 'sobol'
    without a key or generator (the candidates are the in-bounds points),
    'grid' with the EPE term."""
    jcfg, tcfg, params, batch = setup
    kw = dict(subsample=mode, sobol_n=200, max_tc=400, epe_weight=epe)
    jt, tt = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jtrain.woft_loss(p, jcfg, jt, b)))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    jflat = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray,
                                                         jgrads))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for train_flow in (False, True):
        model = _model(tcfg, params)
        tx = ttrain.make_optimizer(model, ttrain.TrainConfig(
            **kw, train_flow=train_flow))
        loss = ttrain.woft_loss(model, tcfg, tt, tb)
        grads = torch.autograd.grad(loss, tx.params)
        _rel_close(loss.item(), float(jloss), LOSS_REL, "loss")
        assert len(tx.names) == (len(list(model.parameters())) if train_flow
                                 else 4)
        # the fit is blind to a common scale of the weights, so some
        # leaves' gradients are sums that nearly cancel: each leaf is held
        # to the largest gradient of its part of the network
        part = {n: n.split(".")[0] for n in tx.names}
        scale = {}
        for n in tx.names:
            scale[part[n]] = max(scale.get(part[n], 0.0),
                                 jflat[n].abs().max().item())
        assert min(scale.values()) > 0, scale
        for name, g in zip(tx.names, grads):
            err = (g - jflat[name]).abs().max().item()
            rel = (GRAD_REL_HEAD if part[name] in ("weight_head", "mask_head")
                   else GRAD_REL_NET)
            assert err <= rel * scale[part[name]], (name, err,
                                                     scale[part[name]])


def _random_grads(names_shapes, rng, scale):
    return {n: (rng.normal(size=s) * scale).astype(np.float32)
            for n, s in names_shapes}


@pytest.mark.parametrize("train_flow", [False, True],
                         ids=["head", "whole-net"])
def test_three_steps_match_optax(setup, train_flow):
    """Three steps with ``steps_per_epoch=1`` (the rate halves every step)
    and a global-norm clip that binds, against the JAX package's optax
    chain on the same gradients: the parameters after each step, frozen
    leaves unchanged."""
    _, tcfg, params, _ = setup
    kw = dict(learning_rate=1e-2, steps_per_epoch=1, grad_clip=1.0,
              train_flow=train_flow)
    model = _model(tcfg, params)
    tx, state = ttrain.init_train_state(model, ttrain.TrainConfig(**kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jtx = jtrain.make_optimizer(jparams, jtrain.TrainConfig(**kw))
    jstate = jtx.init(jparams)
    jupdate = jax.jit(jtx.update)
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if n not in tx.names}
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = _random_grads(shapes, rng, 0.5)       # global norm >> 1
        tree = params_to_jax_numpy({n: torch.from_numpy(v)
                                    for n, v in g.items()})
        upd, jstate = jupdate(jax.tree_util.tree_map(jnp.asarray, tree),
                              jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        finite = tx.update([torch.from_numpy(g[n]) for n in tx.names], state)
        assert bool(finite)
        want = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray,
                                                            jparams))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=n)
    for n, p in model.named_parameters():
        if n in frozen0:
            assert torch.equal(p.detach(), frozen0[n]), n
    assert int(state["count"]) == 3


def test_nan_batch_changes_nothing(setup):
    """A batch whose loss is not finite: the parameters, Adam's moments and
    its step count, which also drives the schedule, are all left as they
    were."""
    _, tcfg, params, batch = setup
    model = _model(tcfg, params)
    tt = ttrain.TrainConfig(subsample="grid", max_tc=200)
    tx, state = ttrain.init_train_state(model, tt)
    step = ttrain.make_train_step(model, tcfg, tt, tx)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    step(state, tb)                       # one good step: moments non-zero
    before = [p.detach().clone() for p in model.parameters()]
    moments = [m.clone() for m in state["mu"] + state["nu"]]
    count = int(state["count"])
    bad = dict(tb, img2=torch.full_like(tb["img2"], float("nan")))
    loss = step(state, bad)
    assert not torch.isfinite(loss)
    assert all(torch.equal(a, b.detach())
               for a, b in zip(before, model.parameters()))
    assert all(torch.equal(a, b) for a, b in zip(moments,
                                                 state["mu"] + state["nu"]))
    assert int(state["count"]) == count == 1
    assert int(state["notfinite_count"]) == 1


def test_random_rect_mask_bounds():
    for i in range(5):
        m = ttrain._random_rect_mask(torch.Generator().manual_seed(i), 32,
                                     48)
        frac = m.float().mean().item()
        assert m.shape == (1, 32, 48)
        assert 0.05 < frac <= 0.85, frac


def test_random_rect_mask_matches_jax_on_given_draws():
    """The mask arithmetic on the uniform draws the JAX function makes."""
    for i in range(3):
        key = jax.random.PRNGKey(i)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        u = np.array([[float(jax.random.uniform(k, ())) for k in
                       (k1, k2, k3, k4)]], np.float32)
        want = np.asarray(jtrain._random_rect_mask(key, 32, 48))
        got = ttrain.rect_mask_from_draws(torch.from_numpy(u), 32, 48)[0]
        # the JAX function scales its draws with its own rounding: allow
        # the mask's edge to move by one pixel
        assert (got.numpy() != want).mean() < 0.05


def test_synth_arithmetic_matches_jax_on_given_draws():
    """The four-corner homography, the render and the jitter on given
    draws, against the JAX package's arithmetic."""
    rng = np.random.default_rng(6)
    B, H, W = 3, 48, 64
    shift = rng.uniform(-1, 1, (B, 4, 2)).astype(np.float32)
    trans = rng.uniform(-1, 1, (B, 1, 2)).astype(np.float32)
    got = tsynth.homographies_from_draws(
        torch.from_numpy(shift), torch.from_numpy(trans), H, W,
        max_corner_shift=0.2, max_translation=0.1).numpy()
    corners = np.array([[0.0, 0.0], [W - 1.0, 0.0], [W - 1.0, H - 1.0],
                        [0.0, H - 1.0]], np.float32)
    size = np.array([W, H], np.float32)
    warped = corners + shift * size * 0.2 + trans * size * 0.1
    want = np.stack([np.asarray(jhom.find_homography_wls_qr(
        jnp.asarray(corners[None]), jnp.asarray(warped[b:b + 1]))[0])
        for b in range(B)])
    for b in range(B):
        p = want[b] @ np.vstack([corners.T, np.ones(4)])
        q = got[b] @ np.vstack([corners.T, np.ones(4)])
        assert np.abs(p[:2] / p[2] - q[:2] / q[2]).max() < CORNER_PX
        assert np.abs(q[:2] / q[2] - warped[b].T).max() < CORNER_PX

    imgs = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    hs = want.astype(np.float32)
    rendered = twarp.warp_perspective_fast(torch.from_numpy(imgs),
                                           torch.from_numpy(hs)).numpy()
    ref = np.asarray(jwarp.warp_perspective(jnp.asarray(imgs),
                                            jnp.asarray(hs)))
    ct = twarp.perspective_coords(torch.from_numpy(hs), (H, W)).numpy()
    cj = np.asarray(jwarp.perspective_coords(jnp.asarray(hs), (H, W)))
    step = max(np.abs(np.diff(imgs, axis=1)).max(),
               np.abs(np.diff(imgs, axis=2)).max())
    bound = 4 * np.spacing(np.float32(255)) + 2 * np.abs(ct - cj).max() * step
    assert np.abs(rendered - ref).max() <= bound

    draws = tsynth.synth_draws(torch.Generator().manual_seed(7), 64, 8, 8)
    assert 0.8 <= draws["gain"].min() and draws["gain"].max() < 1.2
    assert -20 <= draws["bias"].min() and draws["bias"].max() < 20
    assert abs(draws["noise"].std().item() - 3.0) < 0.1
    g, b_, n = (draws[k][:B, 0].numpy() for k in ("gain", "bias", "noise"))
    img = rng.uniform(0, 255, (B, 8, 8, 3)).astype(np.float32)
    jit = np.clip(img * g[:, None, None, None] + b_[:, None, None, None] + n,
                  0.0, 255.0)
    out = tsynth.photometric(torch.from_numpy(img), *(
        torch.from_numpy(x) for x in (g, b_, n))).numpy()
    np.testing.assert_allclose(out, jit, atol=1e-4, rtol=0)
    assert out.min() >= 0 and out.max() <= 255
