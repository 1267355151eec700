"""Parity of the port's WeightedRAFT with ``woft_tpu`` on the CPU, with one
set of seeded ``init_raft_params`` weights carried across by the bridge.

Tolerances: flow 1e-3 px (float32 convolutions in two libraries over a few
GRU iterations); weight logits and sigmoided weights 1e-4; template
features 1e-4 relative; the bridge round trip exact. The block-local
correlation (``corr_impl='local'``) is held to the same float32 tolerances
against the JAX package's Pallas path in interpret mode. bf16 mode has its
own bound, stated at its test.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_corr_impls import _interpret_pallas

from woft_tpu.models import raft as jraft
from woft_tpu.models.convert import params_to_torch_statedict
from woft_tpu.ops.pallas import gru as pgru
from woft_tpu.ops.pallas import local_corr as plc
from woft_tpu.ops.pallas import local_lookup as pll
from woft_tpu.ops.pallas import update_tail as ptail
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import (params_from_jax_numpy,
                                           params_to_jax_numpy)


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
ITERS = 3
FLOW_TOL = 1e-3
W_TOL = 1e-4
# bf16 mode: both packages round at the same places, but their convolutions
# sum in different orders before each rounding, so the two bf16 results are
# two independent perturbations of the float32 result. Each lies about
# d = |JAX bf16 - JAX float32| from it, so they lie within about 2 d of each
# other; 3 d leaves headroom for the few values that round the other way.
BF16_MULTIPLE = 3.0


def interpret_pallas():
    """The block-local and fused-loop Pallas kernels in interpret mode
    (CPU)."""
    return _interpret_pallas(plc, pll, pgru, ptail)


def local_cfgs(precision="highest", fused=False):
    """The two packages' configs of the block-local path (margin 8 for the
    small test frames); ``fused``: with the fused refinement loop."""
    jcfg = jraft.RaftConfig(variant="weighted", iters=ITERS,
                            corr_impl="local", local_margin=8,
                            local_pallas=True, precision=precision,
                            gru_pallas=fused, tail_pallas=fused)
    tcfg = traft.RaftConfig(iters=ITERS, corr_impl="local", local_margin=8,
                            precision=precision, gru_fused=fused,
                            tail_fused=fused)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    """The port's seeded weights, carried to JAX through the bridge."""
    jcfg = jraft.RaftConfig(variant="weighted", iters=ITERS)
    tcfg = traft.RaftConfig(iters=ITERS)
    model = traft.init_raft_params(tcfg, seed=3)
    tree = params_to_jax_numpy(model.state_dict())
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, jp, tree, tcfg, model


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2))
    flow_init = rng.uniform(-3, 3, (1, 8, 12, 2)).astype(np.float32)
    return img1, img2, flow_init


def test_bridge_round_trip(models):
    """tree -> state dict equals woft_tpu's own exporter and the model's
    state dict (aliases and step counters included); a fresh model
    strict-loads it and gives the tree back."""
    _, _, tree, tcfg, model = models
    sd = params_from_jax_numpy(tree)
    ref = params_to_torch_statedict(tree)
    assert set(sd) == set(ref) == set(model.state_dict())
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), v)
    assert "fnet.layer2.0.norm3.weight" not in sd       # instance norm
    assert "cnet.layer2.0.norm3.running_var" in sd      # alias of downsample.1
    fresh = traft.WeightedRAFT(tcfg)
    fresh.load_state_dict(sd, strict=True)
    back = params_to_jax_numpy(fresh.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


def test_seeded_init_has_reference_structure(models):
    """The port's seeded init has the JAX init's tree and shapes, and the
    same seed gives the same weights."""
    jcfg, _, tree, tcfg, _ = models
    want = jax.eval_shape(lambda key: jraft.init_raft_params(key, jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree_util.tree_map(np.shape, tree) == \
        jax.tree_util.tree_map(lambda s: s.shape, want)
    again = params_to_jax_numpy(traft.init_raft_params(tcfg, seed=3)
                                .state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, again, tree)


def test_encode_template(models, frames):
    jcfg, jp, _, tcfg, model = models
    img1 = frames[0]
    tf = traft.encode_template(model, tcfg, torch.from_numpy(img1))
    jf = jraft.encode_template(jp, jcfg, jnp.asarray(img1))
    for t, j in zip(tf, jf):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_dense_forward(models, frames):
    jcfg, jp, _, tcfg, model = models
    img1, img2, flow_init = frames
    oj = jraft.weighted_raft_forward(jp, jcfg, jnp.asarray(img1),
                                     jnp.asarray(img2),
                                     flow_init=jnp.asarray(flow_init))
    ot = traft.weighted_raft_forward(model, tcfg, torch.from_numpy(img1),
                                     torch.from_numpy(img2),
                                     flow_init=torch.from_numpy(flow_init))
    for key, tol in (("flow", FLOW_TOL), ("flow_up", FLOW_TOL),
                     ("weights", W_TOL), ("weights_up", W_TOL),
                     ("mean_response", 1e-4)):
        assert ot[key].shape == oj[key].shape, key
        np.testing.assert_allclose(ot[key].numpy(), np.asarray(oj[key]),
                                   atol=tol, rtol=0, err_msg=key)
    # the test moves the flow well away from zero
    assert np.abs(np.asarray(oj["flow"])).max() > 1.0


def test_sparse_weight_head(models, frames):
    """template_feats + sparse_weight_head: the same flow, and
    weight_head_at equal to the JAX closure and to the port's dense head."""
    jcfg, jp, _, tcfg, model = models
    img1, img2, flow_init = frames
    jf = jraft.encode_template(jp, jcfg, jnp.asarray(img1))
    oj = jraft.weighted_raft_forward(jp, jcfg, None, jnp.asarray(img2),
                                     flow_init=jnp.asarray(flow_init),
                                     template_feats=jf,
                                     sparse_weight_head=True)
    tf = traft.encode_template(model, tcfg, torch.from_numpy(img1))
    ot = traft.weighted_raft_forward(model, tcfg, None,
                                     torch.from_numpy(img2),
                                     flow_init=torch.from_numpy(flow_init),
                                     template_feats=tf,
                                     sparse_weight_head=True)
    np.testing.assert_allclose(ot["flow_up"].numpy(),
                               np.asarray(oj["flow_up"]), atol=FLOW_TOL,
                               rtol=0)
    np.testing.assert_allclose(ot["up_mask"].numpy(),
                               np.asarray(oj["up_mask"]), atol=W_TOL, rtol=0)
    cells = np.array([0, 11, 95, 40, 40, 57, 3], np.int64)
    got = ot["weight_head_at"](torch.from_numpy(cells)).numpy()
    want = np.asarray(oj["weight_head_at"](jnp.asarray(cells, jnp.int32)))
    np.testing.assert_allclose(got, want, atol=W_TOL, rtol=0)

    dense = traft.weighted_raft_forward(
        model, tcfg, None, torch.from_numpy(img2),
        flow_init=torch.from_numpy(flow_init), template_feats=tf)
    np.testing.assert_allclose(
        got, dense["weights"].reshape(-1)[cells].numpy(), atol=1e-6, rtol=0)


def jax_local_forward(models, frames, precision, fused=False):
    """The JAX package's block-local forward (Pallas path, interpret mode)
    as float32 numpy arrays."""
    jp = models[1]
    img1, img2, flow_init = frames
    jcfg, _ = local_cfgs(precision, fused)
    with interpret_pallas():
        oj = jraft.weighted_raft_forward(jp, jcfg, jnp.asarray(img1),
                                         jnp.asarray(img2),
                                         flow_init=jnp.asarray(flow_init))
        return {k: np.asarray(v, np.float32) for k, v in oj.items()}


@pytest.fixture(scope="module")
def jax_local_highest(models, frames):
    return jax_local_forward(models, frames, "highest")


def test_local_dense_forward(models, frames, jax_local_highest):
    """``corr_impl='local'`` in float32: build (C), guarded blocked lookups
    (D, E), blocked convc1, the dense head on ``to_natural()``."""
    model = models[4]
    img1, img2, flow_init = frames
    _, tcfg = local_cfgs()
    oj = jax_local_highest
    ot = traft.weighted_raft_forward(model, tcfg, torch.from_numpy(img1),
                                     torch.from_numpy(img2),
                                     flow_init=torch.from_numpy(flow_init))
    for key, tol in (("flow", FLOW_TOL), ("flow_up", FLOW_TOL),
                     ("weights", W_TOL), ("weights_up", W_TOL),
                     ("mean_response", 1e-4)):
        assert ot[key].shape == oj[key].shape, key
        np.testing.assert_allclose(ot[key].numpy(), oj[key], atol=tol,
                                   rtol=0, err_msg=key)
    assert np.abs(oj["flow"]).max() > 1.0
    # within the margin the local path is the dense path
    dense = traft.weighted_raft_forward(
        model, models[3], torch.from_numpy(img1), torch.from_numpy(img2),
        flow_init=torch.from_numpy(flow_init))
    np.testing.assert_allclose(ot["flow_up"].numpy(),
                               dense["flow_up"].numpy(), atol=FLOW_TOL,
                               rtol=0)


def test_local_sparse_weight_head(models, frames):
    """``corr_impl='local'`` with template features and the sparse head:
    one more dense lookup at the final coordinates, then a row select."""
    _, jp, _, _, model = models
    img1, img2, flow_init = frames
    jcfg, tcfg = local_cfgs()
    cells = np.array([0, 11, 95, 40, 40, 57, 3], np.int64)
    with interpret_pallas():
        jf = jraft.encode_template(jp, jcfg, jnp.asarray(img1))
        oj = jraft.weighted_raft_forward(jp, jcfg, None, jnp.asarray(img2),
                                         flow_init=jnp.asarray(flow_init),
                                         template_feats=jf,
                                         sparse_weight_head=True)
        want = np.asarray(oj["weight_head_at"](jnp.asarray(cells, jnp.int32)))
    tf = traft.encode_template(model, tcfg, torch.from_numpy(img1))
    ot = traft.weighted_raft_forward(model, tcfg, None,
                                     torch.from_numpy(img2),
                                     flow_init=torch.from_numpy(flow_init),
                                     template_feats=tf,
                                     sparse_weight_head=True)
    np.testing.assert_allclose(ot["flow_up"].numpy(),
                               np.asarray(oj["flow_up"]), atol=FLOW_TOL,
                               rtol=0)
    np.testing.assert_allclose(ot["up_mask"].numpy(),
                               np.asarray(oj["up_mask"]), atol=W_TOL, rtol=0)
    got = ot["weight_head_at"](torch.from_numpy(cells)).numpy()
    np.testing.assert_allclose(got, want, atol=W_TOL, rtol=0)
    dense = traft.weighted_raft_forward(
        model, tcfg, None, torch.from_numpy(img2),
        flow_init=torch.from_numpy(flow_init), template_feats=tf)
    np.testing.assert_allclose(
        got, dense["weights"].reshape(-1)[cells].numpy(), atol=1e-6, rtol=0)


def test_local_falls_back_to_dense_for_a_batch(models, frames):
    """B > 1 with ``corr_impl='local'`` takes the dense pyramid."""
    _, _, _, tcfg0, model = models
    img1, img2, _ = frames
    _, tcfg = local_cfgs()
    pair = [torch.from_numpy(np.concatenate([a, a[:, ::-1]]))
            for a in (img1, img2)]
    got = traft.weighted_raft_forward(model, tcfg, *pair)
    want = traft.weighted_raft_forward(model, tcfg0, *pair)
    np.testing.assert_array_equal(got["flow_up"].numpy(),
                                  want["flow_up"].numpy())


def test_local_forward_on_the_cpu_is_eager(models, frames):
    """The block-local volume and loop are replayed from a CUDA graph on the
    card only (``models/loop_graph.py``): on the CPU every forward runs the
    code, keeps no graph, and a second forward equals the first."""
    from woft_tpu_torch.models import loop_graph
    _, _, _, _, model = models
    img1, img2, _ = frames
    _, tcfg = local_cfgs("bf16")
    pair = [torch.from_numpy(a) for a in (img1, img2)]
    first = traft.weighted_raft_forward(model, tcfg, *pair)
    again = traft.weighted_raft_forward(model, tcfg, *pair)
    assert loop_graph.captured(model) == 0
    for key in ("flow_up", "weights"):
        assert torch.equal(first[key], again[key])


def test_bf16_mode_within_bound_of_jax(models, frames, jax_local_highest):
    """``precision='bf16'`` on the block-local path (the ``WOFT_fast``
    flow): the port's result lies within BF16_MULTIPLE times the distance
    between the JAX package's own bf16 and float32 results of the JAX bf16
    result. The parameters stay float32 (casts happen at use)."""
    _, _, tree, _, model = models
    img1, img2, flow_init = frames
    outs = {"highest": jax_local_highest,
            "bf16": jax_local_forward(models, frames, "bf16")}
    _, tcfg = local_cfgs("bf16")
    ot = traft.weighted_raft_forward(model, tcfg, torch.from_numpy(img1),
                                     torch.from_numpy(img2),
                                     flow_init=torch.from_numpy(flow_init))
    for key in ("flow", "flow_up", "weights", "weights_up"):
        assert ot[key].dtype == torch.float32, key
        d = np.abs(outs["bf16"][key] - outs["highest"][key]).max()
        assert d > 0, key
        err = np.abs(ot[key].numpy() - outs["bf16"][key]).max()
        assert err <= BF16_MULTIPLE * d, (key, err, d)
    # mean_response is float32 arithmetic on bf16-mode features
    d = np.abs(outs["bf16"]["mean_response"]
               - outs["highest"]["mean_response"]).max()
    err = np.abs(ot["mean_response"].numpy()
                 - outs["bf16"]["mean_response"]).max()
    assert err <= BF16_MULTIPLE * d, (err, d)
    # the same float32 parameters serve both modes
    back = params_to_jax_numpy(model.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    assert all(v.dtype == torch.float32 for k, v in model.state_dict().items()
               if not k.endswith("num_batches_tracked"))


def test_fused_loop_within_bound_of_jax(models, frames, jax_local_highest):
    """The slice as a whole: the block-local bf16 forward with the fused
    refinement loop (``gru_fused``, ``tail_fused``: kernels G and I, here
    their plain versions) against the JAX package's forward with
    ``gru_pallas`` and ``tail_pallas`` in interpret mode, held to the bound
    of ``test_bf16_mode_within_bound_of_jax``."""
    model = models[4]
    img1, img2, flow_init = frames
    oj = jax_local_forward(models, frames, "bf16", fused=True)
    _, tcfg = local_cfgs("bf16", fused=True)
    assert tcfg.gru_fused and tcfg.tail_fused
    ot = traft.weighted_raft_forward(model, tcfg, torch.from_numpy(img1),
                                     torch.from_numpy(img2),
                                     flow_init=torch.from_numpy(flow_init))
    for key in ("flow", "flow_up", "weights", "weights_up"):
        assert ot[key].dtype == torch.float32, key
        d = np.abs(oj[key] - jax_local_highest[key]).max()
        assert d > 0, key
        err = np.abs(ot[key].numpy() - oj[key]).max()
        assert err <= BF16_MULTIPLE * d, (key, err, d)
    # the fused loop is another path than the unfused one, not a no-op
    _, unfused = local_cfgs("bf16")
    ou = traft.weighted_raft_forward(model, unfused, torch.from_numpy(img1),
                                     torch.from_numpy(img2),
                                     flow_init=torch.from_numpy(flow_init))
    assert not torch.equal(ot["flow"], ou["flow"])


def test_bf16_mode_dense_corr_runs(models, frames):
    """``precision='bf16'`` with the dense pyramid (bf16 levels, as in the
    reference): finite, and close to the float32 flow."""
    _, _, _, tcfg0, model = models
    img1, img2, flow_init = frames
    tcfg = traft.RaftConfig(iters=ITERS, precision="bf16")
    args = (torch.from_numpy(img1), torch.from_numpy(img2))
    got = traft.weighted_raft_forward(model, tcfg, *args,
                                      flow_init=torch.from_numpy(flow_init))
    want = traft.weighted_raft_forward(model, tcfg0, *args,
                                       flow_init=torch.from_numpy(flow_init))
    assert torch.isfinite(got["flow_up"]).all()
    assert (got["flow_up"] - want["flow_up"]).abs().max() < 0.05


def test_raft_config_rejects_unknown_modes():
    with pytest.raises(ValueError):
        traft.RaftConfig(corr_impl="onehot")
    with pytest.raises(ValueError):
        traft.RaftConfig(precision="fp16")
    with pytest.raises(ValueError):
        traft.RaftConfig(variant="small")


def test_convex_upsample_matches():
    rng = np.random.default_rng(5)
    flow = rng.normal(size=(2, 5, 7, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 7, 576)).astype(np.float32)
    got = traft.convex_upsample(torch.from_numpy(flow).permute(0, 3, 1, 2),
                                torch.from_numpy(mask).permute(0, 3, 1, 2))
    want = np.asarray(jraft.convex_upsample(jnp.asarray(flow),
                                            jnp.asarray(mask)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-5, rtol=0)


def test_raft_flow_wrapper(tmp_path):
    """``RaftFlow`` loads a torch-readable state dict (with the reference's
    ``module.`` prefix) and returns the forward's flow in both modes."""
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow

    cfg = traft.RaftConfig(iters=2)
    model = traft.init_raft_params(cfg, seed=5)
    path = tmp_path / "wraft.pt"
    torch.save({f"module.{k}": v for k, v in model.state_dict().items()},
               path)
    conf = load_config(ROOT / "woft_tpu_torch" / "configs" / "flow"
                       / "wraft_large.py")
    conf.iters = 2
    conf.model = str(path)
    flower = RaftFlow(conf, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(flower.model.state_dict()[k], v), k

    rng = np.random.default_rng(6)
    bgr1 = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    bgr2 = np.roll(bgr1, 2, axis=1)
    ref = traft.weighted_raft_forward(
        model, cfg, *(torch.from_numpy(b[:, :, ::-1].astype(np.float32))[None]
                      for b in (bgr1, bgr2)))
    flow, weights = flower.compute_flow(bgr1, bgr2, mode="flow",
                                        numpy_out=True, do_sigmoid=True)
    np.testing.assert_array_equal(flow, ref["flow_up"][0].permute(2, 0, 1))
    np.testing.assert_array_equal(
        weights, torch.sigmoid(ref["weights_up"][0, ..., 0]))
    src, dst, logits = flower.compute_flow(bgr1, bgr2, mode="TC",
                                           numpy_out=True)
    np.testing.assert_allclose(dst - src, flow.reshape(2, -1), atol=1e-5)
    np.testing.assert_array_equal(logits,
                                  ref["weights_up"][0].reshape(1, -1))
