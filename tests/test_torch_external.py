"""The external flow backend (``flow/external.py``, the LiteFlowNet2 role of
ablations 10-12) and the config family's last twins, against ``woft_tpu``
on the CPU.

Tolerances: the cost volume 1e-5 of its largest value (the same float32
products summed in another order); head logits 1e-4; flow 1e-3 px;
per-frame H 0.05 px at the template corners (as in
``test_torch_tracker.py``).
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.config import load_config as jload_config
from woft_tpu.flow import external as jext
from woft_tpu.models import raft as jraft
from woft_tpu.tracker import woft as jw
from woft_tpu_torch.config import load_config
from woft_tpu_torch.flow import external as text
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_to_jax_numpy
from woft_tpu_torch.models.layers import init_conv_
from woft_tpu_torch.ops.warp import warp_perspective
from woft_tpu_torch.tracker import woft as tw

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "woft_tpu_torch" / "configs"
JCONFIGS = ROOT / "woft_tpu" / "configs"
FLOW_TOL = 1e-3
LOGIT_TOL = 1e-4
CORNER_TOL = 0.05
CORNERS = np.array([[24, 16], [71, 16], [71, 47], [24, 47]], float).T


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs (torch's default of one a
    core makes small operations wait on each other's threads under the
    suite's parallel workers); the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def corner_err(Ha, Hb):
    def proj(H):
        p = np.asarray(H, np.float64) @ np.vstack([CORNERS, np.ones(4)])
        return p[:2] / p[2:]
    return np.linalg.norm(proj(Ha) - proj(Hb), axis=0).max()


@pytest.fixture(scope="module")
def head():
    """A seeded cost-volume weight head in the port and as a JAX tree."""
    head = traft.WeightHead(text.HEAD_STRUCTURE, 1)
    gen = torch.Generator().manual_seed(5)
    for mod in head.net:
        if isinstance(mod, torch.nn.Conv2d):
            init_conv_(mod, gen)
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  params_to_jax_numpy(head.state_dict()))
    return head.eval(), tree


def test_local_cost_volume_matches_jax():
    """The 7x7 windowed correlation, zero padding, channel dy*7 + dx."""
    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(2, 6, 9, 64)).astype(np.float32)
    f2 = rng.normal(size=(2, 6, 9, 64)).astype(np.float32)
    got = text.local_cost_volume(torch.from_numpy(f1),
                                 torch.from_numpy(f2)).numpy()
    want = np.asarray(jext.local_cost_volume(jnp.asarray(f1),
                                             jnp.asarray(f2)))
    assert got.shape == want.shape == (2, 6, 9, 49)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_cost_volume_weight_head_matches_jax(head):
    module, tree = head
    cv = np.random.default_rng(2).normal(size=(1, 6, 9, 49)).astype(
        np.float32)
    got = text.cost_volume_weight_head(module, torch.from_numpy(cv))
    want = np.asarray(jext.cost_volume_weight_head(tree, jnp.asarray(cv)))
    assert got.shape == want.shape == (1, 6, 9, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=LOGIT_TOL,
                               rtol=0)


def _scene():
    rng = np.random.default_rng(0)
    template = rng.uniform(0, 255, (64, 96, 3)).astype(np.float32)
    mask = np.zeros((64, 96), bool)
    mask[16:48, 24:72] = True
    h = np.array([[1.0, 0.01, 1.5], [0.0, 1.0, -0.8], [0, 0, 1.0]],
                 np.float32)
    frame = warp_perspective(torch.from_numpy(template)[None],
                             torch.from_numpy(h)).numpy()
    return template, mask, frame


def _zeros_init(key, cfg):
    """``init_raft_params``' tree as zeros, from its shapes alone: the
    backend's checkpoint overwrites every tensor of an 'orig' RAFT, and
    drawing 5.5 M seeded values costs JAX 10-14 s on the CPU."""
    return jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jax.eval_shape(lambda k: _JAX_INIT(k, cfg), key))


_JAX_INIT = jraft.init_raft_params


def _wrappers(config, monkeypatch, **overrides):
    """The port's and the JAX package's ``ExternalFlowWrapper`` under the
    twin configs, the backend cut to 2 iterations. Both backends load the
    v3 export (the JAX side through its torch-checkpoint loader, non-strict
    as for the orbax tree: ``test_torch_weights.py`` holds the export to
    the orbax checkpoint bit for bit, and restoring orbax here would cost
    most of the module's time) over a zero init (``_zeros_init``)."""
    monkeypatch.setattr(jraft, "init_raft_params", _zeros_init)
    conf = load_config(CONFIGS / config).flow_config
    jconf = jload_config(JCONFIGS / config).flow_config
    jconf.backend_model = conf.backend_model
    assert Path(conf.backend_model).name == "wraft_tpu_v3_torch.pt"
    for c in (conf, jconf):
        c.backend_iters = 2
        for k, v in overrides.items():
            setattr(c, k, v)
    return (text.ExternalFlowWrapper(conf, device="cpu"),
            jext.ExternalFlowWrapper(jconf))


def test_ablation_10_step_matches_jax(monkeypatch):
    """``ablation_10``: the external backend ('orig' RAFT on the trained v3
    backbone, the weight head dropped) through the tracker's flow seam,
    uniform weights,
    plain QR (``redetection='always'``: one flow, one compile; the seam's
    fallback is ``test_torch_flow_family_steps.py``'s)."""
    twrap, jwrap = _wrappers("ablation_10.py", monkeypatch)
    assert twrap.head is None and not hasattr(twrap.model, "weight_head")
    template, mask, frame = _scene()
    tp = dict(estimator="plain_qr", redetection="always")
    jtp = jw.TrackerParams(**tp)
    jstate = jw.tracker_init_state({}, None, jtp,
                                   jnp.asarray(template)[None],
                                   jnp.asarray(mask), encode=False)
    _, Hj, mj = jw.build_track_step(jraft.RaftConfig(), jtp,
                                    flow_fn=jwrap.make_flow_fn())(
        jwrap.params, jstate, jnp.asarray(frame))
    ttp = tw.TrackerParams(**tp)
    tstate = tw.tracker_init_state(None, traft.RaftConfig(), ttp,
                                   torch.from_numpy(template)[None],
                                   torch.from_numpy(mask), encode=False)
    _, Ht, mt = tw.build_track_step(traft.RaftConfig(), ttp,
                                    flow_fn=twrap.make_flow_fn())(
        twrap.model, tstate, torch.from_numpy(frame))
    assert corner_err(mt["H_global_cur2init"].numpy(),
                      np.asarray(mj["H_global_cur2init"])) < CORNER_TOL
    assert corner_err(Ht.numpy(), np.asarray(Hj)) < CORNER_TOL


def test_weight_head_flow_matches_jax(head, tmp_path, monkeypatch):
    """With a head checkpoint (a seeded one: the trained head is not in the
    repository): the seam's flow and sigmoided, upsampled weights against
    JAX's, and ``compute_flow``'s outputs."""
    path = tmp_path / "head.pth"
    torch.save(head[0].state_dict(), path)
    twrap, jwrap = _wrappers("ablation_12.py", monkeypatch, model=path)
    _, _, frame = _scene()
    img1 = np.random.default_rng(0).uniform(0, 255, (1, 64, 96, 3)).astype(
        np.float32)
    jflow, jw_ = jax.jit(jwrap.make_flow_fn())(
        jwrap.params, jnp.asarray(img1), jnp.asarray(frame))
    tflow, tw_ = twrap.make_flow_fn()(None, torch.from_numpy(img1),
                                      torch.from_numpy(frame))
    np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow),
                               atol=FLOW_TOL, rtol=0)
    np.testing.assert_allclose(tw_.numpy(), np.asarray(jw_), atol=LOGIT_TOL,
                               rtol=0)
    bgr1 = img1[0, :, :, ::-1].astype(np.uint8)
    bgr2 = frame[0, :, :, ::-1].astype(np.uint8)
    flow, weights = twrap.compute_flow(bgr1, bgr2, mode="flow",
                                       numpy_out=True, do_sigmoid=True)
    assert flow.shape == (2, 64, 96) and weights.shape == (64, 96)
    src, dst, logits = twrap.compute_flow(bgr1, bgr2, mode="TC")
    np.testing.assert_allclose((dst - src).numpy(), flow.reshape(2, -1),
                               atol=1e-5)
    np.testing.assert_allclose(torch.sigmoid(logits).numpy(),
                               weights.reshape(1, -1), atol=1e-6)


@pytest.mark.parametrize("config", ["ablation_12.py",
                                    "WOFT_liteflownet2.py"])
def test_missing_head_checkpoint_raises(config):
    """The trained head is not in the repository: its tracker raises at
    construction, naming the file."""
    conf = load_config(CONFIGS / config)
    with pytest.raises(FileNotFoundError,
                       match="liteflownet2_v2/wraft_weights-ep04-end.pth"):
        tw.WOFTTracker(conf, device="cpu")


# --------------------------------------------------------------------------
# the config family's last twins
# --------------------------------------------------------------------------

NEW_CONFIGS = ("WOFT_origraft.py", "WOFT_masked.py", "WOFT_rep.py",
               "ablation_07.py", "ablation_10.py", "ablation_11.py",
               "ablation_12.py", "WOFT_liteflownet2.py",
               "WOFT_liteflownet2_noweights.py",
               "WOFT_liteflownet2_noweights_cvransac.py")


def test_every_reference_config_has_a_twin():
    """Each config file of the JAX package has its port twin, and it
    loads."""
    for rel in sorted(p.relative_to(JCONFIGS)
                      for p in JCONFIGS.rglob("*.py")):
        assert (CONFIGS / rel).is_file(), rel
        if rel.name != "__init__.py" and not rel.name.startswith("_"):
            assert load_config(CONFIGS / rel) is not None, rel


@pytest.mark.parametrize("name", NEW_CONFIGS)
def test_new_config_matches_jax(name):
    """Tracker parameters, padding and the flow config's choices (the
    network variant, iterations, the head) equal the JAX twin's."""
    conf, jconf = load_config(CONFIGS / name), jload_config(JCONFIGS / name)
    for field in ("estimator", "redetection", "downscale", "subsample_n",
                  "padding_mode", "sparse_weights", "no_local_h"):
        assert getattr(conf.tracker_params, field) == \
            getattr(jconf.tracker_params, field), field
    fc, jfc = conf.flow_config, jconf.flow_config
    for field in ("raft_type", "iters", "padding_mode", "precision",
                  "use_weight_head", "backend_iters", "patch"):
        # an unset key reads as an empty (falsy) Config in both packages
        assert (getattr(fc, field) or None) == (getattr(jfc, field) or None), \
            field
    assert fc.of_class.__name__ == jfc.of_class.__name__
