"""The rest of the flow-network family against ``woft_tpu`` on the CPU: the
bf16 dense pyramid and kernel B's plain version on it, ``precision=
'default'``, the 'orig' and 'weighted_masked' variants, and the alternate
(volume-free) correlation. One set of seeded port weights is carried to
JAX through the bridge, inputs are seeded numpy arrays.

Tolerances: flow 1e-3 px and weight, mask and mean-response logits 1e-4
(float32 convolutions in two libraries over 2 GRU iterations, as in
``test_torch_raft.py``); lookups 1e-5 of the largest value (the same
float32 blend, summed in another order); the bf16 pyramid equal to JAX's or
one bf16 ulp away where the two float32 products round across a bf16 step;
``'default'`` within ``BF16_MULTIPLE`` times the distance between JAX's own
'default' and float32 results.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from test_corr_impls import _interpret_pallas

from woft_tpu.models import corr as jcorr
from woft_tpu.models import raft as jraft
from woft_tpu.ops.pallas import corr_lookup as pcl
from woft_tpu_torch.models import corr as tcorr
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import (params_from_jax_numpy,
                                           params_to_jax_numpy)

ITERS = 2
FLOW_TOL = 1e-3
LOGIT_TOL = 1e-4
LOOKUP_REL = 1e-5
BF16_MULTIPLE = 3.0          # see test_torch_raft.py
MASK_HEAD = ((32, 3), (32, 3))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs (torch's default of one a
    core makes small operations wait on each other's threads under the
    suite's parallel workers); the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    return (jraft.RaftConfig(iters=ITERS, **kw),
            traft.RaftConfig(iters=ITERS, **kw))


def _carried(tcfg, seed=3):
    """The port's seeded model of ``tcfg`` and its JAX parameter tree."""
    model = traft.init_raft_params(tcfg, seed=seed)
    return model, jax.tree_util.tree_map(
        jnp.asarray, params_to_jax_numpy(model.state_dict()))


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2))
    return img1, img2


@pytest.fixture(scope="module")
def weighted():
    return _carried(traft.RaftConfig(iters=ITERS))


def _jax_forward(jcfg, jp, img1, img2):
    out = jax.jit(lambda p, a, b: jraft.weighted_raft_forward(
        p, jcfg, a, b))(jp, jnp.asarray(img1), jnp.asarray(img2))
    return {k: np.asarray(v) for k, v in out.items()}


def _port_forward(model, tcfg, img1, img2, **kw):
    return traft.weighted_raft_forward(model, tcfg, torch.from_numpy(img1),
                                       torch.from_numpy(img2), **kw)


# --------------------------------------------------------------------------
# the bf16 dense pyramid and kernel B's plain version on it
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(1)
    f1 = rng.normal(size=(1, 8, 12, 256)).astype(np.float32)
    f2 = rng.normal(size=(1, 8, 12, 256)).astype(np.float32)
    return f1, f2


def _ulp_bf16(x):
    """One bf16 ulp at the magnitude of each entry of ``x``."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return 2.0 ** (e - 7)


def test_bf16_pyramid_matches_jax(features):
    """``corr_pyramid_fused(out_dtype=bf16)``: each level computed in
    float32 from float32 features, then rounded once, as
    ``woft_tpu/models/corr.py:corr_pyramid_fused`` does. Entries equal
    JAX's or lie one bf16 ulp away, where the two libraries' float32 sums
    differ in their last bits across a rounding boundary."""
    f1, f2 = features
    jp, jm = jcorr.corr_pyramid_fused(jnp.asarray(f1), jnp.asarray(f2), 4,
                                      out_dtype=jnp.bfloat16)
    tp, tm = tcorr.corr_pyramid_fused(torch.from_numpy(f1),
                                      torch.from_numpy(f2), 4,
                                      out_dtype=torch.bfloat16)
    n_diff = n_all = 0
    for t, j in zip(tp, jp):
        assert t.dtype == torch.bfloat16
        t = t.float().numpy()
        j = np.asarray(j.astype(jnp.float32))
        assert t.shape == j.shape
        d = np.abs(t - j)
        assert (d <= _ulp_bf16(j) * 1.0001).all()
        n_diff += int((d > 0).sum())
        n_all += d.size
    share = n_diff / n_all
    print(f"bf16 pyramid: {n_diff} of {n_all} entries one ulp from JAX "
          f"({share:.2%})")
    assert share < 0.01
    assert tm.dtype == torch.float32
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0,
                               atol=LOGIT_TOL * np.abs(np.asarray(jm)).max())


@pytest.fixture(scope="module")
def bf16_levels(features):
    """One bf16 pyramid in both packages (the port's levels carried to JAX
    as the same bf16 values) and query coordinates reaching past every
    border."""
    f1, f2 = features
    tp, _ = tcorr.corr_pyramid_fused(torch.from_numpy(f1),
                                     torch.from_numpy(f2), 4,
                                     out_dtype=torch.bfloat16)
    jp = [jnp.asarray(p.float().numpy()).astype(jnp.bfloat16) for p in tp]
    rng = np.random.default_rng(2)
    coords = np.stack([rng.uniform(-4, 16, (1, 8, 12)),
                       rng.uniform(-4, 12, (1, 8, 12))], -1).astype(
                           np.float32)
    return tp, jp, coords


def _rel_err(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_plain_lookup_on_bf16_levels_matches_pallas_kernel(bf16_levels):
    """The plain version of kernel B on bf16 levels against the JAX
    package's ``fused_corr_lookup`` (interpret mode), which widens its bf16
    strip and blends in float32: dense, and indexed on a subset of rows."""
    tp, jp, coords = bf16_levels
    with _interpret_pallas(pcl):
        want = np.asarray(pcl.fused_corr_lookup(
            pcl.pad_pyramid(jp, 4), jnp.asarray(coords), radius=4))
    got = tcorr.corr_lookup(tp, torch.from_numpy(coords), 4)
    assert got.dtype == torch.float32
    assert _rel_err(got.numpy(), want) <= LOOKUP_REL
    # indexed: rows read in place (duplicates allowed) equal the kernel's
    # lookup of those rows at their own centroids
    cells = np.array([0, 5, 17, 33, 50, 51, 70, 95] * 3)
    c = torch.from_numpy(cells)
    got_rows = tcorr.corr_lookup(
        tp, torch.from_numpy(coords).reshape(-1, 2)[c][None, None], 4,
        rows=c)
    assert _rel_err(got_rows.numpy().reshape(len(cells), -1),
                    want.reshape(96, -1)[cells]) <= LOOKUP_REL


def test_plain_lookup_on_bf16_levels_matches_onehot(bf16_levels):
    """Against ``corr_lookup`` (one-hot), the JAX package's default lookup.
    On a bf16 pyramid it rounds each window's fractions to bf16
    (``_lookup_level_onehot``: ``.astype(corr_l.dtype)``), where kernel B
    and ``fused_corr_lookup`` keep them float32. On centroids whose
    fractions bf16 holds exactly (multiples of 1/32 at level 0, so 1/256
    at level 3) the two agree to 1e-5; elsewhere they differ by at most the
    fractions' rounding, 2^-9 on each axis, times the window's spread:
    2^-7 of the largest value."""
    tp, jp, coords = bf16_levels
    snapped = np.round(coords * 32) / 32
    for c, bound in ((snapped, LOOKUP_REL), (coords, 2.0 ** -7)):
        want = np.asarray(jcorr.corr_lookup(jp, jnp.asarray(c), 4,
                                            impl="onehot"))
        got = tcorr.corr_lookup(tp, torch.from_numpy(c), 4).numpy()
        assert _rel_err(got, want) <= bound


# --------------------------------------------------------------------------
# the forward in 'default' and 'bf16' mode: the bf16 dense pyramid
# --------------------------------------------------------------------------

def test_default_precision_forward_within_bound_of_jax(weighted, frames):
    """``precision='default'`` (float32 activations, the dense pyramid in
    bf16; on the CPU no TF32) against JAX's 'default' on the CPU: within
    BF16_MULTIPLE times JAX's own 'default'-to-float32 distance. The mean
    response stays float32 in both (1e-4)."""
    model, jp = weighted
    img1, img2 = frames
    jd, td = _cfgs(precision="default")
    jh, _ = _cfgs()
    oj = _jax_forward(jd, jp, img1, img2)
    oh = _jax_forward(jh, jp, img1, img2)
    ot = _port_forward(model, td, img1, img2)
    for key in ("flow", "flow_up", "weights", "weights_up"):
        d = np.abs(oj[key] - oh[key]).max()
        assert d > 0, key
        err = np.abs(ot[key].numpy() - oj[key]).max()
        assert err <= BF16_MULTIPLE * d, (key, err, d)
    np.testing.assert_allclose(ot["mean_response"].numpy(),
                               oj["mean_response"], atol=LOGIT_TOL, rtol=0)


def test_default_and_bf16_store_the_pyramid_in_bf16(weighted, frames):
    """The dense branch stores bf16 levels exactly where the reference does
    ('default' and 'bf16'), float32 under 'highest'; the sparse head reads
    the same levels."""
    model, _ = weighted
    img1, img2 = frames
    seen = []
    real = traft.corr_pyramid_fused

    def spy(*a, **kw):
        pyramid, mr = real(*a, **kw)
        seen.append(pyramid[0].dtype)
        return pyramid, mr

    traft.corr_pyramid_fused = spy
    try:
        for precision in ("highest", "default", "bf16"):
            cfg = traft.RaftConfig(iters=1, precision=precision)
            out = _port_forward(model, cfg, img1, img2,
                                sparse_weight_head=True)
            assert out["weight_head_at"](torch.arange(6)).dtype == \
                torch.float32
    finally:
        traft.corr_pyramid_fused = real
    assert seen == [torch.float32, torch.bfloat16, torch.bfloat16]


# --------------------------------------------------------------------------
# the 'orig' and 'weighted_masked' variants
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["orig", "weighted_masked"])
def test_variant_forward_matches_jax(variant, frames):
    """'orig': flow only (the forward returns after ``flow_up``, with the
    feature maps); 'weighted_masked': also the mask head over the template
    features and the current features sampled at the flow's end points,
    upsampled convexly and divided by 8."""
    kw = dict(variant=variant)
    if variant == "weighted_masked":
        kw["mask_head_structure"] = MASK_HEAD
    jcfg, tcfg = _cfgs(**kw)
    model, jp = _carried(tcfg)
    img1, img2 = frames
    oj = _jax_forward(jcfg, jp, img1, img2)
    ot = _port_forward(model, tcfg, img1, img2)
    keys = {"flow": FLOW_TOL, "flow_up": FLOW_TOL, "fmap1": LOGIT_TOL,
            "fmap2": LOGIT_TOL}
    if variant == "orig":
        assert set(oj) == set(keys)
        assert set(ot) == set(keys) | {"mean_response"}
    else:
        keys.update(weights=LOGIT_TOL, weights_up=LOGIT_TOL,
                    mask_up=LOGIT_TOL)
        assert set(oj) <= set(ot)
    for key, tol in keys.items():
        assert ot[key].shape == oj[key].shape, key
        np.testing.assert_allclose(ot[key].numpy(), oj[key], atol=tol,
                                   rtol=0, err_msg=key)


def test_variant_sparse_request_takes_the_dense_head(frames):
    """As in the reference, only 'weighted' has the sparse head: a sparse
    request under 'weighted_masked' returns the dense weights and the
    mask."""
    tcfg = traft.RaftConfig(iters=1, variant="weighted_masked",
                            mask_head_structure=MASK_HEAD)
    model = traft.init_raft_params(tcfg, seed=3)
    out = _port_forward(model, tcfg, *frames, sparse_weight_head=True)
    assert "weight_head_at" not in out
    assert {"weights_up", "mask_up"} <= set(out)


@pytest.mark.parametrize("variant", ["orig", "weighted_masked"])
def test_bridge_carries_variant_trees_both_ways(variant):
    """A JAX tree of the variant (no ``weight_head`` under 'orig',
    ``mask_head.net.*`` under 'weighted_masked') strict-loads into the
    port's model of that variant, and the port's state dict comes back as
    the same tree."""
    kw = dict(variant=variant)
    if variant == "weighted_masked":
        kw["mask_head_structure"] = MASK_HEAD
    jcfg, tcfg = _cfgs(**kw)
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        jax.eval_shape(lambda k: jraft.init_raft_params(k, jcfg),
                       jax.random.PRNGKey(1)))
    assert ("weight_head" in tree) == (variant != "orig")
    assert ("mask_head" in tree) == (variant == "weighted_masked")
    model = traft.WeightedRAFT(tcfg)
    model.load_state_dict(params_from_jax_numpy(tree), strict=True)
    if variant == "weighted_masked":
        np.testing.assert_array_equal(
            model.mask_head.net[0].weight.detach().numpy(),
            tree["mask_head"]["net"]["0"]["weight"].transpose(3, 2, 0, 1))
    back = params_to_jax_numpy(model.state_dict())
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)


# --------------------------------------------------------------------------
# the alternate correlation
# --------------------------------------------------------------------------

def test_alternate_lookup_matches_jax_and_dense(features):
    """``corr_lookup_alternate`` (chunked, no volume) against JAX's and
    against the port's dense lookup on the float32 pyramid of the same
    features, at a chunk that does not divide the queries."""
    f1, f2 = features
    rng = np.random.default_rng(3)
    coords = np.stack([rng.uniform(-4, 16, (1, 8, 12)),
                       rng.uniform(-4, 12, (1, 8, 12))], -1).astype(
                           np.float32)
    got = tcorr.corr_lookup_alternate(
        torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(coords),
        4, 4, chunk=37).numpy()
    want = np.asarray(jcorr.corr_lookup_alternate(
        jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords), 4, 4,
        chunk=37))
    assert _rel_err(got, want) <= LOOKUP_REL
    pyramid, _ = tcorr.corr_pyramid_fused(torch.from_numpy(f1),
                                          torch.from_numpy(f2), 4)
    dense = tcorr.corr_lookup(pyramid, torch.from_numpy(coords), 4).numpy()
    assert _rel_err(got, dense) <= LOOKUP_REL


def test_alternate_forward_and_sparse_head_match_jax(weighted, frames):
    """``alternate_corr=True``: the dense-head forward and the sparse
    head's logits against JAX's, float32."""
    model, jp = weighted
    img1, img2 = frames
    jcfg, tcfg = _cfgs(alternate_corr=True, alt_chunk=50)
    oj = _jax_forward(jcfg, jp, img1, img2)
    ot = _port_forward(model, tcfg, img1, img2)
    for key, tol in (("flow_up", FLOW_TOL), ("weights_up", LOGIT_TOL),
                     ("mean_response", LOGIT_TOL)):
        np.testing.assert_allclose(ot[key].numpy(), oj[key], atol=tol,
                                   rtol=0, err_msg=key)
    cells = np.array([0, 7, 13, 40, 95, 95, 63], np.int32)
    wj = np.asarray(jax.jit(lambda p, a, b, c: jraft.weighted_raft_forward(
        p, jcfg, a, b, sparse_weight_head=True)["weight_head_at"](c))(
            jp, jnp.asarray(img1), jnp.asarray(img2), jnp.asarray(cells)))
    to = _port_forward(model, tcfg, img1, img2, sparse_weight_head=True)
    wt = to["weight_head_at"](torch.from_numpy(cells).long()).numpy()
    np.testing.assert_allclose(wt, wj, atol=LOGIT_TOL, rtol=0)
