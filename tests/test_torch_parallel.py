"""The port's scale-out (``woft_tpu_torch/parallel``) against the JAX
package's sharded functions on the CPU.

The port's ranks are spawned processes in ``gloo`` groups
(``parallel.launch``: the CPU, torch at one thread a rank, a file store, a
60 s limit), whose entry points live in ``tests/torch_parallel_ranks.py``
and import no JAX; the JAX side runs in this process on the 8-device CPU
mesh of ``tests/conftest.py``. Three groups run, one after another, in a
thread while this process computes the JAX results: a 4-rank (2 x 2) mesh,
sp = 2 (the correlation, both forms of the forward, a training step) and
dp = 2 (streams, training). Inputs come from numpy seeds; the weights are
one seeded ``init_raft_params`` tree of WeightedRAFT-small (head
``((32, 3),)``; the port's, turned into the JAX tree by
``params_to_jax_numpy``) carried to the ranks by
``params_from_jax_numpy``.

Tolerances: the level-0 correlation 1e-5 and the forwards' ``flow_up`` and
``weights_up`` 1e-3 (the bounds of ``tests/test_sharding.py``); each
stream's H 0.05 px at the mask's corners (the port's tracker bound), the
identity oracle 1e-3; a training step against JAX: the loss 1e-4 relative,
frozen tensors bit-identical, the weight head within 1e-6 wherever its
gradient is ten times ``test_torch_train.py``'s bound on the two
libraries' gradient difference (1e-2 of the largest: the head's
gradients are sums that nearly cancel). The dp and sp steps against the
port's single-process step on the whole batch: the loss 1e-6 relative
and the gradients 1e-4 of the largest gradient of their part of the
network (float32 sums in another order; measured 2.9e-5 on the weight
head's last bias, 2.2e-5 on its last weight). The first AdamW step
moves a parameter by ``lr * g / (|g| + 1e-8)``, so where a gradient is
within a few of AdamW's eps of zero that rounding moves the step by up to
``2 lr`` (a flipped sign): the parameters are held to 1e-6 relative where
``|g| > 1e-5`` and to ``2 lr`` elsewhere.
"""

import concurrent.futures

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_parallel_ranks as ranks
from woft_tpu.models import raft as jraft
from woft_tpu.parallel import mesh as jmesh
from woft_tpu.parallel import sharding as jshard
from woft_tpu.tracker import woft as jw
from woft_tpu.training import train as jtrain
from woft_tpu.geometry import np_h_proj
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models import corr as tcorr
from woft_tpu_torch.models.convert import (params_from_jax_numpy,
                                           params_to_jax_numpy)
from woft_tpu_torch.ops.warp import warp_perspective
from woft_tpu_torch.parallel import launch
from woft_tpu_torch.training import synth as tsynth
from woft_tpu_torch.training import train as ttrain

HEAD = ((32, 3),)
CORR_TOL = 1e-5
FWD_TOL = 1e-3
CORNER_TOL = 0.05
ORACLE_TOL = 1e-3
LOSS_REL_JAX = 1e-4
GRAD_REL_HEAD = 1e-2
STEP_REL = 1e-6
GRAD_REL_STEP = 1e-4            # of the part's largest gradient
ADAM_EPS_REGIME = 1e-5          # |g| below this: the step held to lr only
LR = ttrain.TrainConfig().learning_rate
TRACK_HW = (48, 64)
JOIN_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs; the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _small_cfgs(**kw):
    kw = dict(variant="weighted", small=True, weight_head_structure=HEAD,
              **kw)
    return jraft.RaftConfig(**kw), traft.RaftConfig(**kw)


def _mask(h, w):
    mask = np.zeros((h, w), bool)
    mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = True
    return mask


def _track_frames(rng, n):
    h, w = TRACK_HW
    f0 = rng.uniform(0, 255, (n, 1, h, w, 3)).astype(np.float32)
    hm = torch.tensor([[1.0, 0.01, 1.2], [0.0, 1.0, -0.7], [0, 0, 1.0]])
    f1 = np.stack([warp_perspective(torch.from_numpy(f), hm).numpy()
                   for f in f0])
    return f0, f1


@pytest.fixture(scope="module")
def inputs():
    """Every rank's inputs: seeded numpy frames, features and a training
    batch, and the seeded weights as a state dict of numpy arrays."""
    _, tcfg = _small_cfgs()
    params = params_to_jax_numpy(traft.init_raft_params(tcfg, seed=0)
                                 .state_dict())
    small = {k: v.numpy() for k, v in params_from_jax_numpy(params).items()}
    rng = np.random.default_rng(0)

    def pair(h, w):
        return {k: rng.uniform(0, 255, (1, h, w, 3)).astype(np.float32)
                for k in ("img1", "img2")}

    imgs = torch.from_numpy(rng.uniform(0, 255, (4, 32, 64, 3))
                            .astype(np.float32))
    batch = tsynth.synth_homography_batch(torch.Generator().manual_seed(2),
                                          imgs, max_corner_shift=0.05)
    frames0, frames1 = _track_frames(rng, 4)
    h, w = TRACK_HW
    oracle = rng.uniform(0, 255, (4, 1, h, w, 3)).astype(np.float32)
    return dict(
        params=params, small=small,
        f1=rng.normal(size=(1, 8, 16, 32)).astype(np.float32),
        f2=rng.normal(size=(1, 8, 16, 32)).astype(np.float32),
        dense=pair(64, 128), local=pair(128, 256),
        batch={k: v.numpy() for k, v in batch.items()}, mask_seed=11,
        oracle=dict(frames=oracle, mask=_mask(h, w)),
        real=dict(frames0=frames0, frames1=frames1, mask=_mask(h, w)),
        mesh_batch={"img": rng.normal(size=(4, 2, 8, 6, 3))
                    .astype(np.float32),
                    "h": rng.normal(size=(4, 3, 3)).astype(np.float32)})


@pytest.fixture(scope="module")
def groups(inputs):
    """The three rank groups, started in a thread so that they run while
    this process computes the JAX side; each test waits for its group."""
    rank_inputs = {k: v for k, v in inputs.items() if k != "params"}
    pool = concurrent.futures.ThreadPoolExecutor(1)    # one group at a time

    def start(fn, world, arg):
        return pool.submit(launch, fn, world, "gloo", ["cpu"] * world,
                           args=(arg,), timeout=JOIN_S, join_timeout=JOIN_S)

    futures = {"mesh": start(ranks.mesh_rank, 4, inputs["mesh_batch"]),
               "sp": start(ranks.sp_rank, 2, rank_inputs),
               "dp": start(ranks.dp_rank, 2, rank_inputs)}
    yield futures
    pool.shutdown(wait=True)


def _wait(groups, name):
    return groups[name].result(timeout=4 * JOIN_S)


# ---------------------------------------------------------------------------
# the single-process references
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def single_step(inputs):
    """The port's single-process step on the whole batch, the stand-in
    masks drawn from the same seed: (loss, gradients, parameters)."""
    _, cfg = _small_cfgs(iters=1)
    tcfg = ttrain.TrainConfig(max_tc=128)
    model = ranks._model(cfg, inputs["small"])
    tx, state = ttrain.init_train_state(model, tcfg)
    batch = {k: torch.from_numpy(v) for k, v in inputs["batch"].items()}
    batch["generator"] = torch.Generator().manual_seed(inputs["mask_seed"])
    loss = ttrain.woft_loss(model, cfg, tcfg, batch)
    grads = torch.autograd.grad(loss, tx.params)
    tx.update(grads, state, loss.detach())
    return (loss.item(), {n: g.numpy() for n, g in zip(tx.names, grads)},
            {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()})


def _rel(a, b):
    return abs(a - b) / abs(b)


def _grads_close(got, want, rel):
    """Each gradient within ``rel`` of the largest gradient of its part of
    the network (``test_torch_train.py``'s measure: the weight head's
    gradients are sums that nearly cancel, its last bias's most)."""
    part = {n: n.split(".")[0] for n in want}
    scale = {}
    for n, g in want.items():
        scale[part[n]] = max(scale.get(part[n], 0.0), np.abs(g).max())
    for n, g in want.items():
        err = np.abs(got[n] - g).max()
        assert err <= rel * scale[part[n]], (n, err, scale[part[n]])


def _params_close(got, want, grads):
    """The parameters after one AdamW step: 1e-6 relative where the
    gradient is well above AdamW's eps, ``2 lr`` elsewhere. Returns the
    share of elements held to ``2 lr`` only."""
    loose = total = 0
    for n, p in want.items():
        err = np.abs(got[n] - p)
        if n not in grads:                      # frozen
            assert np.array_equal(got[n], p), n
            continue
        tight = np.abs(grads[n]) > ADAM_EPS_REGIME
        assert err[tight].max(initial=0) <= STEP_REL * np.abs(p).max(), n
        assert err.max() <= 2 * LR * (1 + 1e-3), (n, err.max())
        loose += int((~tight).sum())
        total += tight.size
    return loose / total


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def test_mesh_shape_and_shard_batch(groups, inputs):
    """make_mesh(4, sp=2) is {dp: 2, sp: 2} (sp = 3 raises), rank r sits
    at (r // 2, r % 2), ``replicate`` is rank 0's tensor everywhere, and
    ``shard_batch`` gives each rank exactly the addressable shard of the
    JAX function on a (2, 2) mesh at the same mesh position."""
    res = _wait(groups, "mesh")
    jm = jmesh.make_mesh(4, sp=2)
    batch = inputs["mesh_batch"]
    placed = jmesh.shard_batch(jm, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                               spatial_axis=2)
    pos = {d: (i, j) for i, row in enumerate(jm.devices)
           for j, d in enumerate(row)}
    for r, out in enumerate(res):
        assert out["shape"] == {"dp": 2, "sp": 2}
        assert "does not divide" in out["sp3"]
        assert (out["dp"], out["sp"]) == (r // 2, r % 2)
        np.testing.assert_array_equal(out["replicated"], np.ones(3))
        for k, arr in placed.items():
            shard = next(s for s in arr.addressable_shards
                         if pos[s.device] == (out["dp"], out["sp"]))
            np.testing.assert_array_equal(out["shares"][k],
                                          np.asarray(shard.data))


# ---------------------------------------------------------------------------
# one frame pair over sp = 2
# ---------------------------------------------------------------------------

def test_spatial_sharded_correlation_matches_jax(groups, inputs):
    res = _wait(groups, "sp")
    jm = jmesh.make_mesh(2, sp=2)
    want = np.asarray(jshard.spatial_sharded_correlation(
        jm, jnp.asarray(inputs["f1"]), jnp.asarray(inputs["f2"])))
    got = np.concatenate([r["corr"] for r in res], axis=-1)
    assert got.shape == want.shape == (128, 8, 16)
    np.testing.assert_allclose(got, want, atol=CORR_TOL, rtol=0)
    assert res[0]["corr"].shape == (128, 8, 8)


def test_key_column_lookup_equals_whole_lookup(groups):
    """The sp = 2 lookup (each rank's key columns, x shifted, the parts
    summed), dense and indexed, against ``corr_lookup`` on the whole
    pyramid, at a width whose coarse levels do not split: rank 0 holds
    them whole (4 levels), rank 1 only the two that split."""
    res = _wait(groups, "sp")
    assert [r["lookup"]["levels"] for r in res] == [4, 2]
    for r in res:
        for form in ("dense", "indexed"):
            assert np.abs(r["lookup"][form]).max() <= CORR_TOL, form


def test_spatial_sharded_forward_pyramid_matches_jax(groups, inputs):
    """Key columns over sp = 2: every rank's outputs against the JAX
    function on ``make_mesh(2, sp=2)``; each rank holds half the pyramid
    and all-reduces the (Q, 4 x 49) lookup once an iteration plus once for
    the weight head."""
    jcfg, _ = _small_cfgs(iters=4, precision="highest")
    p = inputs["dense"]
    jm = jmesh.make_mesh(2, sp=2)
    with jm:
        fwd = jshard.spatial_sharded_forward(jm, jcfg)
        img2 = jax.device_put(jnp.asarray(p["img2"]),
                              NamedSharding(jm, P(None, None, "sp", None)))
        flow_up, weights_up = fwd(jmesh.replicate(jm, inputs["params"]),
                                  jmesh.replicate(jm, jnp.asarray(p["img1"])),
                                  img2)
    res = _wait(groups, "sp")
    q = (64 // 8) * (128 // 8)
    whole = sum(q * (8 >> l) * (16 >> l) * 4 for l in range(4))
    for out in res:
        got = out["dense"]
        np.testing.assert_allclose(got["flow_up"], np.asarray(flow_up),
                                   atol=FWD_TOL, rtol=0)
        np.testing.assert_allclose(got["weights_up"], np.asarray(weights_up),
                                   atol=FWD_TOL, rtol=0)
        assert got["volume_bytes"] * 2 == whole
        assert got["reduce_bytes"] == q * 4 * 49 * 4
        assert got["reduces"] == 4 + 1


def test_spatial_sharded_forward_local_matches_jax(groups, inputs):
    """Bands of blocks over sp = 2 (kernels C, D, E at b0 on the card;
    their plain versions here) against the JAX ``corr_impl='local'``
    forward at 128x256: 2 of the 2 x 2 grid's blocks a rank."""
    jcfg, _ = _small_cfgs(iters=4, precision="highest", corr_impl="local")
    p = inputs["local"]
    want = jax.jit(lambda prm, a, b: jraft.weighted_raft_forward(
        prm, jcfg, a, b))(inputs["params"], jnp.asarray(p["img1"]),
                          jnp.asarray(p["img2"]))
    res = _wait(groups, "sp")
    for out in res:
        got = out["local"]
        np.testing.assert_allclose(got["flow_up"],
                                   np.asarray(want["flow_up"]),
                                   atol=FWD_TOL, rtol=0)
        np.testing.assert_allclose(got["weights_up"],
                                   np.asarray(want["weights_up"]),
                                   atol=FWD_TOL, rtol=0)
    assert res[0]["local"]["volume_bytes"] == res[1]["local"]["volume_bytes"]


def test_sp2_training_equals_sp1(groups, single_step):
    """dp 1 x sp 2: both ranks hold the whole batch, the gradients reduce
    over dp only, so the step is the single-process step."""
    loss0, grads0, params0 = single_step
    for loss, grads, params in (r["train"] for r in _wait(groups, "sp")):
        assert _rel(loss, loss0) <= STEP_REL
        _grads_close(grads, grads0, GRAD_REL_STEP)
        _params_close(params, params0, grads0)


# ---------------------------------------------------------------------------
# streams and training rows over dp = 2
# ---------------------------------------------------------------------------

def test_sharded_track_batch_identity_oracle(groups):
    """2 ranks x 2 streams on identity flow: every H the identity, every
    check passed, and ``gather_streams`` gives each rank all four."""
    res = _wait(groups, "dp")
    hs = np.concatenate([r["oracle"]["hs"] for r in res])
    assert hs.shape == (4, 3, 3)
    np.testing.assert_allclose(hs, np.broadcast_to(np.eye(3), hs.shape),
                               atol=ORACLE_TOL)
    assert all(s for r in res for s in r["oracle"]["success"])
    for r in res:
        np.testing.assert_array_equal(r["oracle"]["all_hs"], hs)


def test_sharded_track_batch_real_network_matches_jax(groups, inputs):
    """2 ranks x 2 streams through RAFT-small (2 iterations, 64 Sobol
    points): each stream's H against JAX ``sharded_track_batch`` on
    ``make_mesh(4, sp=1)``."""
    jcfg, _ = _small_cfgs(iters=2)
    t = inputs["real"]
    tp = jw.TrackerParams(subsample_n=64, padding_mode="nopad",
                          sparse_weights=False)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    mask = jnp.asarray(t["mask"])
    states = jax.vmap(lambda f: jw.tracker_init_state(
        params, jcfg, tp, f, mask))(jnp.asarray(t["frames0"]))
    jm = jmesh.make_mesh(4, sp=1)
    with jm:
        step = jshard.sharded_track_batch(jm, jcfg, tp)
        _, hj, _ = step(jmesh.replicate(jm, params),
                        jmesh.shard_batch(jm, states),
                        jmesh.shard_batch(jm, jnp.asarray(t["frames1"])))
    hj = np.asarray(hj)
    res = _wait(groups, "dp")
    ht = np.concatenate([r["real"]["hs"] for r in res])
    h, w = TRACK_HW
    corners = np.array([[w // 4, 3 * w // 4 - 1, 3 * w // 4 - 1, w // 4],
                        [h // 4, h // 4, 3 * h // 4 - 1, 3 * h // 4 - 1]],
                       np.float64)
    for a, b in zip(ht, hj):
        err = np.linalg.norm(np_h_proj(a.astype(np.float64), corners)
                             - np_h_proj(b.astype(np.float64), corners),
                             axis=0).max()
        assert err < CORNER_TOL, err
    for r in res:
        np.testing.assert_array_equal(r["real"]["all_hs"], ht)


def test_sharded_train_step_matches_jax(groups, inputs):
    """dp = 2 against JAX ``sharded_train_step`` on ``make_mesh(2, sp=1)``
    (no masks' key: every in-bounds point a candidate), after one step:
    the loss, frozen tensors bit-identical, and the weight head wherever
    its gradient is ten times the two libraries' gradient difference
    (``GRAD_REL_HEAD`` of the largest, ``test_torch_train.py``'s bound), so
    that AdamW's first step has the same sign on both sides."""
    jcfg, _ = _small_cfgs(iters=1)
    tcfg = jtrain.TrainConfig(max_tc=128)
    params = jax.tree_util.tree_map(jnp.asarray, inputs["params"])
    tx, opt = jtrain.init_train_state(params, tcfg)
    batch = {k: jnp.asarray(v) for k, v in inputs["batch"].items()}
    jm = jmesh.make_mesh(2, sp=1)
    with jm:
        step = jshard.sharded_train_step(jm, jcfg, tcfg, tx)
        p2, _, loss = step(jmesh.replicate(jm, params),
                           jmesh.replicate(jm, opt),
                           jmesh.shard_batch(jm, batch))
    jp2 = {k: v.numpy() for k, v in params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, p2)).items()}
    res = _wait(groups, "dp")
    for loss_t, grads, params_t in (r["train_jax"] for r in res):
        assert _rel(loss_t, float(loss)) <= LOSS_REL_JAX
        scale = max(np.abs(g).max() for g in grads.values())
        held = 0
        for n, p in jp2.items():
            if n not in grads:
                assert np.array_equal(params_t[n], p), n
                continue
            sure = np.abs(grads[n]) > 10 * GRAD_REL_HEAD * scale
            err = np.abs(params_t[n] - p)[sure]
            assert err.max(initial=0) <= 1e-6, (n, err.max())
            held += int(sure.sum())
        assert held > 0


def test_sharded_train_step_global_count(groups, single_step):
    """'generator' masks keep different numbers of points on the two
    ranks. The dp step (each rank's sum over the GLOBAL count, gradients
    summed) equals the single-process step on the whole batch; a
    per-rank-mean reduction, built here from the ranks' own sums, does
    not."""
    loss0, grads0, params0 = single_step
    res = _wait(groups, "dp")
    own = [r["own"] for r in res]
    assert own[0]["count"] != own[1]["count"]
    for loss, grads, params in (r["train_count"] for r in res):
        assert _rel(loss, loss0) <= STEP_REL
        _grads_close(grads, grads0, GRAD_REL_STEP)
        _params_close(params, params0, grads0)
    # the ranks' sums, composed the right way, are the whole batch's
    count = sum(o["count"] for o in own)
    assert _rel(sum(o["err"] for o in own) / count, loss0) <= STEP_REL
    # the per-rank mean of per-rank means: wrong whenever counts differ
    wrong_loss = np.mean([o["err"] / o["count"] for o in own])
    wrong_grads = {n: np.mean([o["grads"][n] / o["count"] for o in own],
                              axis=0) for n in grads0}
    assert _rel(wrong_loss, loss0) > 100 * STEP_REL, wrong_loss
    with pytest.raises(AssertionError):
        _grads_close(wrong_grads, grads0, GRAD_REL_STEP)


# ---------------------------------------------------------------------------
# kernels C, D, E at a band's first block (plain versions)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_band_plain_equals_whole_grid_slice(dtype):
    """The plain C, D and E on blocks b0 .. b0 + nb - 1 equal the matching
    rows of the whole-grid call, exactly: a band is a slice."""
    g = torch.Generator().manual_seed(4)
    H1, W1, D = 24, 40, 64
    f1 = torch.randn(1, H1, W1, D, generator=g)
    f2 = torch.randn(1, H1, W1, D, generator=g)
    whole = tcorr.build_local_corr(f1, f2, 4, 4, 16, dtype)
    meta = whole.meta
    nbh, nbw = meta["nbh"], meta["nbw"]
    ys, xs = torch.meshgrid(torch.arange(H1).float(),
                            torch.arange(W1).float(), indexing="ij")
    coords = (torch.stack([xs, ys], -1)[None]
              + 6.0 * torch.randn(1, H1, W1, 2, generator=g))
    f1b = tcorr._to_blocked(f1.reshape(H1 * W1, D), meta).reshape(
        nbh * nbw, -1, D).to(dtype)
    levels = [f2]
    while len(levels) < 4:
        levels.append(tcorr.avg_pool2d(levels[-1]))
    levels = [lv[0].to(dtype).contiguous() for lv in levels]
    d_whole, bad_whole = tcorr.block_local_lookup_coords(whole, coords, 9,
                                                         dtype)
    e_whole = tcorr.block_local_lookup_exact_coords(whole, coords, 9)
    assert bad_whole.any()
    for b0, nb in ((3, 5), (nbh * nbw - 4, 4)):
        rows = slice(b0, b0 + nb)
        vols = tcorr.block_local_corr_levels(
            f1b[rows].contiguous(), levels, meta["levels"], nbh, nbw, dtype,
            b0)
        for v, w in zip(vols, whole.volumes):
            assert torch.equal(v, w[rows])
        band = tcorr.LocalCorrVolumes(vols, meta, b0)
        d, bad = tcorr.block_local_lookup_coords(band, coords, 9, dtype)
        assert torch.equal(d, d_whole[rows])
        assert torch.equal(bad, bad_whole[rows])
        assert torch.equal(tcorr.block_local_lookup_exact_coords(
            band, coords, 9), e_whole[rows])
        guarded = d.clone()
        tcorr.block_local_lookup_exact_coords(band, coords, 9, bad=bad,
                                              out=guarded)
        want = d_whole.clone()
        tcorr.block_local_lookup_exact_coords(whole, coords, 9,
                                              bad=bad_whole, out=want)
        assert torch.equal(guarded, want[rows])
