"""Rank entry points of ``tests/test_torch_parallel.py``.

Each function runs on one spawned rank (``woft_tpu_torch.parallel.launch``,
``gloo`` on the CPU) and returns numpy results the test holds against the
JAX package, computed in the parent process. This module imports torch and
the port only: the ranks never load JAX.
"""

import numpy as np
import torch

from woft_tpu_torch.models import corr as tcorr
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.parallel import (
    gather_streams, make_mesh, mesh_shape, replicate, shard_batch,
    sharded_track_batch, sharded_train_step, spatial_sharded_correlation,
    spatial_sharded_forward)
from woft_tpu_torch.parallel.sharding import CorrShard
from woft_tpu_torch.tracker import woft as tw
from woft_tpu_torch.training import train as ttrain

HEAD = ((32, 3),)


def _model(cfg, state):
    model = traft.WeightedRAFT(cfg).eval()
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree


# ---------------------------------------------------------------------------
# the mesh (4 ranks)
# ---------------------------------------------------------------------------

def mesh_rank(rank, world, device, batch):
    mesh = make_mesh(4, sp=2, device=device)
    try:
        make_mesh(4, sp=3, device=device)
        sp3 = "no error"
    except ValueError as e:
        sp3 = str(e)
    shares = shard_batch(mesh, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, spatial_axis=2)
    mine = torch.full((3,), float(rank + 1))
    replicate(mesh, {"t": mine})
    return dict(shape=mesh_shape(mesh), sp3=sp3, dp=mesh.get_local_rank("dp"),
                sp=mesh.get_local_rank("sp"), shares=_np(shares),
                replicated=_np(mine))


# ---------------------------------------------------------------------------
# one frame pair over sp = 2
# ---------------------------------------------------------------------------

def _train_cfgs():
    cfg = traft.RaftConfig(variant="weighted", iters=1, small=True,
                           weight_head_structure=HEAD)
    return cfg, ttrain.TrainConfig(max_tc=128)


def train_rank_step(model, cfg, tcfg, mesh, batch):
    """One ``sharded_train_step`` on this rank's rows -> (loss, the reduced
    gradients by name, the parameters after the step by name)."""
    tx, state = ttrain.init_train_state(model, tcfg)
    seen = {}
    update = tx.update

    def recording(grads, st, loss=None):
        seen.update({n: g.clone() for n, g in zip(tx.names, grads)})
        return update(grads, st, loss)

    tx.update = recording
    loss = sharded_train_step(mesh, model, cfg, tcfg, tx)(state, batch)
    return (float(loss), _np(seen),
            {n: p.detach().numpy().copy()
             for n, p in model.named_parameters()})


def _train_batch(batch, mesh, seed):
    """This rank's rows of a numpy batch, with the stand-in masks'
    generator of the whole batch when ``seed`` is not None."""
    rows = shard_batch(mesh, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    if seed is not None:
        rows["generator"] = torch.Generator().manual_seed(seed)
    return rows


def sp_rank(rank, world, device, inputs):
    """sp = 2: the level-0 correlation's key columns, the forward in its
    pyramid and block-local forms, and one training step (dp 1 x sp 2)."""
    mesh = make_mesh(sp=2, device=device)
    out = {}
    f1, f2 = (torch.from_numpy(inputs[k]) for k in ("f1", "f2"))
    out["corr"] = _np(spatial_sharded_correlation(mesh, f1, f2))
    # the key-column lookup, dense and indexed, at a width whose coarse
    # levels do not split (20 columns: 20, 10 split; 5, 2 stay whole)
    g = torch.Generator().manual_seed(7)
    f1 = torch.randn(1, 6, 20, 32, generator=g)
    f2 = torch.randn(1, 6, 20, 32, generator=g)
    columns = CorrShard(mesh).dense(3, 4)
    pyr, _ = columns.build(f1, f2)
    whole, _ = tcorr.corr_pyramid_fused(f1, f2, 4)
    coords = (torch.stack(torch.meshgrid(
        torch.arange(20.0), torch.arange(6.0), indexing="xy"), -1)[None]
        + 4 * torch.randn(1, 6, 20, 2, generator=g))
    cells = torch.randint(0, 120, (30,), generator=g)
    c_cells = coords.reshape(-1, 2)[cells][None, None].contiguous()
    out["lookup"] = dict(
        levels=len(pyr.levels),
        dense=_np(columns.lookup_natural(coords)
                  - tcorr.corr_lookup(whole, coords, 3)),
        indexed=_np(columns.rows_at(coords)(cells)
                    - tcorr.corr_lookup(whole, c_cells, 3, rows=cells)))
    for form in ("dense", "local"):
        p = inputs[form]
        cfg = traft.RaftConfig(variant="weighted", iters=4, small=True,
                               weight_head_structure=HEAD,
                               corr_impl=form)
        model = _model(cfg, inputs["small"])
        fwd = spatial_sharded_forward(mesh, cfg)
        flow_up, weights_up = fwd(model, torch.from_numpy(p["img1"]),
                                  torch.from_numpy(p["img2"]))
        out[form] = dict(flow_up=_np(flow_up), weights_up=_np(weights_up),
                         volume_bytes=fwd.shard.volume_bytes,
                         reduce_bytes=fwd.shard.reduce_bytes,
                         reduces=fwd.shard.reduces)
    cfg, tcfg = _train_cfgs()
    model = _model(cfg, inputs["small"])
    out["train"] = train_rank_step(
        model, cfg, tcfg, mesh, _train_batch(inputs["batch"], mesh,
                                             inputs["mask_seed"]))
    return out


# ---------------------------------------------------------------------------
# streams and training rows over dp = 2
# ---------------------------------------------------------------------------

def _identity_flow(model, img1, img2, template_feats=None):
    _, h, w, _ = img2.shape
    return (torch.zeros((1, h, w, 2)), torch.ones((1, h, w, 1)))


def _track(mesh, model, cfg, tp, frames0, frames1, mask, flow_fn, encode):
    """Each stream of this rank: init on its frame of ``frames0``, one step
    on ``frames1``."""
    ours = shard_batch(mesh, {"f0": torch.from_numpy(frames0),
                              "f1": torch.from_numpy(frames1)})
    mask = torch.from_numpy(mask)
    states = [tw.tracker_init_state(model, cfg, tp, f, mask, encode=encode)
              for f in ours["f0"]]
    step = sharded_track_batch(mesh, cfg, tp, flow_fn=flow_fn)
    _, hs, metas = step(model, states, ours["f1"])
    return hs, metas


def dp_rank(rank, world, device, inputs):
    """dp = 2: two streams a rank (identity-flow oracle and the real
    RAFT-small), one training step against JAX (no masks' generator) and
    the global-count case ('generator' masks), with each rank's own sums
    for the test's per-rank-mean reduction."""
    mesh = make_mesh(sp=1, device=device)
    out = {}
    t = inputs["oracle"]
    tp = tw.TrackerParams(padding_mode="nopad", no_local_h=True)
    cfg = traft.RaftConfig(variant="weighted", iters=1)
    hs, metas = _track(mesh, None, cfg, tp, t["frames"], t["frames"],
                       t["mask"], _identity_flow, False)
    out["oracle"] = dict(
        hs=_np(hs), all_hs=_np(gather_streams(mesh, hs)),
        success=[bool(m["global_H_success"]) for m in metas])
    t = inputs["real"]
    cfg = traft.RaftConfig(variant="weighted", iters=2, small=True,
                           weight_head_structure=HEAD)
    # RAFT-small has no convex-upsampling mask: the dense weight head
    tp = tw.TrackerParams(subsample_n=64, padding_mode="nopad",
                          sparse_weights=False)
    hs, metas = _track(mesh, _model(cfg, inputs["small"]), cfg, tp,
                       t["frames0"], t["frames1"], t["mask"], None, True)
    out["real"] = dict(hs=_np(hs), all_hs=_np(gather_streams(mesh, hs)))

    cfg, tcfg = _train_cfgs()
    model = _model(cfg, inputs["small"])
    out["train_jax"] = train_rank_step(
        model, cfg, tcfg, mesh, _train_batch(inputs["batch"], mesh, None))
    model = _model(cfg, inputs["small"])
    out["train_count"] = train_rank_step(
        model, cfg, tcfg, mesh, _train_batch(inputs["batch"], mesh,
                                             inputs["mask_seed"]))
    # this rank's own sums on the initial weights: what a per-rank mean
    # would reduce
    model = _model(cfg, inputs["small"])
    tx = ttrain.make_optimizer(model, tcfg)
    B = inputs["batch"]["img1"].shape[0] // mesh_shape(mesh)["dp"]
    err, _, count = ttrain.loss_terms(
        model, cfg, tcfg, _train_batch(inputs["batch"], mesh,
                                       inputs["mask_seed"]),
        rows=(mesh.get_local_rank("dp") * B, 2 * B))
    grads = torch.autograd.grad(err, tx.params)
    out["own"] = dict(err=float(err), count=float(count),
                      grads={n: _np(g) for n, g in zip(tx.names, grads)})
    return out
