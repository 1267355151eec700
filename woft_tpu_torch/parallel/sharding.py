"""Sharded training and tracking entry points: the three scale-out paths.

PyTorch twin of ``woft_tpu/parallel/sharding.py``. Each rank runs this
code on its own device; the collectives go through ``mesh.py``
(``all_reduce_sum``, ``gather_by_sum``):

- ``sharded_track_batch``: many independent streams, each rank stepping
  its own (the ``dp`` axis); ``gather_streams`` gives every rank every
  stream's H.
- ``sharded_train_step``: data-parallel training. Each rank computes the
  loss sums of its rows of the global batch, divides them by the GLOBAL
  count of selected points (one ``all_reduce`` of a scalar with no
  gradient) and the gradients are SUMMED over ``dp``: the loss divides by
  the count over the whole batch (``training/train.py:woft_loss``), so
  averaging per-rank means would weigh the ranks' points unequally
  whenever their Sobol selections keep different counts. The ranks of one
  ``dp`` group (``sp`` > 1) compute the same rows; the JAX package's
  width-sharded, halo-exchanged convolutions change where activations
  live, not the result, and are not ported: the encoders run replicated.
- ``spatial_sharded_forward``: one frame pair whose correlation is split
  over the ``sp`` ranks, for frames whose all-pairs volume does not fit
  one card. The encoders, ``corr_mean_response`` and the update block run
  replicated; each rank holds a range of key columns of every pyramid
  level (kernel B on the rank's columns with ``x`` shifted, one
  ``all_reduce(SUM)`` of the (Q, L*(2r+1)^2) parts a lookup: each bilinear
  tap falls in exactly one rank's columns and B reads zero outside a
  level) or, under ``corr_impl='local'``, a range of blocks of the
  block-local volume (kernels C, D, E at the band's first block ``b0``,
  the rows assembled by one ``all_reduce`` a lookup).
- ``spatial_sharded_correlation``: this rank's key columns of the level-0
  all-pairs volume.
"""

import math

import torch

from ..models.corr import (BlockedCorr, BlockLocalCorr, DenseCorr,
                           build_local_corr, corr_lookup)
from ..ops.warp import avg_pool2d
from .mesh import all_reduce_sum, gather_by_sum, mesh_shape


def _sp_rank(mesh):
    return mesh.get_local_rank("sp"), mesh_shape(mesh)["sp"]


def _dp_rank(mesh):
    return mesh.get_local_rank("dp"), mesh_shape(mesh)["dp"]


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def sharded_track_batch(mesh, raft_cfg, tp, flow_fn=None):
    """The tracker step over this rank's streams: ``step(model, states,
    frames) -> (states, hs (n_local, 3, 3), metas)``.

    ``states``: a list of this rank's ``TrackerState``s (its ``dp`` share
    of the streams; the ranks of one ``dp`` group hold the same ones);
    ``frames``: (n_local, 1, H, W, 3) float RGB, frame i of stream i. Each
    stream runs ``build_track_step`` with its own host-branched ladder, as
    the JAX step's ``vmap`` selects per stream, so each stream's H equals
    its own single-stream step's. The streams run one after another."""
    from ..tracker.woft import build_track_step

    inner = build_track_step(raft_cfg, tp, flow_fn=flow_fn)

    def step(model, states, frames):
        if len(states) != frames.shape[0]:
            raise ValueError(f"{len(states)} streams, {frames.shape[0]} "
                             f"frames")
        outs = [inner(model, s, frames[i]) for i, s in enumerate(states)]
        new_states, hs, metas = zip(*outs)
        return list(new_states), torch.stack(hs), list(metas)

    return step


def gather_streams(mesh, x):
    """Every stream's rows on every rank: x (n_local, ...) of each ``dp``
    rank -> (dp * n_local, ...) float32, stream-major in ``dp`` order."""
    r, dp = _dp_rank(mesh)
    n = x.shape[0]
    return gather_by_sum((dp * n, *x.shape[1:]),
                         [((slice(r * n, (r + 1) * n),), x)], mesh, "dp",
                         x.device)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def sharded_train_step(mesh, model, cfg, tcfg, tx):
    """One data-parallel step: ``step(opt_state, batch) -> loss``.

    ``batch``: this rank's rows of the global batch (``shard_batch``: 'img1',
    'img2', 'h_gt' and, shared, the 'generator' of the stand-in masks, which
    every rank draws for the whole batch and keeps its rows of). Each
    parameter's gradient is the sum over ``dp`` of the ranks' gradients of
    their errors' sum over the global count, so it is the gradient of the
    single-process loss on the whole batch; ``tx.update`` (the finite check
    and the clip included) then reads the reduced gradients and the global
    loss on every rank, which keeps the replicas equal. Returns the global
    loss (detached)."""
    from ..training.train import loss_terms

    r, dp = _dp_rank(mesh)

    def step(opt_state, batch):
        B = batch["img1"].shape[0]
        err, epe, count = loss_terms(model, cfg, tcfg, batch,
                                     rows=(r * B, dp * B))
        count = torch.clamp(all_reduce_sum(count.detach().clone(), mesh,
                                           "dp"), min=1.0)
        loss = err / count
        if epe is not None:
            loss = loss + tcfg.epe_weight * (epe / count)
        grads = torch.autograd.grad(loss, tx.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, tx.params)]
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                              mesh, "dp")
        grads = [g.view_as(p) for g, p in
                 zip(flat.split([p.numel() for p in tx.params]), tx.params)]
        loss = all_reduce_sum(loss.detach().clone(), mesh, "dp")
        tx.update(grads, opt_state, loss)
        return loss

    return step


# ---------------------------------------------------------------------------
# one frame pair over the sp ranks
# ---------------------------------------------------------------------------

class KeyColumnPyramid:
    """This rank's part of a correlation pyramid of ``num_levels`` levels:
    ``levels`` (key columns ``[c0/2^l, c1/2^l)`` of each level that splits,
    then, on ``sp`` rank 0 only, the whole levels that do not), ``c0`` in
    level-0 columns."""

    def __init__(self, levels, c0, num_levels):
        self.levels = levels
        self.c0 = c0
        self.num_levels = num_levels


class CorrShard:
    """The ``corr_shard`` hook of ``weighted_raft_forward`` for the ``sp``
    ranks of ``mesh``: ``models/corr.py:make_correlation`` takes its
    correlation kinds, key columns of the pyramid (``dense``) or a band of
    blocks of the block-local volume (``block_local``). It keeps the last
    forward's per-rank volume bytes, the all-reduced bytes of one lookup
    and the rank's blocks (``volume_bytes``, ``reduce_bytes``, ``blocks``:
    (b0, b1)) and counts its all-reduces (``reduces``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.blocks = None
        self.volume_bytes = 0
        self.reduce_bytes = 0
        self.reduces = 0
        self._offsets = {}

    def dense(self, radius, num_levels, out_dtype=None):
        """The pyramid's kind over the ranks (``KeyColumnCorr``)."""
        return KeyColumnCorr(self, radius, num_levels, out_dtype)

    def block_local(self, radius, num_levels, margin, fine_check=True,
                    out_dtype=None):
        """The block-local kind over the ranks (``BlockBandCorr``)."""
        return BlockBandCorr(self, radius, num_levels, margin, fine_check,
                             out_dtype)

    def _gather(self, shape, parts, device):
        self.reduce_bytes = 4 * math.prod(shape)
        self.reduces += 1
        return gather_by_sum(shape, parts, self.mesh, "sp", device)

    def _shifted(self, coords, c0):
        if c0 == 0:
            return coords
        key = (coords.device, c0)
        if key not in self._offsets:      # made once: a host->card copy
            self._offsets[key] = torch.tensor([float(c0), 0.0],
                                              device=coords.device)
        return coords - self._offsets[key]

    def band(self, nb_total):
        """(b0, b1): this rank's blocks of a grid of ``nb_total``, the
        ``sp`` ranks' bands contiguous and balanced."""
        r, sp = _sp_rank(self.mesh)
        b0, b1 = r * nb_total // sp, (r + 1) * nb_total // sp
        if b1 == b0:
            raise ValueError(f"{nb_total} blocks do not give every one of "
                             f"the sp ranks a block")
        return b0, b1


class KeyColumnCorr(DenseCorr):
    """The pyramid from this rank's key columns (``KeyColumnPyramid``):
    kernel B on the rank's levels with ``x`` shifted by ``-c0`` (each tap
    of a window reads zero outside the rank's columns), the parts summed
    over ``sp`` (zero channels for levels a rank does not hold); lookups
    and rows equal ``DenseCorr``'s."""

    def __init__(self, shard, radius, num_levels, out_dtype=None):
        super().__init__(radius, num_levels, out_dtype)
        self.shard = shard

    def build_volume(self, f1, f2):
        """One product a level against the rank's columns of the pooled
        fmap2. Level l splits when the level-0 width divides by ``sp *
        2^l`` (so one shift serves all split levels: they are a prefix); a
        level that does not stays whole on ``sp`` rank 0, as the JAX
        package leaves a level that does not divide replicated."""
        r, sp = _sp_rank(self.shard.mesh)
        num_levels = self.num_levels
        B, H, W, D = f1.shape
        scale = 1.0 / math.sqrt(D)
        W2 = f2.shape[2]
        split = 0
        while split < num_levels and W2 % (sp << split) == 0:
            split += 1
        f1 = f1.reshape(B, H * W, D)
        levels = []
        lv = f2
        for lvl in range(num_levels):
            hl, wl = lv.shape[1:3]
            if lvl < split:
                cols = slice(r * wl // sp, (r + 1) * wl // sp)
            elif r == 0:
                cols = slice(0, wl)
            else:
                break
            part = lv[:, :, cols]
            wc = part.shape[2]
            corr = f1 @ part.reshape(B, hl * wc, D).transpose(1, 2)
            corr = (corr * scale).reshape(B * H * W, hl, wc)
            levels.append(corr.to(self.out_dtype or torch.float32))
            if lvl + 1 < num_levels:
                lv = avg_pool2d(lv)
        self.shard.volume_bytes = sum(v.numel() * v.element_size()
                                      for v in levels)
        self.volume = KeyColumnPyramid(levels, r * W2 // sp, num_levels)
        return self.volume

    def _lookup(self, coords, rows=None):
        pyr, k = self.volume, 2 * self.radius + 1
        Q = coords.numel() // 2
        parts = []
        if pyr.levels:
            part = corr_lookup(pyr.levels,
                               self.shard._shifted(coords, pyr.c0),
                               self.radius, rows)
            parts.append(((slice(None), slice(0, part.shape[-1])),
                          part.reshape(Q, -1)))
        full = self.shard._gather((Q, pyr.num_levels * k * k), parts,
                                  coords.device)
        return full.reshape(*coords.shape[:-1], -1)


class BlockBandCorr(BlockLocalCorr):
    """The block-local volume from this rank's band of blocks: kernel C
    builds blocks ``b0 .. b1 - 1`` only (every level, one launch), kernels
    D and E look them up, and one all-reduce a lookup assembles every
    band's rows into the whole grid's ``BlockedCorr``. Not captured in a
    graph: a lookup is a collective."""

    graphable = False

    def __init__(self, shard, radius, num_levels, margin, fine_check=True,
                 out_dtype=None):
        super().__init__(radius, num_levels, margin, fine_check, out_dtype)
        self.shard = shard

    def build_volume(self, f1, f2):
        vol = build_local_corr(f1, f2, self.radius, self.num_levels,
                               self.margin, self.out_dtype,
                               blocks=self.shard.band)
        self.shard.blocks = (vol.b0, vol.b0 + vol.volumes[0].shape[0])
        self.shard.volume_bytes = sum(v.numel() * v.element_size()
                                      for v in vol.volumes)
        self.volume = vol
        return vol

    def blocked(self, coords, check=True):
        part = super().blocked(coords, check)
        meta, data = part.meta, part.data
        b0 = self.volume.b0
        full = self.shard._gather(
            (meta["nbh"] * meta["nbw"], *data.shape[1:]),
            [((slice(b0, b0 + data.shape[0]),), data)], coords.device)
        return BlockedCorr(full.to(data.dtype), meta, part.levels, part.k)


def spatial_sharded_forward(mesh, cfg, iters=None):
    """The WeightedRAFT forward with its correlation split over the ``sp``
    ranks of ``mesh``: ``fwd(model, img1, img2) -> (flow_up, weights_up)``,
    the same on every ``sp`` rank (each holds the whole images). Dense
    ``corr_impl``: each rank's key columns of every pyramid level;
    'local': a band of the block grid. ``fwd.shard`` (``CorrShard``) keeps
    the per-rank volume bytes and the all-reduced bytes a lookup."""
    from ..models.raft import weighted_raft_forward

    if cfg.alternate_corr:
        raise ValueError("the alternate correlation keeps no volume to "
                         "shard")
    if cfg.variant != "weighted":
        raise ValueError(f"spatial sharding returns the weights of the "
                         f"'weighted' variant, got {cfg.variant!r}")
    shard = CorrShard(mesh)

    def fwd(model, img1, img2):
        out = weighted_raft_forward(model, cfg, img1, img2, iters=iters,
                                    corr_shard=shard)
        return out["flow_up"], out["weights_up"]

    fwd.shard = shard
    return fwd


def spatial_sharded_correlation(mesh, fmap1, fmap2):
    """This rank's key columns of the level-0 all-pairs volume: fmap1,
    fmap2 (B, H, W, D) whole on every rank -> (B*H*W, H, W/sp), the
    columns ``[r*W/sp, (r+1)*W/sp)`` of ``sp`` rank r. No communication:
    queries are replicated and each rank multiplies by its columns."""
    r, sp = _sp_rank(mesh)
    B, H, W, D = fmap1.shape
    if fmap2.shape[2] % sp:
        raise ValueError(f"width {fmap2.shape[2]} does not split over sp "
                         f"{sp}")
    wc = fmap2.shape[2] // sp
    part = fmap2[:, :, r * wc:(r + 1) * wc]
    corr = (fmap1.reshape(B, H * W, D)
            @ part.reshape(B, -1, D).transpose(1, 2))
    return (corr / math.sqrt(D)).reshape(B * H * W, fmap2.shape[1], wc)
