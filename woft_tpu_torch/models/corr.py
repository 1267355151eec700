"""Correlation volumes and their window lookups: the all-pairs pyramid and
the block-local volume.

PyTorch twin of ``woft_tpu/models/corr.py``. The dense path:

- ``corr_pyramid_fused``: each level is ONE matmul of fmap1 against the
  2x2-average-pooled fmap2 (correlation is linear in fmap2, so pooling the
  features equals pooling the volume), scaled by 1/sqrt(D); the level-0
  volume is never re-read for pooling.
- ``corr_mean_response``: the mean of each query's level-0 row, from
  features in O(Q*D).
- ``corr_lookup``: bilinear sampling of a (2r+1)^2 window around each
  query's centroid at every level, zero outside. Output channel
  ``l*(2r+1)^2 + i*(2r+1) + j`` samples ``(y + j - r, x + i - r)`` —
  RAFT's transposed-window quirk. CPU tensors take ``corr_lookup_plain``
  (the semantics of ``woft_tpu``'s 'onehot'/'gather' lookups); CUDA tensors
  launch kernel B (``csrc/corr_lookup.cu``). The port keeps this one lookup.
  Levels are float32, or bf16 in the 'bf16' and 'default' modes
  (``corr_pyramid_fused(out_dtype=)``, where the reference stores them so):
  a bf16 level is widened as it is read, the fractions and the blend stay
  float32 and the output is float32, as in the reference's Pallas kernel.
- ``corr_lookup_alternate``: the same lookup computed from the features,
  chunk by chunk, with no stored volume (``RaftConfig.alternate_corr``, for
  frames whose pyramid does not fit the card).

The block-local path (``corr_impl='local'``, the ``WOFT_fast`` tier):

- ``build_local_corr``: the 1/8-resolution queries are grouped into (8, 16)
  blocks; each block shares one source window of fmap2 per level and the
  stored volume is ``vol[b, py, px, q] = <f1[b, q], window_b[py, px]> /
  sqrt(D)``, queries minor (the reference's p layout, the only one the port
  keeps). CPU tensors take ``block_local_corr_plain``; CUDA tensors launch
  kernel C (``csrc/local_corr.cu``) once for all levels, which computes the
  products itself.
- ``corr_lookup_local_blocked``: a 9x9 bilinear window per query inside
  its block's stored window, centroids clamped to it. On the card it is two
  launches: kernel D from the (1, H1, W1, 2) coordinates and the layout's
  level table (``block_local_lookup_coords``) computes every query's slab
  start and fraction, each block's fine sub-window anchor and per-level
  flags, and looks up all levels, saturating at the sub-window's edge; then
  kernel E from the same coordinates (``block_local_lookup_exact_coords``,
  exact over the whole stored windows) rewrites the blocks with a flag set,
  with no host sync. CPU tensors take the plain composition
  (``_local_level_coords``, ``_fine_anchor_flags``, the explicit-operand
  lookups). D and E keep their explicit-operand forms
  (``block_local_lookup_fine_multi``: anchors, relative starts and
  fractions, the JAX kernel's own arguments; ``block_local_lookup_levels``:
  absolute starts), and kernel F (``block_local_lookup_fine``) is D's
  single-level form. The reference's two-hot weight arrays exist only to
  avoid gathers on the TPU; here a lookup takes each query's integer slab
  start and fraction per axis and reads its four taps. Output channels are
  level-major and **y-major** within a level (``c = l*81 + j*9 + i``, j
  offsets y); ``BlockedCorr.to_natural`` swaps to the dense lookup's
  ``i*9 + j``.
- The layout arithmetic (``_local_layout``, the x-origin quantised to
  ``(bx*sw)//8*8``, ``_fine_extents``, the ``- 1.001`` clamp) is copied
  number for number: it decides where a far-off centroid saturates.

Feature maps are NHWC (B, H, W, D), as in the JAX package.
"""

import functools
import math

import torch
import torch.nn.functional as F

from ..ops import kernels
from ..ops.warp import avg_pool2d
from . import layers


def all_pairs_correlation(fmap1, fmap2):
    """(B, H, W, D) x (B, H, W, D) -> (B*H*W, H, W) correlation rows."""
    B, H, W, D = fmap1.shape
    corr = fmap1.reshape(B, H * W, D) @ fmap2.reshape(B, H * W, D).transpose(1, 2)
    return (corr / math.sqrt(D)).reshape(B * H * W, H, W)


def corr_mean_response(fmap1, fmap2):
    """Mean of each query's level-0 cost-volume row, (B, H, W):
    ``mean_p <f1_q, f2_p> / sqrt(D) == <f1_q, mean_p f2_p> / sqrt(D)``."""
    B, H, W, D = fmap1.shape
    mean2 = fmap2.reshape(B, -1, D).mean(dim=1)                  # (B, D)
    with layers.full_float32():         # the reference's HIGHEST product
        out = (fmap1.reshape(B, H * W, D) @ mean2[:, :, None])[..., 0]
    return out.reshape(B, H, W) * (1.0 / math.sqrt(D))


def corr_pyramid_fused(fmap1, fmap2, num_levels=4, out_dtype=None):
    """Correlation pyramid straight from pooled feature maps.

    Each level is computed and scaled in float32 from float32 features
    (level l+1 pools the float32 features of level l) and then stored in
    ``out_dtype`` (None: float32; ``torch.bfloat16`` rounds each level
    once, as the reference does in its 'bf16' and 'default' modes).
    Returns (pyramid [(B*H*W, Hl, Wl) per level], mean_response (B, H, W)
    float32)."""
    B, H, W, D = fmap1.shape
    scale = 1.0 / math.sqrt(D)
    f1 = fmap1.reshape(B, H * W, D)
    pyramid = []
    lv = fmap2
    for lvl in range(num_levels):
        hl, wl = lv.shape[1:3]
        corr = f1 @ lv.reshape(B, hl * wl, D).transpose(1, 2)
        corr = (corr * scale).reshape(B * H * W, hl, wl)
        pyramid.append(corr.to(out_dtype or torch.float32))
        if lvl + 1 < num_levels:
            lv = avg_pool2d(lv)
    return pyramid, corr_mean_response(fmap1, fmap2)


def _lookup_level_plain(corr_l, coords, radius, rows):
    """One level: corr_l (R, Hl, Wl) float32 or bf16 (widened as read);
    coords (Q, 2) at this level's scale; rows (Q,) int64. Returns (Q,
    (2r+1)^2) float32, channel i*(2r+1)+j sampling (y + j - r, x + i -
    r)."""
    _, Hl, Wl = corr_l.shape
    Q = coords.shape[0]
    k = 2 * radius + 1
    x, y = coords[:, 0], coords[:, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    d = torch.arange(k, device=coords.device) - radius
    xi = x0.long()[:, None, None] + d[None, :, None]          # (Q, k, 1)
    yj = y0.long()[:, None, None] + d[None, None, :]          # (Q, 1, k)
    flat = corr_l.reshape(corr_l.shape[0], Hl * Wl)
    out = None
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            gx = xi + dx
            gy = yj + dy
            valid = (gx >= 0) & (gx < Wl) & (gy >= 0) & (gy < Hl)
            idx = (gy.clamp(0, Hl - 1) * Wl + gx.clamp(0, Wl - 1))
            vals = flat[rows[:, None], idx.reshape(Q, k * k)].float()
            w = (wx * wy) * valid.reshape(Q, k * k).to(torch.float32)
            term = vals * w
            out = term if out is None else out + term
    return out


def corr_lookup_plain(pyramid, coords, radius=4, rows=None):
    """Plain PyTorch version of kernel B (same arguments as
    ``corr_lookup``)."""
    flat = coords.reshape(-1, 2)
    if rows is None:
        rows = torch.arange(flat.shape[0], device=coords.device)
    outs = [_lookup_level_plain(corr_l, flat / (2.0 ** lvl), radius, rows)
            for lvl, corr_l in enumerate(pyramid)]
    return torch.cat(outs, dim=-1).reshape(*coords.shape[:-1], -1)


def corr_lookup(pyramid, coords, radius=4, rows=None):
    """Sample all pyramid levels around per-query centroids.

    Args:
        pyramid: list of (R, Hl, Wl) levels, all float32 or all bf16.
        coords: (B, H1, W1, 2) float32 (x, y) level-0 coordinates.
        radius: window radius r (canonical 4 -> 9x9 windows).
        rows: optional (B*H1*W1,) int64 pyramid row of each query (the
            sparse weight head reads its cells in place); None reads row q
            for query q.
    Returns:
        (B, H1, W1, L*(2r+1)^2) float32, the torch reference's channel
        order.
    """
    if coords.device.type == "cpu":
        return corr_lookup_plain(pyramid, coords, radius, rows)
    out = kernels.corr_pyramid_lookup(pyramid, coords, radius, rows)
    return out.reshape(*coords.shape[:-1], -1)


def corr_lookup_alternate(fmap1, fmap2, coords, radius=4, num_levels=4,
                          chunk=4096, batch=None):
    """``corr_lookup`` on the pyramid of ``fmap1`` against ``fmap2``,
    computed from the features with no stored volume (the twin of
    ``woft_tpu/models/corr.py:corr_lookup_alternate``).

    For each level (fmap2 average-pooled l times, in float32) and each
    chunk of queries: gather the (2r+2)^2 integer taps of the level around
    the query's centroid, take each one's product with the query's fmap1
    row, zero the taps outside the level, scale by 1/sqrt(D), and blend
    the four corner windows with the window's shared fraction. Peak memory
    is O(chunk * (2r+2)^2 * D).

    fmap1: (B, H1, W1, D), or (1, 1, M, D) for M chosen queries; fmap2:
    (B, H2, W2, D) float32; coords: fmap1's shape with 2 channels, level-0
    (x, y); batch: None (the queries are fmap2's batch elements in order)
    or the (Q,) int64 batch element of each query. Returns (...,
    L*(2r+1)^2) float32, the dense lookup's channel order."""
    B2, _, _, D = fmap2.shape
    Q = coords.numel() // 2
    k = 2 * radius + 1
    scale = 1.0 / math.sqrt(D)
    dev = coords.device
    f1 = fmap1.reshape(Q, D).to(torch.float32)
    flat = coords.reshape(Q, 2)
    bidx = (torch.arange(B2, device=dev).repeat_interleave(Q // B2)
            if batch is None else batch)
    offs = torch.arange(k + 1, device=dev) - radius
    outs = []
    lv = fmap2.to(torch.float32)
    for lvl in range(num_levels):
        Hl, Wl = lv.shape[1:3]
        f2 = lv.reshape(B2 * Hl * Wl, D)
        level = torch.empty((Q, k * k), dtype=torch.float32, device=dev)
        for s in range(0, Q, chunk):
            c = flat[s:s + chunk] / (2.0 ** lvl)
            x0, y0 = torch.floor(c[:, 0]), torch.floor(c[:, 1])
            fx = (c[:, 0] - x0)[:, None, None]
            fy = (c[:, 1] - y0)[:, None, None]
            rows = y0.long()[:, None] + offs                 # (c, k+1)
            cols = x0.long()[:, None] + offs
            valid = (((rows >= 0) & (rows < Hl))[:, :, None]
                     & ((cols >= 0) & (cols < Wl))[:, None, :])
            idx = (bidx[s:s + chunk, None, None] * (Hl * Wl)
                   + rows.clamp(0, Hl - 1)[:, :, None] * Wl
                   + cols.clamp(0, Wl - 1)[:, None, :])      # (c, a, b)
            n = idx.shape[0]
            taps = f2[idx.reshape(-1)].reshape(n, (k + 1) ** 2, D)
            win = torch.bmm(taps, f1[s:s + chunk, :, None]).reshape(
                n, k + 1, k + 1)
            win = win * valid.to(torch.float32) * scale
            blend = ((1 - fy) * (1 - fx) * win[:, :k, :k]
                     + (1 - fy) * fx * win[:, :k, 1:]
                     + fy * (1 - fx) * win[:, 1:, :k]
                     + fy * fx * win[:, 1:, 1:])             # [c, j, i]
            level[s:s + chunk] = blend.transpose(1, 2).reshape(n, k * k)
        outs.append(level)
        if lvl + 1 < num_levels:
            lv = avg_pool2d(lv)
    return torch.cat(outs, dim=-1).reshape(*coords.shape[:-1], -1)


# ---------------------------------------------------------------------------
# block-local correlation volume (corr_impl='local')
# ---------------------------------------------------------------------------

LOCAL_BLOCK = (8, 16)


def _local_layout(H1, W1, radius, num_levels, margin, block=LOCAL_BLOCK):
    """Static geometry of the block-local volume (python ints): the block
    grid and, per level, the margin ``m``, the one-sided pad, the block
    stride (sh, sw), the stored window (wh, ww), the padded level size
    (hp, wp) and the level size (hl, wl). ``ww`` is rounded up to 8 with 7
    of headroom when ``sw % 8``: block x-origins are quantised to
    ``(bx*sw)//8*8``."""
    bh, bw = block
    nbh = -(-H1 // bh)
    nbw = -(-W1 // bw)
    levels = []
    hl, wl = H1, W1
    for lvl in range(num_levels):
        m_l = max(margin >> lvl, radius + 1)
        pad_l = m_l + radius + 1
        sh, sw = bh >> lvl, bw >> lvl
        wh = sh + 2 * pad_l
        ww = -8 * (-(sw + 2 * pad_l + (7 if sw % 8 else 0)) // 8)
        hp = max(hl + 2 * pad_l, (nbh - 1) * sh + wh)
        wp = max(wl + 2 * pad_l, (nbw - 1) * sw + ww)
        levels.append(dict(m=m_l, pad=pad_l, sh=sh, sw=sw, wh=wh, ww=ww,
                           hp=hp, wp=wp, hl=hl, wl=wl))
        hl, wl = hl // 2, wl // 2
    return dict(H1=H1, W1=W1, bh=bh, bw=bw, nbh=nbh, nbw=nbw, radius=radius,
                margin=margin, levels=tuple(levels))


def _to_blocked(x, meta):
    """(H1*W1, C) natural raster -> (NB*BQ, C) block-major (zero pad)."""
    H1, W1, bh, bw = meta["H1"], meta["W1"], meta["bh"], meta["bw"]
    nbh, nbw = meta["nbh"], meta["nbw"]
    C = x.shape[-1]
    x = F.pad(x.reshape(H1, W1, C), (0, 0, 0, nbw * bw - W1, 0, nbh * bh - H1))
    x = x.reshape(nbh, bh, nbw, bw, C).permute(0, 2, 1, 3, 4)
    return x.reshape(nbh * nbw * bh * bw, C)


def _from_blocked(x, meta):
    """Inverse of ``_to_blocked``: (NB*BQ, C) -> (H1*W1, C)."""
    H1, W1, bh, bw = meta["H1"], meta["W1"], meta["bh"], meta["bw"]
    nbh, nbw = meta["nbh"], meta["nbw"]
    C = x.shape[-1]
    x = x.reshape(nbh, nbw, bh, bw, C).permute(0, 2, 1, 3, 4)
    return x.reshape(nbh * bh, nbw * bw, C)[:H1, :W1].reshape(H1 * W1, C)


def _fine_extents(d, k):
    """Fine sub-window (rows, columns) of one level: the block's query span
    plus the k-wide window plus 8 of slack; columns get 7 more for the
    8-aligned anchor and are rounded up to 8."""
    fr = min(d["wh"], d["sh"] + k - 1 + 8)
    fc = min(d["ww"], -8 * (-(d["sw"] + k - 1 + 8 + 7) // 8))
    return fr, fc


class LocalCorrVolumes:
    """Block-local correlation pyramid (``build_local_corr``).

    volumes: list of (NB, wh_l, ww_l, BQ) levels, queries minor.
    meta: the ``_local_layout`` dict.
    consts: per-level lookup constants on the volumes' device, each shaped
        to broadcast against (L, 2, NB, BQ) coordinates, axis 0 = y, 1 = x,
        and ``table``, the same numbers as the level table kernels D and E
        take from coordinates (python ints and floats, built once a
        layout).
    """

    def __init__(self, volumes, meta):
        self.volumes = volumes
        self.meta = meta
        self.consts = _lookup_constants(
            meta["H1"], meta["W1"], meta["radius"], len(meta["levels"]),
            meta["margin"], volumes[0].device)


@functools.lru_cache(maxsize=8)
def _lookup_constants(H1, W1, radius, num_levels, margin, device):
    """Read-only constant tensors of one layout on one device. Cached: a
    tracker builds the same layout every frame, and each tensor made from
    host numbers is a blocking copy to the card."""
    meta = _local_layout(H1, W1, radius, num_levels, margin)
    r = meta["radius"]
    k = 2 * r + 1
    nbh, nbw = meta["nbh"], meta["nbw"]
    L = len(meta["levels"])
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    by = torch.arange(nbh, device=device).repeat_interleave(nbw)
    bx = torch.arange(nbw, device=device).repeat(nbh)
    origin, hi, size, fine = [], [], [], []
    for d in meta["levels"]:
        # window origin in the padded level; x quantised to a multiple of 8
        origin.append(torch.stack([by * d["sh"], bx * d["sw"] // 8 * 8]))
        hi.append([d["wh"] - r - 1.001, d["ww"] - r - 1.001])
        size.append([d["wh"], d["ww"]])
        fine.append(list(_fine_extents(d, k)))
    # the level table of kernels D and E from coordinates (the same
    # numbers as the tensors below; csrc/local_lookup.cu reads it)
    ints = [H1, W1, nbw, meta["bh"], meta["bw"], r]
    floats = []
    for lvl, (d, (fr, fc)) in enumerate(zip(meta["levels"], fine)):
        ints += [d["wh"], d["ww"], d["sh"], d["sw"], fr, fc,
                 fr - 2 * r - 2, fc - 2 * r - 2, max(d["wh"] - fr, 0),
                 max(d["ww"] - fc, 0)]
        floats += [2.0 ** lvl, float(d["pad"]), *hi[lvl]]
    size = torch.tensor(size, **i32)
    fine = torch.tensor(fine, **i32)
    return dict(
        table=(tuple(ints), tuple(floats)),
        div=torch.tensor([2.0 ** lvl for lvl in range(L)],
                         **f32).reshape(L, 1, 1, 1),
        pad=torch.tensor([float(d["pad"]) for d in meta["levels"]],
                         **f32).reshape(L, 1, 1, 1),
        origin=torch.stack(origin).to(torch.float32)[..., None],  # (L,2,NB,1)
        lo=torch.tensor(float(r), **f32),
        hi=torch.tensor(hi, **f32).reshape(L, 2, 1, 1),
        # anchor & mask rounds a non-negative anchor down to a multiple of
        # 1 (rows) or 8 (columns)
        align_mask=torch.tensor([-1, -8], **i32).reshape(1, 2, 1),
        zero=torch.zeros((), **i32),
        anchor_max=(size - fine).clamp(min=0).reshape(L, 2, 1),
        rel_max=(fine - 2 * r - 2).reshape(L, 2, 1, 1),
        exts=tuple(_fine_extents(d, k) for d in meta["levels"]))


def block_local_corr_plain(f1b, f2, d, nbh, nbw, out_dtype):
    """Plain PyTorch version of kernel C (same arguments as
    ``block_local_corr``): zero-pad the level, cut each block's window with
    strided slices, one einsum. Operands are widened to float32 first, so
    products of bf16 values are exact and the sum is float32."""
    pad, wh, ww, sh, sw = d["pad"], d["wh"], d["ww"], d["sh"], d["sw"]
    hl, wl, D = f2.shape
    fp = F.pad(f2, (0, 0, pad, d["wp"] - wl - pad, pad, d["hp"] - hl - pad))
    bands = torch.stack([fp[by * sh:by * sh + wh] for by in range(nbh)])
    patches = torch.stack([bands[:, :, bx * sw // 8 * 8:bx * sw // 8 * 8 + ww]
                           for bx in range(nbw)], dim=1)  # (nbh,nbw,wh,ww,D)
    patches = patches.reshape(nbh * nbw, wh * ww, D)
    corr = torch.einsum("bpd,bqd->bpq", patches.to(torch.float32),
                        f1b.to(torch.float32))
    corr = corr * (1.0 / math.sqrt(D))
    return corr.to(out_dtype).reshape(nbh * nbw, wh, ww, f1b.shape[1])


def block_local_corr_levels(f1b, levels, ds, nbh, nbw, out_dtype):
    """Every level of the block-local volume, one launch of kernel C on a
    CUDA tensor.

    f1b: (NB, BQ, D) blocked query features; levels: L (hl, wl, D) unpadded
    target features, same dtype (float32 or bfloat16); ds: the levels'
    ``_local_layout`` entries. Returns L (NB, wh, ww, BQ) ``out_dtype``
    volumes: ``<f1b[b, q], window_b[py, px]> / sqrt(D)``, float32
    accumulation, rounded once; window_b starts at (by*sh, (bx*sw)//8*8) of
    the level zero-padded by ``pad``."""
    if f1b.device.type == "cpu":
        return [block_local_corr_plain(f1b, f2, d, nbh, nbw, out_dtype)
                for f2, d in zip(levels, ds)]
    return kernels.local_corr_build(
        f1b, levels, [(d["pad"], d["sh"], d["sw"], d["wh"], d["ww"])
                      for d in ds], nbh, nbw, out_dtype)


def block_local_corr(f1b, f2, d, nbh, nbw, out_dtype):
    """One level of the block-local volume (``block_local_corr_levels`` for
    one level: f2 (hl, wl, D), d its layout entry)."""
    return block_local_corr_levels(f1b, [f2], [d], nbh, nbw, out_dtype)[0]


def build_local_corr(fmap1, fmap2, radius=4, num_levels=4, margin=16,
                     out_dtype=None):
    """Block-local recentred correlation pyramid (p layout).

    Equal to the all-pairs pyramid's lookups (zero borders included) for
    every centroid within +-margin level-0 cells of its query; centroids
    beyond saturate at the stored window's edge.

    fmap1, fmap2: (1, H1, W1, D) float32. ``out_dtype=torch.bfloat16``
    rounds the features entering each level's product and the stored
    volume to bf16 (float32 accumulation); levels are pooled from float32
    features. All levels are pooled and cast first, then built by one call
    (one launch on the card). Returns ``LocalCorrVolumes``."""
    B, H1, W1, D = fmap1.shape
    if B != 1:
        raise ValueError("the block-local volume takes one frame pair")
    meta = _local_layout(H1, W1, radius, num_levels, margin)
    nbh, nbw = meta["nbh"], meta["nbw"]
    vol_dtype = out_dtype or torch.float32
    f1b = _to_blocked(fmap1.reshape(H1 * W1, D), meta)
    f1b = f1b.reshape(nbh * nbw, -1, D).to(vol_dtype).contiguous()
    levels = [fmap2]
    while len(levels) < num_levels:
        levels.append(avg_pool2d(levels[-1]))
    levels = [lv[0].to(vol_dtype).contiguous() for lv in levels]
    return LocalCorrVolumes(block_local_corr_levels(
        f1b, levels, meta["levels"], nbh, nbw, vol_dtype), meta)


# ---------------------------------------------------------------------------
# block-local lookups
# ---------------------------------------------------------------------------

def _slab_blend_plain(vol, ys, xs, fy, fx, k, out_dtype):
    """One level: gather each output's four taps, blend y, then x.

    vol: (NB, wh, ww, BQ); ys, xs: (NB, BQ) integer slab starts in the
    stored window (clamped to [0, size-k-1], which valid starts satisfy);
    fy, fx: (NB, BQ) float32 fractions. Returns (NB, k*k, BQ), c = j*k + i."""
    nb, wh, ww, bq = vol.shape
    dev = vol.device
    ys = ys.long().clamp(0, wh - k - 1)
    xs = xs.long().clamp(0, ww - k - 1)
    off = torch.arange(k, device=dev)
    b = torch.arange(nb, device=dev)[:, None, None, None]
    q = torch.arange(bq, device=dev)[None, None, None, :]
    y0 = ys[:, None, None, :] + off[None, :, None, None]    # (NB, k, 1, BQ)
    x0 = xs[:, None, None, :] + off[None, None, :, None]    # (NB, 1, k, BQ)
    fy, fx = fy[:, None, None, :], fx[:, None, None, :]
    gy, gx = 1.0 - fy, 1.0 - fx
    a0 = (vol[b, y0, x0, q].to(torch.float32) * gy
          + vol[b, y0 + 1, x0, q].to(torch.float32) * fy)
    a1 = (vol[b, y0, x0 + 1, q].to(torch.float32) * gy
          + vol[b, y0 + 1, x0 + 1, q].to(torch.float32) * fy)
    return (a0 * gx + a1 * fx).to(out_dtype).reshape(nb, k * k, bq)


def block_local_lookup_fine_multi_plain(rcs, vols, rel, frac, k,
                                        out_dtype=torch.float32):
    """Plain PyTorch version of kernel D (same arguments as
    ``block_local_lookup_fine_multi``)."""
    outs = [_slab_blend_plain(vol, rcs[:, lvl, 0:1] + rel[lvl, 0],
                              rcs[:, lvl, 1:2] + rel[lvl, 1],
                              frac[lvl, 0], frac[lvl, 1], k, out_dtype)
            for lvl, vol in enumerate(vols)]
    return torch.cat(outs, dim=1)


def block_local_lookup_fine_multi(rcs, vols, rel, frac, k,
                                  out_dtype=torch.float32):
    """All levels' fine-window lookups in one launch.

    rcs: (NB, L, 2) int32 per-block fine-window anchors [r0, c0]; vols: L
    (NB, wh_l, ww_l, BQ) volumes of one dtype (float32 or bfloat16); rel:
    (L, 2, NB, BQ) int32 slab starts relative to the anchor, [l, 0] rows and
    [l, 1] columns, already clamped to the fine window; frac: (L, 2, NB,
    BQ) float32 fractions. Returns (NB, L*k*k, BQ) ``out_dtype``,
    level-major, c = j*k + i within a level: ``(1-fy)(1-fx) v[y, x] + ...``
    over the four taps at rows r0+rel+j(+1), columns c0+rel+i(+1), blended
    in float32, y first."""
    if rcs.device.type == "cpu":
        return block_local_lookup_fine_multi_plain(rcs, vols, rel, frac, k,
                                                   out_dtype)
    return kernels.local_lookup_fine_multi(rcs, vols, rel, frac, k, out_dtype)


def block_local_lookup_fine_plain(rc0, vol, rel, frac, k,
                                  out_dtype=torch.float32):
    """Plain PyTorch version of kernel F."""
    return block_local_lookup_fine_multi_plain(rc0[:, None], [vol],
                                               rel[None], frac[None], k,
                                               out_dtype)


def block_local_lookup_fine(rc0, vol, rel, frac, k, out_dtype=torch.float32):
    """Kernel D for one level: rc0 (NB, 2) int32, vol (NB, wh, ww, BQ), rel
    and frac (2, NB, BQ). Returns (NB, k*k, BQ). No path of the tracker
    calls it, as none does in the JAX package."""
    if rc0.device.type == "cpu":
        return block_local_lookup_fine_plain(rc0, vol, rel, frac, k,
                                             out_dtype)
    return kernels.local_lookup_fine(rc0, vol, rel, frac, k, out_dtype)


def block_local_lookup_plain(vol, starts, frac, k, flag=None, out=None,
                             channel=0):
    """Plain PyTorch version of kernel E (same arguments as
    ``block_local_lookup``)."""
    res = _slab_blend_plain(vol, starts[0], starts[1], frac[0], frac[1], k,
                            torch.float32 if out is None else out.dtype)
    if out is None:
        return res
    rows = out[:, channel:channel + k * k]
    rows.copy_(res if flag is None
               else torch.where(flag.bool()[:, None, None], res, rows))
    return out


def block_local_lookup_levels_plain(vols, starts, frac, k, flag=None,
                                    out=None):
    """Plain PyTorch version of kernel E over every level (same arguments
    as ``block_local_lookup_levels``)."""
    if out is None:
        return torch.cat([block_local_lookup_plain(vol, starts[lvl],
                                                   frac[lvl], k)
                          for lvl, vol in enumerate(vols)], dim=1)
    for lvl, vol in enumerate(vols):
        block_local_lookup_plain(vol, starts[lvl], frac[lvl], k, flag, out,
                                 lvl * k * k)
    return out


def block_local_lookup_levels(vols, starts, frac, k, flag=None, out=None):
    """Every level, the whole stored windows: exact for any coordinates;
    one launch of kernel E on a CUDA tensor.

    vols: L (NB, wh_l, ww_l, BQ) volumes; starts: (L, 2, NB, BQ) int32
    absolute slab starts ([l, 0] rows, [l, 1] columns) in the stored
    windows; frac: (L, 2, NB, BQ) float32. Without ``out`` returns (NB,
    L*k*k, BQ) float32, level-major. With ``out`` (NB, L*k*k, BQ) it writes
    in place, and with ``flag`` (NB,) uint8 only the blocks whose flag is
    non-zero: the others keep their rows."""
    if vols[0].device.type == "cpu":
        return block_local_lookup_levels_plain(vols, starts, frac, k, flag,
                                               out)
    return kernels.local_lookup_exact(vols, starts, frac, k, flag, out)


def block_local_lookup(vol, starts, frac, k, flag=None, out=None, channel=0):
    """One level, the whole stored window: exact for any coordinates.

    vol: (NB, wh, ww, BQ); starts: (2, NB, BQ) int32 absolute slab starts
    (rows, columns) in the stored window; frac: (2, NB, BQ) float32.
    Without ``out`` returns (NB, k*k, BQ) float32. With ``out`` (NB, C, BQ)
    it writes channels ``channel .. channel + k*k`` in place, and with
    ``flag`` (NB,) uint8 only the blocks whose flag is non-zero: the others
    return at once and keep their rows. On a CUDA tensor: kernel E for one
    level."""
    if vol.device.type == "cpu":
        return block_local_lookup_plain(vol, starts, frac, k, flag, out,
                                        channel)
    return kernels.local_lookup_exact([vol], starts[None], frac[None], k,
                                      flag, out, channel)


class BlockedCorr:
    """Lookup output in blocked channel-major form: ``data`` (NB, L*k*k,
    BQ), channel ``l*k*k + j*k + i`` (y-major within a level, the transpose
    of the dense lookup's order). The motion encoder folds the (j, i) swap
    into its weights (``models/raft.py:_corr_conv1``); ``to_natural`` pays
    the transpose for consumers that need the dense layout."""

    def __init__(self, data, meta, levels, k):
        self.data = data
        self.meta = meta
        self.levels = levels
        self.k = k

    def to_natural(self):
        """-> (1, H1, W1, L*k*k) in the dense lookup's order c = i*k + j."""
        meta = self.meta
        nb, _, bq = self.data.shape
        L, k = self.levels, self.k
        x = self.data.reshape(nb, L, k, k, bq)              # (b, l, j, i, q)
        x = x.permute(0, 4, 1, 3, 2)                        # (b, q, l, i, j)
        x = x.reshape(nb * bq, L * k * k)
        return _from_blocked(x, meta).reshape(1, meta["H1"], meta["W1"],
                                              L * k * k)


def _local_level_coords(local, coords):
    """Window-local clamped coordinates of every level.

    coords: (1, H1, W1, 2) level-0 (x, y) centroids. Returns (starts (L, 2,
    NB, BQ) int32 absolute slab starts, frac (L, 2, NB, BQ) float32), axis
    0 = rows (y), 1 = columns (x): level coordinate + pad - block origin,
    clamped to [r, size - r - 1.001] so the whole k-window and its +1 tap
    stay inside the stored window."""
    meta, c = local.meta, local.consts
    r = meta["radius"]
    nb = meta["nbh"] * meta["nbw"]
    cb = _to_blocked(coords.reshape(meta["H1"] * meta["W1"], 2), meta)
    # (2, NB, BQ): y, x; contiguous, so everything derived from it is too
    cb = cb.reshape(nb, -1, 2).flip(-1).permute(2, 0, 1).contiguous()
    w = cb[None] / c["div"] + c["pad"] - c["origin"]
    w = torch.clamp(w, c["lo"], c["hi"])
    # w >= r > 0: truncation is the floor and frac(w) = w - floor(w)
    return w.to(torch.int32) - r, torch.frac(w)


def _fine_anchor_flags(local, starts):
    """Per-block fine-window anchors, the starts relative to them and the
    per-level flags.

    Returns (rcs (NB, L, 2) int32 [r0, c0], rel (L, 2, NB, BQ) int32 clamped
    to the fine window, bad (NB, L) bool: some start of the block lies
    beyond its fine window at that level, so the fine lookup is not exact
    there). The anchor is the block's least start, rounded down to 8 on
    columns, clamped to [0, size - fine]; only the upper end of the fine
    window can be exceeded, and starts beyond it saturate at its edge."""
    c = local.consts
    anchor = starts.amin(dim=3) & c["align_mask"]           # (L, 2, NB)
    anchor = torch.clamp(anchor, c["zero"], c["anchor_max"])
    rel = starts - anchor[..., None]
    bad = (rel > c["rel_max"]).any(dim=3).any(dim=1).T.contiguous()
    rel = torch.clamp(rel, c["zero"], c["rel_max"])
    return anchor.permute(2, 0, 1).contiguous(), rel, bad


def _fine_anchor_starts(local, starts):
    """``_fine_anchor_flags`` with one verdict a block: (rcs, rel, ok (NB,)
    bool, every start of the block inside its fine window on every
    level)."""
    rcs, rel, bad = _fine_anchor_flags(local, starts)
    return rcs, rel, ~bad.any(dim=1)


def block_local_lookup_coords_plain(local, coords, k, out_dtype):
    """Plain PyTorch version of kernel D from coordinates (same arguments
    as ``block_local_lookup_coords``): the coordinate arithmetic as tensor
    ops, then the explicit-operand lookup."""
    starts, frac = _local_level_coords(local, coords)
    rcs, rel, bad = _fine_anchor_flags(local, starts)
    data = block_local_lookup_fine_multi_plain(rcs, local.volumes, rel, frac,
                                               k, out_dtype)
    return data, bad.to(torch.uint8)


def block_local_lookup_coords(local, coords, k, out_dtype):
    """Every level's fine-window lookup straight from the coordinates: one
    launch of kernel D on a CUDA tensor, which computes each query's start
    and fraction, its block's anchor and the flags itself.

    coords: (1, H1, W1, 2) float32 level-0 (x, y), natural raster order.
    Returns (data (NB, L*k*k, BQ) ``out_dtype``, bad (NB, L) uint8: 1 where
    a start of the block left its fine window at that level, and the fine
    lookup saturated it)."""
    if coords.device.type == "cpu":
        return block_local_lookup_coords_plain(local, coords, k, out_dtype)
    return kernels.local_lookup_coords(coords, local.volumes,
                                       local.consts["table"], k, out_dtype)


def block_local_lookup_exact_coords_plain(local, coords, k, bad=None,
                                          out=None):
    """Plain PyTorch version of kernel E from coordinates (same arguments
    as ``block_local_lookup_exact_coords``)."""
    starts, frac = _local_level_coords(local, coords)
    flag = None if bad is None else bad.bool().any(dim=1).to(torch.uint8)
    return block_local_lookup_levels_plain(local.volumes, starts, frac, k,
                                           flag, out)


def block_local_lookup_exact_coords(local, coords, k, bad=None, out=None):
    """The exact lookup over the whole stored windows, every level, straight
    from the coordinates: one launch of kernel E on a CUDA tensor.

    Without ``out`` returns a new (NB, L*k*k, BQ) float32. With ``out`` it
    writes in place, and with ``bad`` (NB, L) uint8 only the blocks with a
    flag set at some level: the others keep their rows."""
    if coords.device.type == "cpu":
        return block_local_lookup_exact_coords_plain(local, coords, k, bad,
                                                     out)
    return kernels.local_lookup_exact_coords(coords, local.volumes,
                                             local.consts["table"], k, bad,
                                             out)


def corr_lookup_local_blocked(local, coords, radius=4, fine=True, check=True):
    """9x9 windows of every level around ``coords`` -> ``BlockedCorr``.

    coords: (1, H1, W1, 2) level-0 centroids in natural raster order.
    ``fine``: kernel D on each block's fine sub-window, exact while the
    block's slab starts fit it; D computes the starts, anchors and per-level
    flags from the coordinates itself. ``check`` (fine only): blocks with a
    flag set are rewritten by kernel E, launched once for all levels and
    writing into D's output, so the result equals the exact lookup
    everywhere with no host sync and no branch: two launches a lookup on the
    card. ``fine=False``: kernel E on every block, one launch, float32
    output. bfloat16 volumes give bfloat16 fine lookups (float32
    arithmetic). CPU tensors take the plain versions of the same steps."""
    meta = local.meta
    if radius != meta["radius"]:
        raise ValueError(f"volume built for radius {meta['radius']}, "
                         f"lookup asked for {radius}")
    k = 2 * radius + 1
    vols = local.volumes
    L = len(vols)
    if not fine:
        return BlockedCorr(block_local_lookup_exact_coords(local, coords, k),
                           meta, L, k)
    od = torch.bfloat16 if vols[0].dtype == torch.bfloat16 else torch.float32
    data, bad = block_local_lookup_coords(local, coords, k, od)
    if check:
        block_local_lookup_exact_coords(local, coords, k, bad=bad, out=data)
    return BlockedCorr(data, meta, L, k)


def corr_lookup_local(local, coords, radius=4, fine=True):
    """Window lookup against ``LocalCorrVolumes`` in the dense lookup's
    layout: (1, H1, W1, L*(2r+1)^2)."""
    return corr_lookup_local_blocked(local, coords, radius,
                                     fine=fine).to_natural()
