"""The yardstick's arithmetic: peaks, and operations and bytes from shapes.

Nothing here reads the program. Every count is a function of the cell's
shapes (frame size, the configuration's widths), so a change to the
program cannot move it. A multiply-add is two operations.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 67 TFLOP/s
float32 outside the tensor cores, 989 TFLOP/s bf16, 3.35 TB/s of HBM.
"""

PEAK_FLOPS = {"float32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def conv_flops(cin, cout, kh, kw, pixels):
    """A convolution's multiply-adds, twice, at ``pixels`` outputs."""
    return 2 * cin * cout * kh * kw * pixels


def encoder_flops(h, w, out_dim, dims=(64, 96, 128)):
    """RAFT-large's BasicEncoder on an (h, w) image: a 7x7 stride-2 stem,
    three stages of two residual blocks (the 2nd and 3rd stride 2, with a
    1x1 shortcut), a 1x1 output convolution at 1/8."""
    p = (h // 2) * (w // 2)
    total = conv_flops(3, dims[0], 7, 7, p)
    cin = dims[0]
    for stage, planes in enumerate(dims):
        if stage:
            p //= 4
        total += conv_flops(cin, planes, 3, 3, p)      # block 0, conv1
        total += conv_flops(planes, planes, 3, 3, p) * 3
        if cin != planes or stage:
            total += conv_flops(cin, planes, 1, 1, p)  # shortcut
        cin = planes
    return total + conv_flops(cin, out_dim, 1, 1, p)


def grid(h, w):
    """The 1/8 feature grid (H1, W1) and its cells."""
    return h // 8, w // 8, (h // 8) * (w // 8)


def level_sizes(h1, w1, levels):
    """(Hl, Wl) of each pyramid level: 2x2 pooling, floor."""
    out = []
    for _ in range(levels):
        out.append((h1, w1))
        h1, w1 = h1 // 2, w1 // 2
    return out


def update_flops_per_cell(m):
    """One refinement iteration of RAFT-large's update block at one cell:
    the motion encoder, both SepConvGRU directions (each of z, r, q reads
    [hidden, context, motion]) and the flow head."""
    hd, cd = m["hidden_dim"], m["context_dim"]
    cor = m["corr_levels"] * (2 * m["corr_radius"] + 1) ** 2
    motion = (conv_flops(cor, 256, 1, 1, 1) + conv_flops(256, 192, 3, 3, 1)
              + conv_flops(2, 128, 7, 7, 1) + conv_flops(128, 64, 3, 3, 1)
              + conv_flops(256, 128 - 2, 3, 3, 1))
    gru = 2 * 3 * conv_flops(hd + cd + 128, hd, 1, 5, 1)
    head = conv_flops(hd, 256, 3, 3, 1) + conv_flops(256, 2, 3, 3, 1)
    return motion + gru + head


def upsample_flops(m, cells):
    """The convex-upsampling mask head and the x8 convex combination of
    the flow (2 channels) and the weight logit (1)."""
    mask = (conv_flops(m["hidden_dim"], 256, 3, 3, cells)
            + conv_flops(256, 9 * 64, 1, 1, cells))
    return mask + 2 * 9 * 3 * 64 * cells


def weight_head_flops_per_cell(m):
    """WOFT's weight head at one cell: its convolution stack over the
    (2r+1)^2 patch of L + 1 channels, then the 1x1 output convolution."""
    k = 2 * m["corr_radius"] + 1
    cin, total = m["corr_levels"] + 1, 0
    for ch, ks in m["weight_head_structure"]:
        total += conv_flops(cin, ch, ks, ks, k * k)
        cin = ch
    return total + conv_flops(cin, 1, 1, 1, k * k)


def lookup_flops(m, queries):
    """One lookup: four bilinear taps of a (2r+1)^2 window a level."""
    k2 = (2 * m["corr_radius"] + 1) ** 2
    return 2 * 4 * k2 * m["corr_levels"] * queries


def dense_volume_flops(m, h, w):
    """The all-pairs pyramid: each query against every cell of each level
    (the levels from pooled features)."""
    h1, w1, q = grid(h, w)
    return sum(2 * q * hl * wl * m["fnet_dim"]
               for hl, wl in level_sizes(h1, w1, m["corr_levels"]))


LOCAL_BLOCK = (8, 16)


def local_layout(m, h, w, margin, block=LOCAL_BLOCK):
    """The block-local volume's geometry: queries in (8, 16) blocks, each
    block's stored window a level: its block's extent at that level plus
    ``max(margin >> l, r + 1) + r + 1`` on each side, the width rounded up
    to 8 (with 7 of headroom where the block's width is not a multiple of
    8, since window x-origins are aligned down to 8). Returns (blocks,
    queries a block, [(window rows, window columns) a level])."""
    h1, w1, _ = grid(h, w)
    bh, bw = block
    nb = -(-h1 // bh) * -(-w1 // bw)
    r = m["corr_radius"]
    wins = []
    for lvl in range(m["corr_levels"]):
        pad = max(margin >> lvl, r + 1) + r + 1
        sh, sw = bh >> lvl, bw >> lvl
        ww = -8 * (-(sw + 2 * pad + (7 if sw % 8 else 0)) // 8)
        wins.append((sh + 2 * pad, ww))
    return nb, bh * bw, wins


def local_volume_flops(m, h, w, margin):
    """The block-local volume: every query of a block against every stored
    position of its block's windows."""
    nb, bq, wins = local_layout(m, h, w, margin)
    return 2 * nb * bq * sum(a * b for a, b in wins) * m["fnet_dim"]


def local_volume_bytes(m, h, w, margin, elem=2):
    """Kernel C's bytes: the query features and every level of the other
    frame's features read once, the stored volume written once, all at
    the volume's element size (bf16)."""
    nb, bq, wins = local_layout(m, h, w, margin)
    h1, w1, q = grid(h, w)
    feats = q + sum(a * b for a, b in level_sizes(h1, w1, m["corr_levels"]))
    return elem * (feats * m["fnet_dim"] + nb * bq * sum(a * b
                                                         for a, b in wins))


def window_bytes(m, h1, w1, x, y, elem=4):
    """The in-level bytes of the (2r+2)^2 window (the window and its
    bilinear fringe) of a query at cell (x, y) of level 0, on every
    level."""
    r = m["corr_radius"]
    total = 0
    for lvl, (hl, wl) in enumerate(level_sizes(h1, w1, m["corr_levels"])):
        cx, cy = x >> lvl, y >> lvl
        nx = max(0, min(cx + r + 1, wl - 1) - max(cx - r, 0) + 1)
        ny = max(0, min(cy + r + 1, hl - 1) - max(cy - r, 0) + 1)
        total += nx * ny * elem
    return total


def dense_lookup_bytes(m, h, w, cells=None, elem=4):
    """Kernel B, one lookup: each query's windows read once (at the
    identity's coordinates: after the pre-warp the residual flow is a
    fraction of a cell), the (x, y) coordinates read and the float32
    output written once. ``cells``: the queried cells (default all)."""
    h1, w1, q = grid(h, w)
    k2 = (2 * m["corr_radius"] + 1) ** 2
    cells = range(q) if cells is None else cells
    reads = sum(window_bytes(m, h1, w1, c % w1, c // w1, elem) for c in cells)
    n = len(cells)
    return reads + n * (8 + 4 * k2 * m["corr_levels"])


def sparse_head_cells(h, w, target_frac, n_points):
    """The cells the sparse weight head evaluates for one target: the 3x3
    neighbourhood of each of its ``n_points`` points; counted as distinct
    cells, at most the cells of the target's box grown by one cell."""
    bh = int(h * target_frac) // 8 + 3
    bw = int(w * target_frac) // 8 + 3
    return min(9 * n_points, bh * bw)


def fit_flops(n_points):
    """A weighted least-squares homography by Householder QR of the
    (2n, 9) system [A | b]: about 2 m n^2 operations."""
    return 2 * (2 * n_points) * 9 ** 2


def frame_flops(m, corr, h, w, margin, n_points, sparse, fallback=False):
    """Model operations of one tracked frame (one target): the current
    frame's feature encoder, the correlation volume and its 12 + 1
    lookups, the refinement iterations, the upsampling, the weight head at
    the rows it evaluates (``sparse``: the target's points' 3x3
    neighbourhoods; else every cell), the fit. ``fallback`` adds the local
    flow (both frames encoded, context too, the dense head at every cell)
    and its fit. Returns {term: operations}."""
    h1, w1, q = grid(h, w)
    vol = (dense_volume_flops(m, h, w) if corr == "dense"
           else local_volume_flops(m, h, w, margin))
    ctx = m["hidden_dim"] + m["context_dim"]
    head_cells = n_points * 9 if sparse else q
    terms = {
        "encoders": encoder_flops(h, w, m["fnet_dim"]),
        "volume": vol + lookup_flops(m, q) * m["iters"]
        + lookup_flops(m, head_cells),
        "iterations": update_flops_per_cell(m) * q * m["iters"]
        + upsample_flops(m, q),
        "weight_head": weight_head_flops_per_cell(m) * head_cells,
        "fit": fit_flops(n_points),
    }
    if fallback:
        terms["encoders"] += (2 * encoder_flops(h, w, m["fnet_dim"])
                              + encoder_flops(h, w, ctx))
        terms["volume"] += vol + lookup_flops(m, q) * (m["iters"] + 1)
        terms["iterations"] += (update_flops_per_cell(m) * q * m["iters"]
                                + upsample_flops(m, q))
        terms["weight_head"] += weight_head_flops_per_cell(m) * q
        terms["fit"] += fit_flops(n_points)
    return terms


def bound_s(n_bytes, n_flops, peak):
    """The least time: the larger of bytes over HBM bandwidth and
    operations over ``peak``."""
    return max(n_bytes / HBM_BYTES_PER_S, n_flops / peak)
