"""The yardstick's arithmetic for RAFT's volume-free correlation (the
configuration ``woft_alt``): a frame's model operations, and kernel K's
operations and bytes a lookup.

Like ``work.py`` it reads nothing of the program: every count is a
function of the cell's shapes. A multiply-add is two operations.

No volume is stored: each lookup takes, for every query and level, the
products of the query's features with the (2r+2)^2 integer taps of its
window (``alt_lookup_flops``), then blends them as the stored-volume
lookup does (``work.lookup_flops``). A flow is 12 lookups over every cell
and one for the weight head: over every cell for the dense head (the local
fallback's), over its rows for the sparse head (9 a point).
"""

from benchmark.harness import work

FP32_FLOPS = work.PEAK_FLOPS["float32"]
HBM_BYTES_PER_S = work.HBM_BYTES_PER_S


def alt_lookup_flops(m, queries):
    """One lookup of ``queries`` queries: each one's (2r+2)^2 tap products
    over ``fnet_dim`` channels at every level, and the blend of its
    (2r+1)^2 outputs a level (``work.lookup_flops``)."""
    taps = (2 * m["corr_radius"] + 2) ** 2
    return (2 * queries * m["corr_levels"] * taps * m["fnet_dim"]
            + work.lookup_flops(m, queries))


def alt_dense_bytes(m, h, w, elem=4):
    """Kernel K over every cell: the query features, every level of the
    other frame's pooled features and the coordinates read once, the
    output written once (float32)."""
    h1, w1, q = work.grid(h, w)
    k2 = (2 * m["corr_radius"] + 1) ** 2
    cells = sum(a * b for a, b in work.level_sizes(h1, w1,
                                                   m["corr_levels"]))
    return elem * ((q + cells) * m["fnet_dim"] + 2 * q
                   + q * k2 * m["corr_levels"])


def alt_indexed_bytes(m, h, w, target_frac, rows, elem=4):
    """Kernel K over the sparse head's ``rows`` rows (cells of the
    centred target box, ``target_frac`` of each side): the rows' features,
    coordinates and int64 indices read, their output written, and of each
    level the target box's cells grown by the window's reach (r + 1 cells
    a side) read once."""
    h1, w1, _ = work.grid(h, w)
    r, d = m["corr_radius"], m["fnet_dim"]
    bh = int(h * target_frac) // 8 + 3
    bw = int(w * target_frac) // 8 + 3
    feats = 0
    for lvl, (hl, wl) in enumerate(work.level_sizes(h1, w1,
                                                    m["corr_levels"])):
        feats += (min(hl, (bh >> lvl) + 2 * r + 2)
                  * min(wl, (bw >> lvl) + 2 * r + 2))
    k2 = (2 * r + 1) ** 2
    return (elem * (feats * d + rows * (d + 2 + k2 * m["corr_levels"]))
            + 8 * rows)


def bound_s(n_bytes, n_flops):
    """K's least time (``work.bound_s`` at the float32 peak: the
    configuration keeps TF32 off)."""
    return work.bound_s(n_bytes, n_flops, FP32_FLOPS)


def frame_flops(m, h, w, n_points, sparse, fallback=False):
    """Model operations of one tracked frame on the alternate correlation:
    ``work.frame_flops`` of the dense configuration with its all-pairs
    volume replaced by the lookups' tap products. Returns {term:
    operations}."""
    _, _, q = work.grid(h, w)
    terms = work.frame_flops(m, "dense", h, w, 0, n_points, sparse,
                             fallback)
    head_cells = n_points * 9 if sparse else q
    terms["volume"] = (alt_lookup_flops(m, q) * m["iters"]
                       + alt_lookup_flops(m, head_cells))
    if fallback:
        terms["volume"] += alt_lookup_flops(m, q) * (m["iters"] + 1)
    return terms


def frames_flops(cell, traffic_spec, records):
    """Model operations of the recorded frames (a frame whose check failed
    adds the local fallback)."""
    cfg, m = cell.config, cell.config["model"]
    h, w = traffic_spec["height"], traffic_spec["width"]
    n = cfg["tracker"]["subsample_n"]
    sparse = cfg["tracker"]["sparse_weights"]

    def one(fallback):
        return sum(frame_flops(m, h, w, n, sparse, fallback).values())
    return sum(one(not r["ok"] and cfg["tracker"]["redetection"]
                   == "inliers") for r in records)
