"""Model operations of the shared-flow multi-target step, from the cell's
shapes with ``work.py``'s terms (nothing here reads the program).

A frame runs one flow for every target: the frame's feature encoder, the
block-local volume and its 12 dense lookups, the refinement iterations
over every cell and the upsampling. Each target of the frame adds the
weight head at the 3x3 neighbourhoods of its points (9 rows a point,
counted whatever the program evaluates: at 1080p eight targets ask for
36,000 rows, more than the 32,400 cells the program then evaluates once
each) with their lookup, and its fit.
"""

from benchmark.harness import work


def frame_flops(m, h, w, margin):
    """The shared flow of one (h, w) frame: {term: operations}."""
    _, _, q = work.grid(h, w)
    return {
        "encoders": work.encoder_flops(h, w, m["fnet_dim"]),
        "volume": work.local_volume_flops(m, h, w, margin)
        + work.lookup_flops(m, q) * m["iters"],
        "iterations": work.update_flops_per_cell(m) * q * m["iters"]
        + work.upsample_flops(m, q),
    }


def target_flops(m, n_points):
    """One target of a frame: {term: operations}."""
    rows = 9 * n_points
    return {"volume": work.lookup_flops(m, rows),
            "weight_head": work.weight_head_flops_per_cell(m) * rows,
            "fit": work.fit_flops(n_points)}


def records_flops(cfg, traffic, records):
    """Operations of the calls ``records`` (each with its answers ``H``,
    (frames, targets, 3, 3)): every frame's flow and every target-frame's
    terms. ``cfg``: the configuration file's contents; ``traffic``: the
    traffic parameters."""
    m = cfg["model"]
    flow = frame_flops(m, traffic["height"], traffic["width"],
                       cfg["flow"]["local_margin"])
    target = target_flops(m, cfg["tracker"]["subsample_n"])
    frames = sum(r["H"].shape[0] for r in records)
    targets = sum(r["H"].shape[0] * r["H"].shape[1] for r in records)
    return frames * sum(flow.values()) + targets * sum(target.values())
