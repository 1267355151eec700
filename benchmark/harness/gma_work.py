"""Model operations of the shared-flow step with GMA as its flow network,
and kernel M's least time, from the cell's shapes with ``work.py``'s terms
(nothing here reads the program).

A frame's flow is ``shared_work.py``'s with GMA's work added: each of its
iterations over every cell reads a SepConvGRU input of 384 channels where
RAFT's reads 256 (both directions, z, r and q), and the aggregation, ``v
= to_v(mf)`` and the product of the template's (N, N) attention with v.
The template's attention (q, k and its rows) is built once a sequence and
is not counted a frame. Each target of a frame adds ``shared_work.py``'s
terms.

Kernel M's least time (``aggregate_bound_s``) counts the work any exact
form of the aggregation must do, whatever implements it: the product's
operations at the bf16 peak, or the bytes read and written once at HBM
bandwidth: v (or mf) read, mf_g written, the template's q and k read once.
A stored matrix of probabilities and recomputed scores are not counted, so
no form can read above 100 % of it.
"""

from benchmark.harness import shared_work, work

ELEM = 2                    # bf16 bytes


def head_dim(m):
    return m["gma_heads"] * m["gma_dim_head"]


def aggregate_flops(m, cells):
    """One aggregation's product, attn (N, N) @ v (N, d): 2 N^2 d."""
    return 2 * cells * cells * head_dim(m)


def aggregate_bytes(m, cells):
    """One aggregation's least traffic: v (or mf) read and mf_g written,
    (N, d) each, and q and k read once, (N, d) each."""
    return 4 * cells * head_dim(m) * ELEM


def aggregate_bound_s(m, cells):
    """Kernel M's least time for one aggregation of ``cells`` cells."""
    return work.bound_s(aggregate_bytes(m, cells), aggregate_flops(m, cells),
                        work.PEAK_FLOPS["bf16"])


def gma_flops_per_cell(m, cells):
    """GMA's work at one cell in one iteration over ``cells`` cells:
    ``to_v``, the product's row, and the GRU's wider input (2 directions x
    z, r, q, 1x5 taps, the aggregation's channels in, hidden out)."""
    d = head_dim(m)
    wider = m["gru_input_dim"] - (m["context_dim"] + 128)
    return (work.conv_flops(d, d, 1, 1, 1) + 2 * cells * d
            + 2 * 3 * work.conv_flops(wider, m["hidden_dim"], 1, 5, 1))


def frame_flops(m, h, w, margin):
    """The shared flow of one (h, w) frame: {term: operations}."""
    out = shared_work.frame_flops(m, h, w, margin)
    _, _, q = work.grid(h, w)
    out["gma"] = gma_flops_per_cell(m, q) * q * m["iters"]
    return out


def records_flops(cfg, traffic, records):
    """Operations of the calls ``records`` (each with its answers ``H``,
    (frames, targets, 3, 3)): every frame's flow and every target-frame's
    terms."""
    m = cfg["model"]
    flow = frame_flops(m, traffic["height"], traffic["width"],
                       cfg["flow"]["local_margin"])
    target = shared_work.target_flops(m, cfg["tracker"]["subsample_n"])
    frames = sum(r["H"].shape[0] for r in records)
    targets = sum(r["H"].shape[0] * r["H"].shape[1] for r in records)
    return frames * sum(flow.values()) + targets * sum(target.values())
