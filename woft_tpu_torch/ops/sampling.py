"""Quasi-random subsampling and coordinate utilities.

PyTorch twin of ``woft_tpu/ops/sampling.py``: the reference subsamples
tentative correspondences (TCs: template<->current point pairs taken from
the dense flow) to <= 500 points with a 1-D Sobol draw;
``masked_sobol_gather`` re-expresses that selection as a fixed-size gather
plus per-slot validity, and gives the same indices as the JAX package. On
the card it is kernel N (``kernels.masked_sobol_select``); on the CPU its
plain version, ``masked_sobol_gather_plain``.
"""

import functools

import numpy as np
import torch

from . import kernels


def sobol_1d(n, dtype=np.float32):
    """First ``n`` points of the 1-D Sobol sequence (Gray-code order),
    equal to ``torch.quasirandom.SobolEngine(dimension=1).draw(n)``:
    x_k = sum_i bit_i(gray(k)) * 2^-(i+1), gray(k) = k ^ (k >> 1)."""
    k = np.arange(n, dtype=np.uint64)
    gray = k ^ (k >> np.uint64(1))
    out = np.zeros(n, dtype=np.float64)
    scale = 0.5
    for _ in range(32):
        out += (gray & np.uint64(1)).astype(np.float64) * scale
        gray >>= np.uint64(1)
        scale *= 0.5
        if not gray.any():
            break
    return out.astype(dtype)


def featuremap_coords(hw, device=None, dtype=torch.float32):
    """(2, H*W) x,y coordinate list in raster order."""
    H, W = hw
    idx = torch.arange(H * W, device=device)
    return torch.stack([(idx % W).to(dtype), (idx // W).to(dtype)], dim=0)


@functools.lru_cache(maxsize=8)
def _sobol_on(n, device):
    """``sobol_1d(n)`` as a tensor on ``device``, made once: a tensor from
    host numbers is a blocking copy to the card, and the tracker steps
    gather every frame without syncing to the host."""
    return torch.from_numpy(sobol_1d(n)).to(device)


@functools.lru_cache(maxsize=8)
def _sobol_sorted_on(n, device):
    """Kernel N's table: ``sobol_1d(n)`` sorted ascending, on ``device``,
    made once. x -> round(float32(n_valid * x)) is non-decreasing in x, so
    rounding the sorted table gives the sorted targets, duplicates
    included, and the kernel sorts nothing."""
    return torch.from_numpy(np.sort(sobol_1d(n))).to(device)


def masked_sobol_gather(valid, n=500):
    """Static-shape Sobol subsampling of the valid entries of a point list:
    kernel N on a CUDA tensor, ``masked_sobol_gather_plain`` on the CPU,
    equal at every slot (see there for the arguments and the result)."""
    if valid.device.type != "cuda":
        return masked_sobol_gather_plain(valid, n)
    lead, P = valid.shape[:-1], valid.shape[-1]
    idx, sel = kernels.masked_sobol_select(
        valid.reshape(-1, P).contiguous(), _sobol_sorted_on(n, valid.device))
    return idx.reshape(*lead, n), sel.reshape(*lead, n)


def masked_sobol_gather_plain(valid, n=500):
    """Static-shape Sobol subsampling of the valid entries of a point list:
    ``masked_sobol_gather``'s plain version, which CPU tensors take.

    Args:
        valid: (P,) or (N, P) bool — validity of each point slot, one row
            a target (the JAX package gets the batch from ``vmap``).
        n: number of gather slots (the reference's ``to_draw``).
    Returns:
        (indices (..., n) int64 into the P slots, sel_valid (..., n) bool),
        row t of a batch equal to the call on row t alone.

    ``n_valid > n``: targets are float32 ``round(n_valid * sobol(n))``
    (half to even) positions in the compacted valid list, sorted, with
    duplicates collapsed by zeroed validity. ``n_valid <= n``: the first
    ``n_valid`` positions. Position k maps to the first raster slot whose
    running count of valid slots reaches k + 1.
    """
    device = valid.device
    valid = valid.to(torch.int64)
    P = valid.shape[-1]
    n_valid = valid.sum(dim=-1, keepdim=True)                 # (..., 1)
    cs = torch.cumsum(valid, dim=-1)                          # (..., P)

    sobol = _sobol_on(n, device)
    sub_targets = torch.round(n_valid.to(torch.float32) * sobol).to(torch.int64)
    sub_targets, _ = torch.sort(sub_targets, dim=-1)
    dup = torch.cat([torch.zeros_like(sub_targets[..., :1], dtype=torch.bool),
                     sub_targets[..., 1:] == sub_targets[..., :-1]], dim=-1)
    all_targets = torch.arange(n, device=device)

    use_sub = n_valid > n
    targets = torch.where(use_sub, sub_targets, all_targets)
    tgt_valid = torch.where(use_sub, ~dup, all_targets < n_valid)
    tgt_valid &= targets < n_valid

    idx = torch.searchsorted(cs, targets + 1, side="left")
    return idx.clamp(0, P - 1), tgt_valid
