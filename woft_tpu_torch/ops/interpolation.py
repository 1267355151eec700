"""Flow interpolation and chaining utilities.

PyTorch twin of ``woft_tpu/ops/interpolation.py``
(ref:pytracking/utils/interpolation.py): sample a dense flow field at
sub-pixel positions (NaN outside), warp coordinates by a flow, chain two
flows, on the port's ``grid_sample`` and on the tensors' device; and the
numpy host helpers, a 4-corner bilinear gather and the forward
interpolation of a flow (scipy), as copies.
"""

import numpy as np
import torch

from .warp import coords_grid, grid_sample


def interp_flow(flow, coords, occlusion_nan=True):
    """Sample a dense flow at (x, y) positions, NaN out of bounds.

    flow: (H, W, 2) tensor; coords: (2, N) tensor. Returns (2, N)
    (ref:interpolation.py:26-71, scipy RegularGridInterpolator
    semantics: NaN outside [0, W - 1] x [0, H - 1])."""
    H, W = flow.shape[:2]
    coords = coords.to(flow.dtype)
    sampled = grid_sample(flow[None], coords.T[None, :, None, :])[0, :, 0].T
    if occlusion_nan:
        x, y = coords[0], coords[1]
        oob = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
        sampled = torch.where(oob[None], torch.nan, sampled)
    return sampled


def flow_warp_coords(coords, flow):
    """Warp (2, N) coordinates by a dense flow (ref:interpolation.py:74-89)."""
    return coords + interp_flow(flow, coords)


def chain_flow(flow_ab, flow_bc):
    """Compose two dense flows: a -> b then b -> c gives a -> c, zero where
    the intermediate point falls outside b. flows: (H, W, 2) tensors.

    (Completes the reference's unfinished chain_flow,
    ref:interpolation.py:9-23.)"""
    H, W = flow_ab.shape[:2]
    mid = coords_grid(1, H, W, device=flow_ab.device,
                      dtype=flow_ab.dtype)[0] + flow_ab
    return flow_ab + grid_sample(flow_bc[None], mid[None])[0]


def bilinear_interpolate(im, x, y):
    """Manual 4-corner bilinear gather (clamped borders), numpy host twin
    (ref:interpolation.py:92-133). im: (H, W[, C]); x, y: arrays."""
    im = np.asarray(im)
    x = np.asarray(x)
    y = np.asarray(y)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    x1 = x0 + 1
    y1 = y0 + 1
    x0c = np.clip(x0, 0, im.shape[1] - 1)
    x1c = np.clip(x1, 0, im.shape[1] - 1)
    y0c = np.clip(y0, 0, im.shape[0] - 1)
    y1c = np.clip(y1, 0, im.shape[0] - 1)

    Ia = im[y0c, x0c]
    Ib = im[y1c, x0c]
    Ic = im[y0c, x1c]
    Id = im[y1c, x1c]
    wa = (x1 - x) * (y1 - y)
    wb = (x1 - x) * (y - y0)
    wc = (x - x0) * (y1 - y)
    wd = (x - x0) * (y - y0)
    if im.ndim == 3:
        wa, wb, wc, wd = (w[..., None] for w in (wa, wb, wc, wd))
    return wa * Ia + wb * Ib + wc * Ic + wd * Id


def forward_interpolate(flow):
    """Forward-warp a flow field to the next frame's grid (nearest scatter,
    ref:raft_core/utils/utils.py:28-56). flow: (H, W, 2) numpy."""
    from scipy import interpolate as scinterp
    flow = np.asarray(flow)
    dx, dy = flow[..., 0], flow[..., 1]
    ht, wd = dx.shape
    x0, y0 = np.meshgrid(np.arange(wd), np.arange(ht))
    x1 = (x0 + dx).reshape(-1)
    y1 = (y0 + dy).reshape(-1)
    dxf = dx.reshape(-1)
    dyf = dy.reshape(-1)
    valid = (x1 > 0) & (x1 < wd) & (y1 > 0) & (y1 < ht)
    fx = scinterp.griddata((x1[valid], y1[valid]), dxf[valid], (x0, y0),
                           method="nearest", fill_value=0)
    fy = scinterp.griddata((x1[valid], y1[valid]), dyf[valid], (x0, y0),
                           method="nearest", fill_value=0)
    return np.stack([fx, fy], axis=-1).astype(np.float32)
