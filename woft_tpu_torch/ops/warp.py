"""Image sampling and warping primitives (NHWC, (x, y) pixel coordinates).

PyTorch twin of ``woft_tpu/ops/warp.py``:

- ``grid_sample``         ~ torch ``F.grid_sample(align_corners=True,
                            padding_mode='zeros')`` in pixel coordinates
- ``warp_perspective``    ~ ``cv2.warpPerspective`` (INTER_LINEAR /
                            INTER_NEAREST, constant 0 border)
- ``warp_perspective_fast`` — the tracker's pre-warp: the plain bilinear
                            warp on CPU tensors, CUDA kernel A on the card
- ``warp_axis_aligned``   — the window tracker's crop by a scale-and-
                            translate H, into another output size: the same
                            function, kernel A on the card
- ``upsample2d_align_corners`` / ``upflow8``, ``avg_pool2d``,
  ``warp_validity_at``, ``coords_grid``.

Coordinates are computed element by element (no matmul), so the CUDA
kernel, built without FMA contraction, repeats their float32 rounding
exactly.
"""

import torch
import torch.nn.functional as F

from . import kernels


def _gather_nhwc(img, iy, ix):
    """img (N,H,W,C) or (1,H,W,C), iy/ix (N, ...) int64 -> (N, ..., C); a
    single source serves every row of the indices."""
    if img.shape[0] == 1:
        return img[0][iy, ix]
    N = img.shape[0]
    bidx = torch.arange(N, device=img.device).reshape(
        (N,) + (1,) * (iy.dim() - 1)).expand(iy.shape)
    return img[bidx, iy, ix]


def grid_sample(img, coords, mode="bilinear"):
    """Sample ``img`` (N, H, W, C) at (N, ..., 2) pixel coordinates with
    zero padding outside; out-of-bounds bilinear corners contribute
    exactly 0. Returns (N, ..., C)."""
    H, W = img.shape[1], img.shape[2]
    x = coords[..., 0]
    y = coords[..., 1]

    if mode == "nearest":
        ix = torch.round(x).long()
        iy = torch.round(y).long()
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        out = _gather_nhwc(img, iy.clamp(0, H - 1), ix.clamp(0, W - 1))
        return out * valid[..., None].to(img.dtype)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.long()
    y0 = y0.long()
    out = None
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            ix = x0 + dx
            iy = y0 + dy
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            v = _gather_nhwc(img, iy.clamp(0, H - 1), ix.clamp(0, W - 1))
            w = (wx * wy) * valid.to(img.dtype)
            term = v * w[..., None]
            out = term if out is None else out + term
    return out


def inverse_h(H):
    """float32 inverse of (N, 3, 3) homographies, without the host sync
    that ``torch.linalg.inv``'s singularity check costs on the card."""
    return torch.linalg.inv_ex(H.to(torch.float32))[0].contiguous()


def _back_project(Hinv, xs, ys):
    """Source (x, y) of destination points under (N,3,3) ``Hinv``, with
    the |z| < 1e-12 clamp; xs/ys broadcast against (N, 1, 1)."""
    h = Hinv[:, :, :, None, None]
    sx = h[:, 0, 0] * xs + h[:, 0, 1] * ys + h[:, 0, 2]
    sy = h[:, 1, 0] * xs + h[:, 1, 1] * ys + h[:, 1, 2]
    z = h[:, 2, 0] * xs + h[:, 2, 1] * ys + h[:, 2, 2]
    eps = torch.where(z < 0, -1e-12, 1e-12)
    z = torch.where(z.abs() < 1e-12, eps, z)
    return sx / z, sy / z


def perspective_coords(H, out_hw):
    """Back-projected source coordinates of a perspective warp.

    H: (N, 3, 3) forward homography (src -> dst). Returns
    (N, out_h, out_w, 2) float32 (x, y) source positions of each
    destination pixel centre."""
    out_h, out_w = out_hw
    Hinv = inverse_h(H)
    ys, xs = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=H.device),
        torch.arange(out_w, dtype=torch.float32, device=H.device),
        indexing="ij")
    sx, sy = _back_project(Hinv, xs, ys)
    return torch.stack([sx, sy], dim=-1)


def warp_perspective(img, H, out_shape=None, mode="bilinear"):
    """``cv2.warpPerspective`` twin: dst(x, y) = src(H^-1 (x, y)).

    img: (N, H, W, C), or (1, H, W, C) warped by each of N homographies;
    H: (N, 3, 3) or (3, 3) forward homography; mode 'bilinear' or
    'nearest' (cv2's floor(x + 0.5) rounding)."""
    if H.dim() == 2:
        H = H[None]
    out_h, out_w = out_shape if out_shape is not None else img.shape[1:3]
    coords = perspective_coords(H, (out_h, out_w))
    if mode == "nearest":
        ix = torch.floor(coords[..., 0] + 0.5).long()
        iy = torch.floor(coords[..., 1] + 0.5).long()
        Hs, Ws = img.shape[1], img.shape[2]
        valid = (ix >= 0) & (ix < Ws) & (iy >= 0) & (iy < Hs)
        out = _gather_nhwc(img, iy.clamp(0, Hs - 1), ix.clamp(0, Ws - 1))
        return out * valid[..., None].to(img.dtype)
    return grid_sample(img, coords, mode="bilinear")


def warp_perspective_fast(img, H, out_shape=None):
    """The tracker's bilinear pre-warp (``warp_perspective`` semantics).

    On a CPU tensor it is the plain ``warp_perspective``; on a CUDA tensor
    it launches kernel A (``csrc/warp.cu``), which is exact for every pose,
    so the TPU's pose envelope and its gather fallback have no counterpart.
    A source batch of 1 with N homographies gives N warps of that one
    source in one launch (the multi-target tracker's N search crops).
    Kernel A has no backward: under grad, inputs that require grad raise.
    """
    kernels.require_no_grad("A (warp_perspective_fast)", img, H)
    if H.dim() == 2:
        H = H[None]
    out_h, out_w = out_shape if out_shape is not None else img.shape[1:3]
    if img.device.type == "cpu":
        return warp_perspective(img, H, (out_h, out_w))
    return kernels.warp_perspective_bilinear(img, inverse_h(H), out_h, out_w)


def warp_axis_aligned(img, H, out_shape=None):
    """Bilinear warp by an axis-aligned (scale-and-translate) ``H`` with
    zeros outside the source: the window tracker's crops, typically from a
    full frame into a window of another size.

    Twin of ``woft_tpu/ops/warp.py:warp_axis_aligned``, which resamples with
    two one-hot matmuls, a trick for the TPU's matrix unit. Here it is
    ``warp_perspective_fast``: the plain ``warp_perspective`` on a CPU
    tensor, kernel A on a CUDA tensor, which computes this function for any
    pose, an axis-aligned one included."""
    return warp_perspective_fast(img, H, out_shape)


def warp_validity_at(H, src_hw, pts):
    """Analytic twin of ``cv2.warpPerspective(ones, H) > 0`` at points.

    H: (3, 3) forward homography and pts (P, 2) (x, y) destination points,
    or a batch: H (N, 3, 3), pts (N, P, 2). Returns (P,) or (N, P) bool:
    any bilinear corner of the back-projected sample lies inside the
    source, i.e. the source point is in (-1, W) x (-1, H)."""
    src_h, src_w = src_hw
    p = pts.to(torch.float32)
    if H.dim() == 2:
        H, p = H[None], p[None]
    sx, sy = _back_project(inverse_h(H), p[:, None, :, 0], p[:, None, :, 1])
    sx, sy = sx.reshape(pts.shape[:-1]), sy.reshape(pts.shape[:-1])
    return (sx > -1.0) & (sx < src_w) & (sy > -1.0) & (sy < src_h)


def upsample2d_align_corners(x, out_hw):
    """Bilinear resize (N, H, W, C) with ``align_corners=True``: output
    pixel i maps to input coordinate ``i * (in - 1) / (out - 1)``."""
    out_h, out_w = out_hw
    in_h, in_w = x.shape[1], x.shape[2]
    sy = (in_h - 1) / (out_h - 1) if out_h > 1 else 0.0
    sx = (in_w - 1) / (out_w - 1) if out_w > 1 else 0.0
    ys = torch.arange(out_h, dtype=torch.float32, device=x.device) * sy
    xs = torch.arange(out_w, dtype=torch.float32, device=x.device) * sx
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([gx, gy], dim=-1)[None].expand(x.shape[0], -1, -1, -1)
    return grid_sample(x, coords, mode="bilinear")


def upflow8(flow):
    """x8 bilinear flow upsampling with value scaling. flow: (N, H, W, 2)."""
    return 8.0 * upsample2d_align_corners(
        flow, (8 * flow.shape[1], 8 * flow.shape[2]))


def avg_pool2d(x, window=2, stride=2):
    """``F.avg_pool2d`` on NHWC (valid padding, floor output size; a side
    shorter than the window gives an empty map, as in the JAX package)."""
    N, H, W, C = x.shape
    if H < window or W < window:
        return x.new_zeros((N, max(0, (H - window) // stride + 1),
                            max(0, (W - window) // stride + 1), C))
    return F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride).permute(
        0, 2, 3, 1)


def coords_grid(batch, ht, wd, device=None, dtype=torch.float32):
    """(N, H, W, 2) grid of (x, y) pixel coordinates."""
    ys, xs = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                            torch.arange(wd, dtype=dtype, device=device),
                            indexing="ij")
    return torch.stack([xs, ys], dim=-1)[None].expand(batch, ht, wd, 2)
