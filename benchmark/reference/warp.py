"""Plain float32 perspective warps (NHWC, (x, y) pixel coordinates).

The semantics of ``cv2.warpPerspective`` with a constant 0 border:
``dst(x, y) = src(H^-1 (x, y))``, bilinear with out-of-image taps
contributing 0, or nearest with ``floor(x + 0.5)``. The benchmark renders
its traffic with this warp, and the reference tracker pre-warps with it.
"""

import torch


def inverse_h(H):
    """float32 inverse of (N, 3, 3) homographies."""
    return torch.linalg.inv_ex(H.to(torch.float32))[0]


def back_project(Hinv, xs, ys):
    """Source (x, y) of destination points under (N, 3, 3) ``Hinv``, with
    |z| clamped to 1e-12; xs, ys broadcast against (N, 1, 1)."""
    h = Hinv[:, :, :, None, None]
    sx = h[:, 0, 0] * xs + h[:, 0, 1] * ys + h[:, 0, 2]
    sy = h[:, 1, 0] * xs + h[:, 1, 1] * ys + h[:, 1, 2]
    z = h[:, 2, 0] * xs + h[:, 2, 1] * ys + h[:, 2, 2]
    eps = torch.where(z < 0, -1e-12, 1e-12)
    z = torch.where(z.abs() < 1e-12, eps, z)
    return sx / z, sy / z


def _gather(img, iy, ix):
    """img (1, H, W, C), iy/ix (N, h, w) -> (N, h, w, C)."""
    return img[0][iy, ix]


def warp(img, H, mode="bilinear"):
    """Warp (1, H, W, C) float ``img`` by (3, 3) or (N, 3, 3) ``H``
    (src -> dst) into the same size. Returns (N, H, W, C) float32."""
    if H.dim() == 2:
        H = H[None]
    h, w = img.shape[1:3]
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=img.device),
        torch.arange(w, dtype=torch.float32, device=img.device),
        indexing="ij")
    x, y = back_project(inverse_h(H), xs, ys)
    if mode == "nearest":
        ix = torch.floor(x + 0.5).long()
        iy = torch.floor(y + 0.5).long()
        ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        out = _gather(img, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
        return out * ok[..., None].to(img.dtype)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0, y0 = x0.long(), y0.long()
    out = None
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            ix, iy = x0 + dx, y0 + dy
            ok = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            v = _gather(img, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
            term = v * ((wx * wy) * ok.to(img.dtype))[..., None]
            out = term if out is None else out + term
    return out


def validity_at(H, hw, pts):
    """Whether a bilinear warp by (3, 3) ``H`` filled destination points
    ``pts`` (P, 2) (x, y): their source lies in (-1, W) x (-1, H)."""
    h, w = hw
    p = pts.to(torch.float32)
    sx, sy = back_project(inverse_h(H[None]), p[None, None, :, 0],
                          p[None, None, :, 1])
    sx, sy = sx.reshape(-1), sy.reshape(-1)
    return (sx > -1.0) & (sx < w) & (sy > -1.0) & (sy < h)
