"""Batched weighted least-squares homography estimation (main-path subset).

PyTorch twin of ``woft_tpu/geometry/homography.py``: non-homogeneous DLT
(H33 fixed to 1), Hartley-normalised, weighted rows, solved by reduced QR
and a triangular solve in float32. Zero weights remove points exactly, which
turns the reference's dynamic point filtering into static-shape weighting.

Shapes follow the JAX package: points (B, N, 2), homographies (B, 3, 3),
projective helpers on (B, 2|3, N). The ``np_*`` helpers are the host-side
float64 numpy twins the window tracker's shell composes its crops with.
"""

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-8


def e2p(pts):
    """(B, 2, N) euclidean -> (B, 3, N) homogeneous."""
    return torch.cat([pts, torch.ones_like(pts[..., :1, :])], dim=-2)


def p2e(homo, eps=_EPS):
    """(B, 3, N) homogeneous -> (B, 2, N) euclidean; points with
    |z| <= eps pass through unscaled instead of producing inf."""
    z = homo[..., -1:, :]
    one = torch.ones_like(z)
    scale = torch.where(z.abs() > eps, 1.0 / torch.where(z == 0, one, z), one)
    return homo[..., :-1, :] * scale


def h_proj(H, pts):
    """Project points by homographies. H: (B, 3, 3), pts: (B, 2, N)."""
    return p2e(H @ e2p(pts))


def compose_h(*Hs):
    """Compose homographies right-to-left and normalise H33 to 1:
    ``compose_h(A, B)`` applies ``A`` first, result = B @ A."""
    result = functools.reduce(torch.matmul, reversed(Hs))
    return result / result[..., 2:3, 2:3]


def normalize_points(points, weights=None, eps=_EPS):
    """Hartley-normalise a point set: zero centroid, mean norm sqrt(2).

    ``weights`` (B, N) masks the statistics so zero-weight points do not
    pollute them. Returns (normed (B, N, 2), transform (B, 3, 3))."""
    if weights is None:
        mean = points.mean(dim=1, keepdim=True)                   # (B,1,2)
        scale = torch.linalg.norm(points - mean, dim=-1).mean(dim=-1)
    else:
        w = weights[..., None]                                    # (B,N,1)
        wsum = w.sum(dim=1, keepdim=True)
        mean = (points * w).sum(dim=1, keepdim=True) / (wsum + eps)
        dist = torch.linalg.norm(points - mean, dim=-1)           # (B,N)
        scale = (dist * weights).sum(dim=-1) / (wsum[..., 0, 0] + eps)
    scale = math.sqrt(2.0) / (scale + eps)                        # (B,)

    z = torch.zeros_like(scale)
    o = torch.ones_like(scale)
    transform = torch.stack([
        torch.stack([scale, z, -scale * mean[:, 0, 0]], dim=-1),
        torch.stack([z, scale, -scale * mean[:, 0, 1]], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)                                                    # (B,3,3)
    normed = (points - mean) * scale[:, None, None]
    return normed, transform


def _inv_norm_transform(transform):
    """Closed-form inverse of a Hartley normalisation transform."""
    s = transform[..., 0, 0]
    tx = transform[..., 0, 2]
    ty = transform[..., 1, 2]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    inv_s = 1.0 / s
    return torch.stack([
        torch.stack([inv_s, z, -tx * inv_s], dim=-1),
        torch.stack([z, inv_s, -ty * inv_s], dim=-1),
        torch.stack([z, z, o], dim=-1),
    ], dim=-2)


def _build_nonhomogeneous_system(points1, points2, weights):
    """The interleaved (B, 2N, 8) system A x = b with H33 fixed to 1; per
    correspondence the rows

        [0 0 0 -x1 -y1 -1  y2*x1  y2*y1] x = -y2
        [x1 y1 1  0  0  0 -x2*x1 -x2*y1] x =  x2

    with weights multiplying the rows directly (w, not sqrt(w))."""
    x1, y1 = points1[..., 0], points1[..., 1]
    x2, y2 = points2[..., 0], points2[..., 1]
    ones = torch.ones_like(x1)
    zeros = torch.zeros_like(x1)

    ax = torch.stack([zeros, zeros, zeros, -x1, -y1, -ones, y2 * x1, y2 * y1],
                     dim=-1)                                      # (B,N,8)
    ay = torch.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1],
                     dim=-1)                                      # (B,N,8)
    A = torch.stack([ax, ay], dim=2).reshape(x1.shape[0], -1, 8)  # (B,2N,8)
    b = torch.stack([-y2, x2], dim=-1).reshape(x1.shape[0], -1, 1)

    if weights is not None:
        w = torch.repeat_interleave(weights, 2, dim=-1)[..., None]
        A = w * A
        b = w * b
    return A, b


def _solution_to_h(solution, transform1, transform2, eps=_EPS):
    """Append H33=1, reshape, and undo the normalisation transforms."""
    B = solution.shape[0]
    ones = torch.ones((B, 1, 1), dtype=solution.dtype, device=solution.device)
    h = torch.cat([solution, ones], dim=1).reshape(B, 3, 3)
    H = _inv_norm_transform(transform2) @ (h @ transform1)
    return H / (H[..., 2:3, 2:3] + eps)


def find_homography_wls_qr(points1, points2, weights=None, *,
                           mask_normalization=True):
    """Weighted least-squares homography via QR (the canonical WOFT solver).

    Args:
        points1: (B, N, 2) source points.
        points2: (B, N, 2) destination points (H maps 1 -> 2).
        weights: optional (B, N).
        mask_normalization: normalise with weight-masked statistics.
    Returns:
        (B, 3, 3) homographies with H33 = 1.
    """
    norm_w = weights if mask_normalization else None
    p1n, t1 = normalize_points(points1, norm_w)
    p2n, t2 = normalize_points(points2, norm_w)
    A, b = _build_nonhomogeneous_system(p1n, p2n, weights)
    return _solution_to_h(_lstsq_qr(A, b), t1, t2)


_TSQR_ROWS = 256


def _lstsq_qr(A, b):
    """argmin_x ||A x - b|| by QR, each of the B systems on its own.

    A: (B, M, n); b: (B, M, 1). One system takes Q explicitly. A batch
    takes only the R of the augmented [A | b], whose last column is Q^T b
    (the Householder reflectors of A's columns applied to b), by a
    two-level tall-skinny QR: the R of each block of at most 256 rows,
    then the R of the stacked blocks' Rs. The same least-squares solution,
    and on the card a fixed number of launches for any B (the library
    solver factors a tall matrix one system after another)."""
    if A.shape[0] == 1:
        q, r = torch.linalg.qr(A)                      # (1,M,n), (1,n,n)
        return torch.linalg.solve_triangular(r, q.transpose(-1, -2) @ b,
                                             upper=True)
    B, M, n = A.shape
    blocks = -(-M // _TSQR_ROWS)
    ab = F.pad(torch.cat([A, b], dim=-1), (0, 0, 0, blocks * _TSQR_ROWS - M))
    r = torch.linalg.qr(ab.reshape(B * blocks, _TSQR_ROWS, n + 1),
                        mode="r")[1]
    r = torch.linalg.qr(r.reshape(B, blocks * (n + 1), n + 1), mode="r")[1]
    return torch.linalg.solve_triangular(r[:, :n, :n], r[:, :n, n:],
                                         upper=True)


def proj_errors(H, pts_a, pts_b):
    """L2 distance between ``H @ pts_a`` and ``pts_b``.
    H: (B,3,3); pts_a, pts_b: (B,2,N). Returns (B, N)."""
    return torch.linalg.norm(h_proj(H, pts_a) - pts_b, dim=-2)


# ---------------------------------------------------------------------------
# numpy twins (host-side glue: the window tracker's crop bookkeeping)
# ---------------------------------------------------------------------------

def np_e2p(xs):
    """(D, N) -> (D+1, N) homogeneous (ref:geom_utils.py:234-236)."""
    return np.vstack((xs, np.ones(xs.shape[1])))


def np_p2e(xs):
    """(D+1, N) -> (D, N) euclidean (ref:geom_utils.py:239-242)."""
    return xs[:-1, :] / np.reshape(xs[-1, :], (1, xs.shape[1]))


def np_h_proj(H, points):
    """Project (D, N) points by a homography (ref:geom_utils.py:200-210)."""
    return np_p2e(np.matmul(H, np_e2p(points)))


def np_compose_h(*Hs):
    """Compose homographies right-to-left, None-propagating, H33-normalised
    (ref:geom_utils.py:365-373)."""
    for H in Hs:
        if H is None:
            return None
    result = functools.reduce(np.dot, reversed(Hs))
    return result / result[2, 2]
