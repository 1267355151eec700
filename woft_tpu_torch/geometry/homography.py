"""Batched homography estimation.

PyTorch twin of ``woft_tpu/geometry/homography.py``, in float32 (TF32 off,
``device.py``):

- non-homogeneous DLT (H33 fixed to 1), Hartley-normalised, weighted rows,
  solved by reduced QR and a triangular solve (the canonical WOFT
  estimator) or by 8x8 normal equations;
- IRLS re-weighting with L1 / Huber losses, a fixed number of QR solves;
- homogeneous DLT via SVD of the 9x9 normal matrix;
- the host fits of the reference's ablations, OpenCV RANSAC and the
  similarity fit, which need ``cv2``.

Zero weights remove points exactly, which turns the reference's dynamic
point filtering into static-shape weighting.

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

    A: (B, M, n); b: (B, M, 1). One system, or a system that autograd
    records (grad mode on and ``A`` or ``b`` requiring grad: the training
    loss), takes Q explicitly: the reduced QR, which torch differentiates,
    as the JAX package's solver does. A batch under no grad (the trackers)
    takes only the R of the augmented [A | b] (``_lstsq_tsqr``)."""
    if A.shape[0] == 1 or (torch.is_grad_enabled()
                           and (A.requires_grad or b.requires_grad)):
        q, r = torch.linalg.qr(A)                      # (B,M,n), (B,n,n)
        return torch.linalg.solve_triangular(r, q.transpose(-1, -2) @ b,
                                             upper=True)
    return _lstsq_tsqr(A, b)


def _lstsq_tsqr(A, b):
    """``_lstsq_qr`` of a batch from the R of the augmented [A | b] alone,
    whose last column is Q^T b (the Householder reflectors of A's columns
    applied to b), by a two-level tall-skinny QR: the R of each block of at
    most 256 rows, then the R of the stacked blocks' Rs. The same
    least-squares solution, and on the card a fixed number of launches for
    any B (the library solver factors a tall matrix one system after
    another). Torch cannot differentiate ``mode='r'``."""
    B, M, n = A.shape
    blocks = -(-M // _TSQR_ROWS)
    ab = F.pad(torch.cat([A, b], dim=-1), (0, 0, 0, blocks * _TSQR_ROWS - M))
    r = torch.linalg.qr(ab.reshape(B * blocks, _TSQR_ROWS, n + 1),
                        mode="r")[1]
    r = torch.linalg.qr(r.reshape(B, blocks * (n + 1), n + 1), mode="r")[1]
    return torch.linalg.solve_triangular(r[:, :n, :n], r[:, :n, n:],
                                         upper=True)


def find_homography_wls_normal(points1, points2, weights=None, *,
                               mask_normalization=True, ridge=0.0):
    """Weighted least-squares homography via the 8x8 normal equations:
    the QR solver's minimiser (``sum w_i^2 r_i^2``), from ``A^T A``."""
    norm_w = weights if mask_normalization else None
    p1n, t1 = normalize_points(points1, norm_w)
    p2n, t2 = normalize_points(points2, norm_w)
    A, b = _build_nonhomogeneous_system(p1n, p2n, weights)
    AtA = A.transpose(-1, -2) @ A
    Atb = A.transpose(-1, -2) @ b
    if ridge:
        AtA = AtA + ridge * torch.eye(8, dtype=AtA.dtype, device=AtA.device)
    return _solution_to_h(torch.linalg.solve(AtA, Atb), t1, t2)


def irls_l1(residuals, eps=_EPS):
    """IRLS weights for an L1 loss."""
    return 1.0 / (residuals.abs() + eps)


def irls_huber(residuals, k=1.0, eps=_EPS):
    """IRLS weights for a Huber loss: L2 within +-k, L1 outside."""
    abs_res = residuals.abs()
    return torch.where(abs_res < k, torch.ones_like(abs_res),
                       1.0 / (abs_res + eps))


def find_homography_irls_qr(points1, points2, weights=None, *,
                            reweighting_fn=irls_l1, n_iter=5,
                            mask_normalization=True):
    """IRLS m-estimator homography: ``n_iter + 1`` weighted QR solves, each
    row re-weighted by ``sqrt(reweighting_fn(residual))`` of the previous
    solve on top of the data weights (all ones for the first). A batch
    solves through the two-level tall-skinny QR of ``_lstsq_qr``."""
    norm_w = weights if mask_normalization else None
    p1n, t1 = normalize_points(points1, norm_w)
    p2n, t2 = normalize_points(points2, norm_w)
    A, b = _build_nonhomogeneous_system(p1n, p2n, weights)
    rew = torch.ones_like(b)
    for _ in range(n_iter + 1):
        solution = _lstsq_qr(rew * A, rew * b)
        rew = torch.sqrt(reweighting_fn(A @ solution - b))
    return _solution_to_h(solution, t1, t2)


def find_homography_dlt_svd(points1, points2, weights=None, *,
                            mask_normalization=True):
    """Homogeneous DLT via SVD of the 9x9 normal matrix ``A^T diag(w) A``
    (the weights enter once, not squared)."""
    norm_w = weights if mask_normalization else None
    p1n, t1 = normalize_points(points1, norm_w)
    p2n, t2 = normalize_points(points2, norm_w)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    zeros = torch.zeros_like(x1)
    ax = torch.stack([zeros, zeros, zeros, -x1, -y1, -ones,
                      y2 * x1, y2 * y1, y2], dim=-1)
    ay = torch.stack([x1, y1, ones, zeros, zeros, zeros,
                      -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.stack([ax, ay], dim=2).reshape(x1.shape[0], -1, 9)  # (B,2N,9)
    wA = A if weights is None else (
        torch.repeat_interleave(weights, 2, dim=-1)[..., None] * A)
    _, _, vt = torch.linalg.svd(A.transpose(-1, -2) @ wA)
    h = vt[..., -1, :].reshape(-1, 3, 3)
    H = _inv_norm_transform(t2) @ (h @ t1)
    return H / (H[..., 2:3, 2:3] + _EPS)


def reproj_errors(gt_h, est_h, pts_a):
    """Forward by the ground truth, back by the estimate: the L2 distance
    between ``pts_a`` and ``est_h^-1 gt_h pts_a`` (the training loss).
    gt_h, est_h: (B, 3, 3); pts_a: (B, 2, N). Returns (B, N)."""
    fwd = gt_h @ e2p(pts_a)
    back = p2e(torch.linalg.solve_ex(est_h, fwd)[0])
    return torch.linalg.norm(back - pts_a, dim=-2)


def proj_diff_errors(gt_h, est_h, pts_a):
    """L2 distance between the points projected by the ground truth and by
    the estimate. Shapes as ``reproj_errors``."""
    return torch.linalg.norm(h_proj(gt_h, pts_a) - h_proj(est_h, pts_a),
                             dim=-2)


def proj_errors(H, pts_a, pts_b):
    """L2 distance between ``H @ pts_a`` and ``pts_b``.
    H: (B,3,3); pts_a, pts_b: (B,2,N). Returns (B, N)."""
    return torch.linalg.norm(h_proj(H, pts_a) - pts_b, dim=-2)


# ---------------------------------------------------------------------------
# host fits (OpenCV; the reference's ablation solvers)
# ---------------------------------------------------------------------------

def _cv2(what):
    """``cv2``, or an ImportError that names ``what`` needs it. The port's
    one importer of OpenCV: the host fits here, and the host I/O and
    drawing (``utils/io.py``, ``utils/vis.py``, ``eval/pot.py``, the
    pipeline's frame source, the tracker's debug overlays) call it inside
    the functions that need it, so importing the port never needs ``cv2``."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{what} needs OpenCV (cv2), which is not "
                          "installed") from e
    return cv2


def find_homography_cvransac(pts_a, pts_b, weights=None, *,
                             max_iters=10000, thr=1.4142, conf=0.995):
    """OpenCV RANSAC homography, one ``cv2.findHomography`` a batch row.

    pts_a, pts_b: (B, N, 2) numpy arrays or tensors; weights are ignored
    (RANSAC replaces them). RANSAC draws from OpenCV's global RNG
    (``cv2.setRNGSeed``). Returns (B, 3, 3) float64 numpy. Raises
    ``ImportError`` without ``cv2`` and ``RuntimeError`` where OpenCV finds
    no homography."""
    cv2 = _cv2("estimator 'cvransac'")
    a, b = _host_points(pts_a), _host_points(pts_b)
    if a.shape[1] < 4:
        raise ValueError("RANSAC needs at least 4 correspondences")
    hs = []
    for a_i, b_i in zip(a, b):
        H, _ = cv2.findHomography(a_i.reshape(-1, 1, 2), b_i.reshape(-1, 1, 2),
                                  method=cv2.RANSAC, maxIters=max_iters,
                                  ransacReprojThreshold=thr, confidence=conf)
        if H is None:
            raise RuntimeError("cv2.findHomography found no homography")
        hs.append(H / (H[2, 2] + _EPS))
    return np.stack(hs)


def find_homography_trs(pts_a, pts_b, weights=None):
    """Similarity (translation, rotation, scale) fit by
    ``cv2.estimateAffinePartial2D`` (its RANSAC: threshold 3 px, 10,000
    iterations), as a homography. Same conventions and errors as
    ``find_homography_cvransac``."""
    cv2 = _cv2("estimator 'trs'")
    a, b = _host_points(pts_a), _host_points(pts_b)
    hs = []
    for a_i, b_i in zip(a, b):
        A, _ = cv2.estimateAffinePartial2D(
            a_i.reshape(-1, 1, 2), b_i.reshape(-1, 1, 2),
            ransacReprojThreshold=3, maxIters=10000, confidence=0.999)
        if A is None:
            raise RuntimeError("cv2.estimateAffinePartial2D found no fit")
        H = np.concatenate([A, [[0.0, 0.0, 1.0]]], axis=0)
        hs.append(H / (H[2, 2] + _EPS))
    return np.stack(hs)


def _host_points(pts):
    if isinstance(pts, torch.Tensor):
        pts = pts.detach().cpu().numpy()
    return np.asarray(pts, np.float64)


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


def np_reproj_errors(gt_h, est_h, pts_a, mean=True):
    """Numpy twin of ``reproj_errors`` for one (3, 3) pair and (2, N)
    points: the mean error, or the (N,) errors with ``mean=False``."""
    fb = np_compose_h(gt_h, np.linalg.inv(est_h))
    reproj = np_h_proj(fb, pts_a)
    err = np.sqrt(np.sum(np.square(reproj - pts_a), axis=0))
    if mean:
        return float(np.mean(err))
    return err
