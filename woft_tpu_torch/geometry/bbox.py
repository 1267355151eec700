"""Host-side geometric utilities: bounding boxes and homography plumbing
(numpy, float64).

The port's own copy of ``woft_tpu/geometry/bbox.py``
(ref:pytracking/utils/geom_utils.py:16-434): ``Bbox`` with an inclusive
bottom-right corner, ``h_bbox2bbox``, ``project_bbox``, ``in_bounds``,
``decompose_h``, ``a2h``, ``h_interpolate``, the None-propagating
``compose_h`` and ``HCoordSystemGraph``. Nothing here is per-pixel work:
the boxes shape the crops around the device step and the evaluation's
corners.
"""

from collections import defaultdict, deque
from types import SimpleNamespace

import numpy as np

from .homography import np_compose_h, np_e2p, np_p2e


class Bbox:
    """Axis-aligned box with inclusive bottom-right corner
    (ref:geom_utils.py:16-139)."""

    def __init__(self, tl_x=None, tl_y=None, w=None, h=None):
        self.tl_x = tl_x
        self.tl_y = tl_y
        self.w = w
        self.h = h
        self.br_x = tl_x + w - 1
        self.br_y = tl_y + h - 1

    def __repr__(self):
        return (f"Bbox(tl_x={self.tl_x}, tl_y={self.tl_y}, "
                f"w={self.w}, h={self.h})")

    @classmethod
    def from_xyxy(cls, xyxy):
        tl_x, tl_y, br_x, br_y = xyxy
        return cls(tl_x, tl_y, br_x - tl_x + 1, br_y - tl_y + 1)

    @classmethod
    def from_xywh(cls, xywh):
        return cls(*xywh)

    @classmethod
    def from_mask(cls, binary_image):
        if not np.any(binary_image):
            return cls.from_xyxy((0, 0, 0, 0))
        rows = np.any(binary_image, axis=1)
        cols = np.any(binary_image, axis=0)
        rmin, rmax = np.where(rows)[0][[0, -1]]
        cmin, cmax = np.where(cols)[0][[0, -1]]
        return cls.from_xyxy((cmin, rmin, cmax, rmax))

    @classmethod
    def from_points(cls, pts):
        """pts: (2, N) x, y points."""
        return cls.from_xyxy([np.amin(pts[0]), np.amin(pts[1]),
                              np.amax(pts[0]), np.amax(pts[1])])

    def as_xyxy(self):
        return [self.tl_x, self.tl_y, self.br_x, self.br_y]

    def as_xywh(self):
        return [self.tl_x, self.tl_y, self.w, self.h]

    def as_points(self):
        return [[self.tl_x, self.tl_y], [self.br_x, self.tl_y],
                [self.br_x, self.br_y], [self.tl_x, self.br_y]]

    def get_center(self):
        return [self.tl_x + self.w // 2, self.tl_y + self.h // 2]

    def rounded_to_int(self):
        return Bbox.from_xyxy(tuple(int(np.round(v)) for v in (
            self.tl_x, self.tl_y, self.br_x, self.br_y)))

    def with_margins(self, margin_fraction):
        return Bbox.from_xyxy(
            (self.tl_x - int(margin_fraction * self.w),
             self.tl_y - int(margin_fraction * self.h),
             self.br_x + int(margin_fraction * self.w),
             self.br_y + int(margin_fraction * self.h)))

    def with_margins_min_size(self, min_w, min_h=None):
        """Grow symmetrically until at least (min_w, min_h)
        (ref:geom_utils.py:106-119)."""
        if min_h is None:
            min_h = min_w
        missing_w = max(min_w - self.w, 0) / 2
        missing_h = max(min_h - self.h, 0) / 2
        missing = max(missing_w / self.w, missing_h / self.h)
        return self.with_margins(missing) if missing > 0 else self

    def with_aspect(self, aspect):
        """Grow symmetrically (never shrink) to the given w/h aspect, so the
        box -> window resample stays isotropic."""
        if self.w < aspect * self.h:          # too tall -> widen
            grow = aspect * self.h - self.w
            return Bbox.from_xyxy((self.tl_x - grow / 2, self.tl_y,
                                   self.br_x + grow / 2, self.br_y))
        grow = self.w / aspect - self.h       # too wide -> heighten
        return Bbox.from_xyxy((self.tl_x, self.tl_y - grow / 2,
                               self.br_x, self.br_y + grow / 2))

    def intersection(self, other):
        return Bbox.from_xyxy([max(self.tl_x, other.tl_x),
                               max(self.tl_y, other.tl_y),
                               min(self.br_x, other.br_x),
                               min(self.br_y, other.br_y)])

    def crop_image(self, img):
        r = self.rounded_to_int()
        return img[r.tl_y:r.br_y, r.tl_x:r.br_x, ...]


def h_bbox2bbox(src, dst):
    """Homography mapping one bbox onto another (ref:geom_utils.py:142-166)."""
    h_unshift = np.eye(3)
    h_unshift[0, 2] = -src.tl_x
    h_unshift[1, 2] = -src.tl_y
    h_scale = np.diag((dst.w / float(src.w), dst.h / float(src.h), 1.0))
    h_shift = np.eye(3)
    h_shift[0, 2] = dst.tl_x
    h_shift[1, 2] = dst.tl_y
    H = h_shift @ h_scale @ h_unshift
    return H / H[2, 2]


def project_bbox(bbox, H):
    """Project a bbox's corners and rebox (ref:geom_utils.py:178-197)."""
    ids = ((0, 1), (2, 1), (2, 3), (0, 3))
    xyxy = bbox.as_xyxy()
    x = np.array([[xyxy[xi], xyxy[yi]] for xi, yi in ids]).T
    proj = np_p2e(H @ np_e2p(x)).T
    return Bbox.from_xyxy((proj[0, 0], proj[0, 1], proj[2, 0], proj[2, 1]))


def in_bounds(x, lb, ub, axis=None):
    return np.logical_and(np.all(x >= lb, axis=axis),
                          np.all(x < ub, axis=axis))


def decompose_h(h2target, target_corners):
    """Split a homography into translation + the rest
    (ref:geom_utils.py:315-343)."""
    h2source = np.linalg.inv(h2target)
    target_center = np.mean(target_corners, axis=1, keepdims=True)
    current_center = np_p2e(h2source @ np_e2p(target_center))
    translation = target_center - current_center
    h_translation = np.array([[1.0, 0.0, translation[0, 0]],
                              [0.0, 1.0, translation[1, 0]],
                              [0.0, 0.0, 1.0]])
    return SimpleNamespace(
        translation2target=h_translation,
        no_translation2target=h2target @ np.linalg.inv(h_translation))


def a2h(A):
    """Lift a (2, 3) affine matrix to a homography (ref:geom_utils.py:425-428)."""
    if A is None:
        return None
    if A.shape != (2, 3):
        raise ValueError(f"an affine matrix is (2, 3), got {A.shape}")
    return np.concatenate((A, [[0, 0, 1]]), axis=0)


def h_interpolate(h_a, h_b, t):
    """Matrix log/exp interpolation between homographies
    (ref:geom_utils.py:431-434)."""
    import scipy.linalg
    res = scipy.linalg.expm((1 - t) * scipy.linalg.logm(h_a)
                            + t * scipy.linalg.logm(h_b))
    if not np.allclose(np.imag(res), 0):
        raise ValueError("the interpolated homography is not real")
    return np.real(res)


def compose_h(*Hs):
    """Host-side, None-propagating composition (``np_compose_h``)."""
    return np_compose_h(*Hs)


class HCoordSystemGraph:
    """Search over named coordinate frames linked by homographies
    (ref:geom_utils.py:376-422; the graphviz plot is not kept)."""

    def __init__(self):
        self.nodes = defaultdict(dict)

    def add_mutating(self, src_name, dst_name, h_src2dst):
        self.nodes[src_name][dst_name] = np.array(h_src2dst)
        self.nodes[dst_name][src_name] = np.linalg.inv(h_src2dst)

    def add(self, src_name, dst_name, h_src2dst):
        out = self.copy()
        out.add_mutating(src_name, dst_name, h_src2dst)
        return out

    def get(self, src_name, dst_name):
        visited = {src_name}
        queue = deque([(src_name, np.eye(3))])
        while queue:
            current, h_src2cur = queue.pop()
            if current == dst_name:
                return h_src2cur
            for neighbor, h_cur2nb in self.nodes[current].items():
                if neighbor not in visited:
                    visited.add(neighbor)
                    queue.append((neighbor,
                                  np_compose_h(h_src2cur, h_cur2nb)))
        raise RuntimeError(
            f"No known transformation from {src_name} to {dst_name}.")

    def copy(self):
        out = HCoordSystemGraph()
        for src, node in self.nodes.items():
            for dst, H in node.items():
                out.nodes[src][dst] = H.copy()
        return out
