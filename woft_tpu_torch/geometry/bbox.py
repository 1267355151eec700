"""Host-side bounding boxes for the search-window tracker (numpy, float64).

The port's own copy of what ``tracker/window.py`` uses from
``woft_tpu/geometry/bbox.py`` (ref:pytracking/utils/geom_utils.py:16-197):
``Bbox`` with an inclusive bottom-right corner, ``h_bbox2bbox`` and
``project_bbox``. Nothing here is per-pixel work: the boxes shape the crops
around the device step.
"""

import numpy as np

from .homography import np_e2p, np_p2e


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

    def as_xyxy(self):
        return [self.tl_x, self.tl_y, self.br_x, self.br_y]

    def as_xywh(self):
        return [self.tl_x, self.tl_y, self.w, self.h]

    def get_center(self):
        return [self.tl_x + self.w // 2, self.tl_y + self.h // 2]

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
