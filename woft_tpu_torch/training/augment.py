"""Photometric / spatial augmentation for flow training pairs.

Numpy copy of ``woft_tpu/training/augment.py`` (FlowAugmentor /
SparseFlowAugmentor): color jitter (symmetric or asymmetric), eraser
occlusion, random scale/stretch/flip/crop with consistent flow-value
rescaling. Host-side numpy; the resizes are OpenCV's, imported inside the
spatial transforms by ``geometry/homography.py:_cv2``. The device-side
homography synthesis lives in ``training/synth.py``.
"""

import numpy as np

from ..geometry.homography import _cv2


class FlowAugmentor:
    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=True, spatial_aug_prob=0.8, eraser_aug_prob=0.5,
                 asymmetric_color_aug_prob=0.2):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.spatial_aug_prob = spatial_aug_prob
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.eraser_aug_prob = eraser_aug_prob
        self.asymmetric_color_aug_prob = asymmetric_color_aug_prob
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1

    # -- photometric ------------------------------------------------------

    def _jitter(self, rng, img):
        gain = rng.uniform(0.6, 1.4)
        bias = rng.uniform(-40, 40)
        sat = rng.uniform(0.6, 1.4)
        gray = img.mean(axis=-1, keepdims=True)
        out = (gray + sat * (img - gray)) * gain + bias
        return np.clip(out, 0, 255)

    def color_transform(self, rng, img1, img2):
        """Symmetric or asymmetric jitter (ref:augmentor.py:21-35)."""
        if rng.random() < self.asymmetric_color_aug_prob:
            return self._jitter(rng, img1), self._jitter(rng, img2)
        both = self._jitter(rng, np.concatenate([img1, img2], axis=0))
        return both[:img1.shape[0]], both[img1.shape[0]:]

    def eraser_transform(self, rng, img1, img2, bounds=(50, 100)):
        """Occlusion noise patches in img2 (ref:augmentor.py:37-50)."""
        ht, wd = img1.shape[:2]
        if rng.random() < self.eraser_aug_prob:
            mean_color = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(rng.integers(1, 3)):
                x0 = rng.integers(0, wd)
                y0 = rng.integers(0, ht)
                dx = rng.integers(bounds[0], bounds[1])
                dy = rng.integers(bounds[0], bounds[1])
                img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
        return img1, img2

    # -- spatial ----------------------------------------------------------

    def spatial_transform(self, rng, img1, img2, flow):
        """Random scale/stretch/flip/crop with flow rescale
        (ref:augmentor.py:52-104)."""
        cv2 = _cv2("FlowAugmentor.spatial_transform")
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 8) / float(ht),
                        (self.crop_size[1] + 8) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = max(scale_x, min_scale)
        scale_y = max(scale_y, min_scale)

        if rng.random() < self.spatial_aug_prob:
            img1 = cv2.resize(img1, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            flow = cv2.resize(flow, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            flow = flow * [scale_x, scale_y]

        if self.do_flip:
            if rng.random() < self.h_flip_prob:
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if rng.random() < self.v_flip_prob:
                img1 = img1[::-1]
                img2 = img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]

        y0 = rng.integers(0, img1.shape[0] - self.crop_size[0] + 1)
        x0 = rng.integers(0, img1.shape[1] - self.crop_size[1] + 1)
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow, rng=None):
        rng = rng or np.random.default_rng()
        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        img1, img2 = self.color_transform(rng, img1, img2)
        img1, img2 = self.eraser_transform(rng, img1, img2.copy())
        img1, img2, flow = self.spatial_transform(rng, img1, img2, flow)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


def resize_sparse_flow_map(flow, valid, fx=1.0, fy=1.0):
    """Sparse-flow-preserving resize (ref:augmentor.py:161-192): valid flow
    vectors are scatter-placed (not interpolated — bilinear resize would
    bleed into the invalid holes) at their scaled integer positions."""
    ht, wd = flow.shape[:2]
    xs, ys = np.meshgrid(np.arange(wd), np.arange(ht))
    coords = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
    flow = flow.reshape(-1, 2).astype(np.float32)
    valid = valid.reshape(-1).astype(np.float32)

    coords0 = coords[valid >= 1]
    flow0 = flow[valid >= 1]

    ht1 = int(round(ht * fy))
    wd1 = int(round(wd * fx))
    coords1 = coords0 * [fx, fy]
    flow1 = flow0 * [fx, fy]

    xx = np.round(coords1[:, 0]).astype(np.int32)
    yy = np.round(coords1[:, 1]).astype(np.int32)
    keep = (xx > 0) & (xx < wd1) & (yy > 0) & (yy < ht1)

    flow_img = np.zeros([ht1, wd1, 2], np.float32)
    valid_img = np.zeros([ht1, wd1], np.int32)
    flow_img[yy[keep], xx[keep]] = flow1[keep]
    valid_img[yy[keep], xx[keep]] = 1
    return flow_img, valid_img


class SparseFlowAugmentor(FlowAugmentor):
    """Augmentor for sparse-GT datasets (KITTI/HD1K): the spatial path
    preserves flow sparsity via scatter-resize, never stretches, and crops
    with the reference's margin rules (ref:augmentor.py:122-246)."""

    def __init__(self, crop_size, min_scale=-0.2, max_scale=0.5,
                 do_flip=False, **kw):
        super().__init__(crop_size, min_scale=min_scale, max_scale=max_scale,
                         do_flip=do_flip, **kw)

    def spatial_transform_sparse(self, rng, img1, img2, flow, valid):
        cv2 = _cv2("SparseFlowAugmentor.spatial_transform_sparse")
        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 1) / float(ht),
                        (self.crop_size[1] + 1) / float(wd))
        scale = 2 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = max(scale, min_scale)   # no stretch (sparse)

        if rng.random() < self.spatial_aug_prob:
            img1 = cv2.resize(img1, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=scale_x, fy=scale_y,
                              interpolation=cv2.INTER_LINEAR)
            flow, valid = resize_sparse_flow_map(flow, valid,
                                                 fx=scale_x, fy=scale_y)

        if self.do_flip and rng.random() < self.h_flip_prob:
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            valid = valid[:, ::-1]

        # crop with the reference's asymmetric margins
        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, img1.shape[0] - self.crop_size[0] + margin_y)
        x0 = rng.integers(-margin_x,
                          img1.shape[1] - self.crop_size[1] + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - self.crop_size[0]))
        x0 = int(np.clip(x0, 0, img1.shape[1] - self.crop_size[1]))
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl], valid[sl]

    def __call__(self, img1, img2, flow, valid, rng=None):
        rng = rng or np.random.default_rng()
        img1 = img1.astype(np.float32)
        img2 = img2.astype(np.float32)
        img1, img2 = self.color_transform(rng, img1, img2)
        img1, img2 = self.eraser_transform(rng, img1, img2.copy())
        img1, img2, flow, valid = self.spatial_transform_sparse(
            rng, img1, img2, flow, valid)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow),
                np.ascontiguousarray(valid).astype(np.float32))
