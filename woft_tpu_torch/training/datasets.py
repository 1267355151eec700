"""Optical-flow dataset loaders (file-based, host side).

Numpy copy of ``woft_tpu/training/datasets.py``, so the port reads the
layouts without the JAX package: FlowDataset with oversampling,
MpiSintel / FlyingChairs / FlyingThings3D / KITTI / HD1K layouts, and the
stage-based ``fetch_dataloader`` mixing recipe. These feed flow-level
training; the weight head's training uses ``training/synth.py`` (no
external data needed).
"""

import glob
import os.path as osp
from pathlib import Path

import numpy as np

from ..utils.flow_formats import read_gen, read_flo, read_kitti_flow


class FlowDataset:
    """Index-addressable (img1, img2, flow, valid) quadruples."""

    def __init__(self, aug_params=None, sparse=False):
        self.augmentor = None
        if aug_params is not None:
            if sparse:
                from .augment import SparseFlowAugmentor
                self.augmentor = SparseFlowAugmentor(**aug_params)
            else:
                from .augment import FlowAugmentor
                self.augmentor = FlowAugmentor(**aug_params)
        self.sparse = sparse
        self.flow_list = []
        self.image_list = []
        self.extra_info = []

    def __add__(self, other):
        """Dataset concatenation for the stage-mixing recipe
        (ref:datasets.py '100*sintel_clean + ... + things')."""
        out = FlowDataset()
        out.sparse = self.sparse
        out._parts = (self, other)
        out.image_list = [("@", i) for i in range(len(self))] \
            + [("@", len(self) + i) for i in range(len(other))]
        return out

    def _resolve(self, index):
        """Walk concatenations down to (leaf_dataset, leaf_index)."""
        parts = getattr(self, "_parts", None)
        if parts is None:
            return self, index
        a, b = parts
        if index < len(a):
            return a._resolve(index)
        return b._resolve(index - len(a))

    def __getitem__(self, index):
        index = index % len(self.image_list)
        if getattr(self, "_parts", None) is not None:
            leaf, li = self._resolve(index)
            return leaf[li]
        img1 = np.asarray(read_gen(self.image_list[index][0])).astype(
            np.uint8)
        img2 = np.asarray(read_gen(self.image_list[index][1])).astype(
            np.uint8)
        valid = None
        if self.sparse:
            flow, valid = read_kitti_flow(self.flow_list[index])
        else:
            flow = read_flo(self.flow_list[index]) \
                if str(self.flow_list[index]).endswith(".flo") \
                else np.asarray(read_gen(self.flow_list[index]))
        flow = np.asarray(flow, np.float32)
        if img1.ndim == 2:
            img1 = np.tile(img1[..., None], (1, 1, 3))
            img2 = np.tile(img2[..., None], (1, 1, 3))
        else:
            img1 = img1[..., :3]
            img2 = img2[..., :3]
        if self.augmentor is not None:
            if self.sparse:
                img1, img2, flow, valid = self.augmentor(img1, img2, flow,
                                                         valid)
            else:
                img1, img2, flow = self.augmentor(img1, img2, flow)
        if valid is None:
            valid = ((np.abs(flow[..., 0]) < 1000)
                     & (np.abs(flow[..., 1]) < 1000)).astype(np.float32)
        return img1, img2, flow, valid

    def __len__(self):
        return len(self.image_list)

    def __rmul__(self, v):
        """Oversampling: ``100 * dataset`` repeats the index space."""
        self.flow_list = v * self.flow_list
        self.image_list = v * self.image_list
        return self


class MpiSintel(FlowDataset):
    def __init__(self, aug_params=None, split="training", root=None,
                 dstype="clean"):
        super().__init__(aug_params)
        root = root or "datasets/Sintel"
        flow_root = osp.join(root, split, "flow")
        image_root = osp.join(root, split, dstype)
        for scene in sorted(Path(image_root).glob("*")) if osp.isdir(
                image_root) else []:
            images = sorted(glob.glob(osp.join(str(scene), "*.png")))
            for i in range(len(images) - 1):
                self.image_list.append([images[i], images[i + 1]])
                self.extra_info.append((scene.name, i))
            if split != "test":
                self.flow_list.extend(sorted(glob.glob(
                    osp.join(flow_root, scene.name, "*.flo"))))


class FlyingChairs(FlowDataset):
    def __init__(self, aug_params=None, root=None):
        super().__init__(aug_params)
        root = root or "datasets/FlyingChairs_release/data"
        images = sorted(glob.glob(osp.join(root, "*.ppm")))
        flows = sorted(glob.glob(osp.join(root, "*.flo")))
        for i, flow in enumerate(flows):
            self.image_list.append([images[2 * i], images[2 * i + 1]])
            self.flow_list.append(flow)


class FlyingThings3D(FlowDataset):
    """frames_cleanpass/finalpass TRAIN split, left camera, both temporal
    directions (ref:raft_core/datasets.py:137-160)."""

    def __init__(self, aug_params=None, root=None,
                 dstype="frames_cleanpass"):
        super().__init__(aug_params)
        root = root or "datasets/FlyingThings3D"
        for cam in ["left"]:
            for direction in ["into_future", "into_past"]:
                image_dirs = sorted(glob.glob(osp.join(root, dstype,
                                                       "TRAIN/*/*")))
                image_dirs = sorted(osp.join(f, cam) for f in image_dirs)
                flow_dirs = sorted(glob.glob(osp.join(root,
                                                      "optical_flow/TRAIN/*/*")))
                flow_dirs = sorted(osp.join(f, direction, cam)
                                   for f in flow_dirs)
                for idir, fdir in zip(image_dirs, flow_dirs):
                    images = sorted(glob.glob(osp.join(idir, "*.png")))
                    flows = sorted(glob.glob(osp.join(fdir, "*.pfm")))
                    for i in range(len(flows) - 1):
                        if direction == "into_future":
                            self.image_list.append([images[i], images[i + 1]])
                            self.flow_list.append(flows[i])
                        else:
                            self.image_list.append([images[i + 1], images[i]])
                            self.flow_list.append(flows[i + 1])


class HD1K(FlowDataset):
    """HD1K sparse-GT sequences (ref:raft_core/datasets.py:181-198)."""

    def __init__(self, aug_params=None, root=None):
        super().__init__(aug_params, sparse=True)
        root = root or "datasets/HD1k"
        seq_ix = 0
        while True:
            flows = sorted(glob.glob(osp.join(
                root, "hd1k_flow_gt", "flow_occ/%06d_*.png" % seq_ix)))
            images = sorted(glob.glob(osp.join(
                root, "hd1k_input", "image_2/%06d_*.png" % seq_ix)))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append([images[i], images[i + 1]])
            seq_ix += 1


class KITTI(FlowDataset):
    def __init__(self, aug_params=None, split="training", root=None):
        super().__init__(aug_params, sparse=True)
        root = osp.join(root or "datasets/KITTI", split)
        images1 = sorted(glob.glob(osp.join(root, "image_2/*_10.png")))
        images2 = sorted(glob.glob(osp.join(root, "image_2/*_11.png")))
        for im1, im2 in zip(images1, images2):
            self.image_list.append([im1, im2])
        if split == "training":
            self.flow_list = sorted(glob.glob(
                osp.join(root, "flow_occ/*_10.png")))


def fetch_dataloader(stage, image_size, batch_size, *, roots=None,
                     train_ds="C+T+K+S+H", rng=None):
    """Stage-based training-set recipe (ref:raft_core/datasets.py:201-234):
    'chairs' / 'things' / 'sintel' (the C+T+K+S+H oversampled mix) /
    'kitti', with the reference's per-stage augmentor scale ranges.
    Returns (dataset, batch_iterator)."""
    roots = roots or {}

    def aug(min_scale, max_scale, do_flip):
        return {"crop_size": image_size, "min_scale": min_scale,
                "max_scale": max_scale, "do_flip": do_flip}

    if stage == "chairs":
        dataset = FlyingChairs(aug(-0.1, 1.0, True),
                               root=roots.get("chairs"))
    elif stage == "things":
        clean = FlyingThings3D(aug(-0.4, 0.8, True),
                               root=roots.get("things"),
                               dstype="frames_cleanpass")
        final = FlyingThings3D(aug(-0.4, 0.8, True),
                               root=roots.get("things"),
                               dstype="frames_finalpass")
        dataset = clean + final
    elif stage == "sintel":
        things = FlyingThings3D(aug(-0.2, 0.6, True),
                                root=roots.get("things"),
                                dstype="frames_cleanpass")
        clean = MpiSintel(aug(-0.2, 0.6, True), split="training",
                          root=roots.get("sintel"), dstype="clean")
        final = MpiSintel(aug(-0.2, 0.6, True), split="training",
                          root=roots.get("sintel"), dstype="final")
        if train_ds == "C+T+K+S+H":
            kitti = KITTI(aug(-0.3, 0.5, True), root=roots.get("kitti"))
            hd1k = HD1K(aug(-0.5, 0.2, True), root=roots.get("hd1k"))
            dataset = (100 * clean + 100 * final + 200 * kitti
                       + 5 * hd1k + things)
        else:   # 'C+T+K/S'
            dataset = 100 * clean + 100 * final + things
    elif stage == "kitti":
        dataset = KITTI(aug(-0.2, 0.4, False), root=roots.get("kitti"))
    else:
        raise ValueError(f"unknown stage {stage!r}")

    return dataset, batch_iterator(dataset, batch_size, rng=rng)


def batch_iterator(dataset, batch_size, rng=None, shuffle=True):
    """Minimal host loader: yields stacked numpy batches."""
    rng = rng or np.random.default_rng()
    order = np.arange(len(dataset))
    while True:
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset[int(i)] for i in order[start:start + batch_size]]
            yield {k: np.stack(v) for k, v in zip(
                ("img1", "img2", "flow", "valid"), zip(*items))}
