"""Optical-flow file formats: .flo (Middlebury), PFM, KITTI png.

Numpy copy of ``woft_tpu/utils/flow_formats.py`` (the training data's IO
layer), so the port reads them without the JAX package. Images decode
through OpenCV, imported inside ``read_gen`` by
``geometry/homography.py:_cv2``.
"""

import re
from pathlib import Path

import numpy as np

_TAG_FLOAT = 202021.25


def read_flo(path):
    """Middlebury .flo -> (H, W, 2) float32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != _TAG_FLOAT:
            raise ValueError(f"bad .flo magic in {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path, flow):
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.array([_TAG_FLOAT], np.float32).tofile(f)
        np.array([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_pfm(path):
    """PFM image -> float32 array (flipped to top-down)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        color = header == b"PF"
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        dims = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dims:
            raise ValueError("malformed PFM header")
        w, h = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape)).copy()


def write_pfm(path, image, scale=1):
    image = np.flipud(np.asarray(image, np.float32))
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        if image.dtype.byteorder == "<" or (
                image.dtype.byteorder == "=" and np.little_endian):
            scale = -scale
        f.write(f"{scale}\n".encode())
        image.tofile(f)


def read_kitti_flow(path):
    """KITTI 16-bit png -> (flow (H, W, 2), valid (H, W))."""
    from ..utils.io import read_flow_png
    return read_flow_png(path)


def write_kitti_flow(path, flow, valid=None):
    from ..utils.io import write_flow_png
    return write_flow_png(path, flow, valid)


def read_gen(path):
    """Extension-dispatched reader (ref:frame_utils.py read_gen)."""
    ext = Path(path).suffix.lower()
    if ext in (".png", ".jpeg", ".ppm", ".jpg"):
        from ..geometry.homography import _cv2
        return _cv2("read_gen").imread(str(path))[:, :, ::-1]
    if ext in (".bin", ".raw"):
        return np.load(str(path))
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        flow = read_pfm(path)
        return flow if flow.ndim == 2 else flow[:, :, :-1]
    raise ValueError(f"unknown extension {ext}")
