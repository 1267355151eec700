"""Video / flow I/O (host side).

The port's own copy of ``woft_tpu/utils/io.py`` (ref:pytracking/utils/io.py):
a uniform ``.read()`` over video files or image directories, a video or
image-sequence writer, KITTI-style 16-bit png flow storage with 1/32 px
quantisation, frame lookup helpers, a lookahead iterator and pickle
loaders. ``cv2`` is loaded inside the functions that need it
(``geometry/homography.py:_cv2``).
"""

import io
import os
import pickle
from pathlib import Path

import numpy as np

from ..geometry.homography import _cv2


class GeneralVideoCapture:
    """cv2.VideoCapture drop-in that can also read an image directory
    (sorted jpg/png/jpeg, optional reverse) (ref:io.py:145-177)."""

    def __init__(self, path, reverse=False):
        cv2 = _cv2("GeneralVideoCapture")
        self._cv2 = cv2
        self.image_inputs = Path(path).is_dir()
        if self.image_inputs:
            self.path = str(path)
            exts = (".jpg", ".png", ".jpeg")
            self.images = sorted(
                f for f in next(os.walk(path))[2]
                if os.path.splitext(f)[1].lower() in exts)
            if reverse:
                self.images = self.images[::-1]
            self.i = 0
        else:
            self.cap = cv2.VideoCapture(str(path))

    def read(self):
        if self.image_inputs:
            if self.i >= len(self.images):
                return False, None
            self.frame_src = self.images[self.i]
            img = self._cv2.imread(os.path.join(self.path,
                                                self.images[self.i]))
            self.i += 1
            return True, img
        return self.cap.read()

    def release(self):
        if not self.image_inputs:
            self.cap.release()


def read_flow_png(path):
    """16-bit png flow: (flow (H, W, 2), valid (H, W)) (ref:io.py:109-125)."""
    cv2 = _cv2("read_flow_png")
    raw = cv2.imread(str(path), cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    raw = raw[:, :, ::-1].astype(np.float32)
    flow, valid = raw[:, :, :2], raw[:, :, 2]
    return (flow - 2 ** 15) / 32.0, valid


def write_flow_png(path, flow, valid=None):
    """Quantise flow to 1/32 px and store as 16-bit png (ref:io.py:128-142)."""
    cv2 = _cv2("write_flow_png")
    data = 32.0 * flow + 2 ** 15
    if valid is None:
        valid = np.ones((flow.shape[0], flow.shape[1], 1))
    else:
        valid = valid.reshape(flow.shape[0], flow.shape[1], 1)
    packed = np.concatenate([data, valid], axis=2).astype(np.uint16)
    cv2.imwrite(str(path), packed[:, :, ::-1])


def get_frames(path):
    """Sorted jpg frame paths in a directory (ref:io.py:17-19)."""
    import glob
    return sorted(Path(p) for p in glob.glob(f"{path}/*.jpg"))


def video_seek_frame(time_string, fps=30):
    """'HH:MM:SS' -> frame index (ref:io.py:22-27)."""
    import datetime
    import time as _time
    parsed = _time.strptime(time_string, "%H:%M:%S")
    delta = datetime.timedelta(hours=parsed.tm_hour, minutes=parsed.tm_min,
                               seconds=parsed.tm_sec)
    return fps * int(delta.total_seconds())


def video_seek_frame_name(query_frame_name, frame_paths):
    """Find a frame index by (zero-padded) name (ref:io.py:30-36)."""
    import re
    regexp = re.compile(r"0*" + str(query_frame_name))
    for i, path in enumerate(frame_paths):
        if re.match(regexp, Path(path).stem):
            return i
    raise ValueError(f"Frame {query_frame_name} not found.")


class LookaheadIter:
    """Iterator with non-consuming lookahead/peek.

    Functional twin of the reference utility (ref:io.py:55-78), re-built on
    an explicit staging buffer with on-demand fill instead of generator
    side effects: ``lookahead()`` walks (and extends) the buffer by index,
    ``__next__`` drains it before touching the source."""

    def __init__(self, iterable):
        self._source = iter(iterable)
        self._staged = []

    def __iter__(self):
        return self

    def __next__(self):
        if self._staged:
            return self._staged.pop(0)
        return next(self._source)

    def _fill_to(self, n):
        """Stage items until ``n`` are buffered; False if the source ends
        first."""
        while len(self._staged) < n:
            try:
                self._staged.append(next(self._source))
            except StopIteration:
                return False
        return True

    def lookahead(self):
        """Yield upcoming items without consuming them."""
        i = 0
        while self._fill_to(i + 1):
            yield self._staged[i]
            i += 1

    def peek(self, *default):
        """First upcoming item; ``default`` if exhausted (StopIteration
        when exhausted and no default given)."""
        if self._fill_to(1):
            return self._staged[0]
        if default:
            return default[0]
        raise StopIteration


def load_maybe_gzipped_pkl(path):
    """Load .pkl or .pklz (ref:io.py:81-93). Unpickling runs code: load
    only files this program wrote."""
    import gzip
    suffix = Path(path).suffix
    open_fn = {"pklz": gzip.open, "pkl": open}.get(suffix.lstrip("."))
    if open_fn is None:
        raise ValueError(f"Unknown pickle file suffix ({suffix}).")
    with open_fn(path, "rb") as fin:
        return pickle.load(fin)


class VideoWriter:
    """mp4 or image-sequence writer (ref:vis_utils.py:507-540)."""

    def __init__(self, path, fps=30):
        self.path = Path(path)
        self.fps = fps
        self.writer = None
        self.is_dir = self.path.suffix == ""
        self.i = 0
        if self.is_dir:
            self.path.mkdir(parents=True, exist_ok=True)

    def write(self, frame):
        cv2 = _cv2("VideoWriter")
        if self.is_dir:
            cv2.imwrite(str(self.path / f"{self.i:05d}.jpg"), frame)
        else:
            if self.writer is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                fourcc = cv2.VideoWriter_fourcc(*"mp4v")
                self.writer = cv2.VideoWriter(
                    str(self.path), fourcc, self.fps,
                    (frame.shape[1], frame.shape[0]))
            self.writer.write(frame)
        self.i += 1

    def release(self):
        if self.writer is not None:
            self.writer.release()


class CPU_Unpickler(pickle.Unpickler):
    """Unpickle blobs containing GPU torch tensors on a CPU-only host
    (ref:pytracking/utils/io.py:96-106): torch storage loads are rerouted
    through ``map_location='cpu'``."""

    def find_class(self, module, name):
        if module == "torch.storage" and name == "_load_from_bytes":
            import torch
            return lambda b: torch.load(io.BytesIO(b), map_location="cpu")
        return super().find_class(module, name)
