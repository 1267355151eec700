"""WOFT on PyTorch and CUDA for NVIDIA Hopper (H100).

The PyTorch twin of ``woft_tpu``: the same modules under the same names,
written in PyTorch idiom (``nn.Module`` networks, plain tensor functions for
geometry and ops, explicit devices and ``torch.Generator``s), with the TPU
Pallas kernels of the main path replaced by hand-written CUDA kernels
(``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``;
see ``ops/kernels.py``).

- ``woft_tpu_torch.geometry`` — weighted-QR homography fit and projective
  helpers.
- ``woft_tpu_torch.ops``      — warps, sampling, padding, CUDA kernels.
- ``woft_tpu_torch.models``   — WeightedRAFT, the correlation pyramid and
  lookup, and the weight bridge to ``woft_tpu`` parameter trees.
- ``woft_tpu_torch.tracker``  — the WOFT tracker steps (full frame, window,
  shared-flow multi-target, batched windows) and their host shells.
- ``woft_tpu_torch.pipeline`` — multi-target trackers and the chunk loops
  that step T frames without a host sync (exported here).
- ``woft_tpu_torch.flow``     — the ``compute_flow`` wrapper protocol.

Public functions keep ``woft_tpu``'s layouts (NHWC images, ``(x, y)``
coordinates); inside, the networks run NCHW. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, where every kernel takes its
plain PyTorch version.
"""

__version__ = "0.1.0"

from .pipeline import (  # noqa: E402,F401
    MultiTargetTracker,
    SharedMultiTracker,
    build_full_track_chunk,
    build_multi_track_chunk,
    build_shared_multi_chunk,
)
