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
- ``woft_tpu_torch.models``   — RAFT-large and its weighted and masked
  variants, the correlation pyramid and lookups (dense, block-local,
  alternate), and the weight bridge to ``woft_tpu`` parameter trees.
- ``woft_tpu_torch.tracker``  — the WOFT tracker steps (full frame, window,
  shared-flow multi-target, batched windows) and their host shells.
- ``woft_tpu_torch.pipeline`` — multi-target trackers, the chunk loops
  that step T frames without a host sync, and ``track_video``, the
  streaming loop over one clip (exported here).
- ``woft_tpu_torch.flow``     — the ``compute_flow`` wrapper protocol
  (``RaftFlow``) and the external backend with its cost-volume weight
  head (``ExternalFlowWrapper``), and the flow cache (``FlowCache``).
- ``woft_tpu_torch.eval``     — synthetic-trajectory and POT evaluation,
  POT-style alignment metrics.
- ``woft_tpu_torch.parallel`` — scale-out on ``torch.distributed``: the
  (dp, sp) ``DeviceMesh``, the rank launcher, many streams or training
  rows over ``dp``, one frame pair's correlation over ``sp``.
- ``woft_tpu_torch.utils``    — host I/O, timing, drawing, logging, seeding,
  notifications and profiling: the program's stage spans (``span``, off
  unless a profiler records or ``recording()`` is open; ``recorded_spans``
  gives each span's device and host times) and ``trace_step`` (``cv2`` is
  loaded only inside the functions that decode, encode or draw).

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
    track_video,
)
