#!/usr/bin/env python3
"""The ablation tracks of ``chip_smoke.py`` on the CPU path.

Run from the repository root:

    python3 tools/torch_downscale_walks.py [--threads 8] [--only LABEL]
        [--family]

Drives each track of ``chip_smoke.py``'s ``ABLATION_TRACKS``
(``configs/WOFT_downscale_3x.py`` at 1280x720 and 1920x1080,
``WOFT_downscale_2x.py`` at 1920x1080, ``WOFT_downscale_4x.py`` at
1280x720, ``WOFT_wIRLSq.py`` and ``WOFT.py`` with the dense weight head at
1280x720, and the host fits' ``WOFT_cvransac.py`` and ``WOFT_trs.py`` at
1280x720 (``HOST_FIT_TRACKS``; they need ``cv2``); 8 frames of the walk
and 3 with ``redetection='never'``, the trained full-frame weights) on
the kernels' plain versions, prints the same lines the card's run
prints, without launches or device memory, and the dense-head track's
distance to the sparse-head one. The largest
corner errors of each track against the walk (full-resolution pixels
after the downscale compensation; on its 8 frames and on its 3 fallback
frames) are where ``chip_smoke.py``'s ``ABLATION_CORNER_BOUND_PX`` comes
from. ``--family`` drives the flow-network family's tracks instead
(``FAMILY_TRACKS``: ``WOFT_rep.py``, ``ablation_10.py``,
``WOFT_origraft.py``, ``WOFT_masked.py``, ``WOFT.py`` in float32 and with
``precision='default'``, which on the CPU means the bf16 pyramid without
TF32), the source of ``FAMILY_CORNER_BOUND_PX``. The times it prints are
the CPU's, not the card's. Imports no JAX.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--only", action="append",
                        help="a track's label (config, '<config> dense "
                             "head', '<config> precision=default'); "
                             "repeatable")
    parser.add_argument("--family", action="store_true",
                        help="the flow-network family's tracks")
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    sys.path.insert(0, ROOT)
    import chip_smoke

    dev = torch.device("cpu")
    done = {}
    tracks = (list(chip_smoke.FAMILY_TRACKS)
              if args.family else
              [t + ({},) for t in chip_smoke.ABLATION_TRACKS
               + chip_smoke.HOST_FIT_TRACKS])
    for config, h, w, overrides, flow in tracks:
        label = chip_smoke.ablation_label(config, overrides, flow)
        if args.only and label not in args.only:
            continue
        res = chip_smoke.ablation_walk(dev, config, h, w, overrides,
                                       flow=flow)
        chip_smoke.report_ablation_walk(res)
        n = len(res["frame_ms"])
        print(f"{label} at {res['frame']}: largest corner error "
              f"{max(res['errs'][:n]):.4f} px on the walk, "
              f"{max(res['errs'][n:]):.4f} px on the fallback frames",
              flush=True)
        done[label] = res
    for config, h, w, overrides in chip_smoke.ABLATION_TRACKS:
        dense = done.get(chip_smoke.ablation_label(config, overrides))
        if dense is not None and overrides.get("sparse_weights") is False:
            diff = chip_smoke.dense_vs_sparse_px(dev, dense, config, h, w)
            print(f"{dense['what']} against the sparse head: largest corner "
                  f"distance {diff:.2e} px", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
