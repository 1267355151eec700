#!/usr/bin/env python3
"""The window tracks of ``chip_smoke.py`` on the CPU path.

Run from the repository root:

    python3 tools/torch_window_walks.py [--device cpu] [--threads 8]
    python3 tools/torch_window_walks.py --precisions --device cuda \
        --device cpu [--save FILE.npz]

Drives each window track of ``chip_smoke.py`` (``WINDOW_TRACKS``:
``configs/WOFT_window.py`` at 1280x720 and 1920x1080,
``configs/WOFT_window_native.py`` at 1280x720, and ``bench.py``'s
block-local bf16 window step at 1920x1080; 8 frames of the walk and 3
with ``redetection='never'``, the trained window-mode weights) on the
kernels' plain versions, and prints the same lines the card's run prints,
without launches or device memory. The largest corner errors of each
track against the walk (on its 8 frames and on its 3 fallback frames) are
where ``chip_smoke.py``'s ``WINDOW_CORNER_BOUND_PX`` comes from. The times it prints are the CPU's, not the card's.

``--precisions`` instead tracks the window step's first 3 walk frames
at 1920x1080 and its 3 fallback frames (``redetection='never'``) on each
``--device`` in bf16 with the block-local volume (``bench.py``'s
settings), in float32 with it and in float32 with the dense pyramid, and
prints their corner errors against the walk and, on the walk frames,
their corner distance to the float32 block-local track on the same
device: how far bf16 moves that path's result. On the CPU that distance
is where ``chip_smoke.py``'s ``WINDOW_STEP_BF16_TOL_PX`` comes from.
Imports no JAX.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", action="append",
                        help="cpu (default) or cuda; repeatable")
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--precisions", action="store_true")
    parser.add_argument("--save", metavar="FILE.npz",
                        help="with --precisions: write each track's walk "
                             "frame H there")
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    sys.path.insert(0, ROOT)
    import chip_smoke
    from woft_tpu_torch.device import resolve_device

    devices = [resolve_device(d) for d in args.device or ["cpu"]]
    if "cuda" in [d.type for d in devices]:
        from woft_tpu_torch.ops import kernels
        kernels.build()
    if args.precisions:
        return precisions(chip_smoke, devices, args.save)
    dev, = devices
    for what, h, w in chip_smoke.WINDOW_TRACKS:
        res = chip_smoke.window_walk(dev, what, h, w)
        chip_smoke.report_window_walk(res)
        n = len(res["frame_ms"])
        print(f"{what} at {res['frame']}: largest corner error "
              f"{max(res['errs'][:n]):.4f} px on the walk, "
              f"{max(res['errs'][n:]):.4f} px on the fallback frames",
              flush=True)
    return 0


def precisions(chip_smoke, devices, save=None):
    import numpy as np

    from woft_tpu_torch.models.raft import RaftConfig
    from woft_tpu_torch.tracker import TrackerParams

    h, w = 1080, 1920
    template, frames, poses = chip_smoke.walk(h, w, torch.device("cpu"),
                                              n=3)
    mask, corners = chip_smoke.centred_mask(h, w, 1 / 3)
    saved = {}
    for dev in devices:
        walk_hs = {}
        for precision, impl in (("bf16", "local"), ("highest", "local"),
                                ("highest", "dense")):
            cfg = RaftConfig(corr_impl=impl, precision=precision, iters=12)
            runner = chip_smoke.window_runner(dev, "window_step", template,
                                              frames, mask, cfg)
            label = f"on {dev.type}, {impl} {precision}"
            track, _ = runner()
            walk_hs[label] = [track(i)[0] for i in range(3)]
            errs = chip_smoke.corner_errors(walk_hs[label], poses, corners)
            print(f"window step walk frames at {w}x{h} {label}: corner "
                  f"error against the walk "
                  f"{', '.join(f'{e:.4f}' for e in errs)} px", flush=True)
            track, _ = runner(TrackerParams(redetection="never",
                                            no_prewarp_after_n=1))
            errs = chip_smoke.corner_errors(
                [track(i)[0] for i in range(3)], poses, corners)
            print(f"window step fallback frames at {w}x{h} {label}: corner "
                  f"error against the walk "
                  f"{', '.join(f'{e:.4f}' for e in errs)} px", flush=True)
        ref = walk_hs[f"on {dev.type}, local highest"]
        for label, hs in walk_hs.items():
            diff = [chip_smoke.corner_errors([a], [np.linalg.inv(b)],
                                             corners)[0]
                    for a, b in zip(hs, ref)]
            print(f"window step walk frames at {w}x{h} {label} against "
                  f"local highest on {dev.type}: "
                  f"{', '.join(f'{e:.4f}' for e in diff)} px", flush=True)
        saved.update({k: np.stack(v) for k, v in walk_hs.items()})
    if save:
        np.savez(save, **saved)
    return 0

if __name__ == "__main__":
    sys.exit(main())
