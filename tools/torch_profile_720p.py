#!/usr/bin/env python3
"""Where the PyTorch port's 1280x720 tracker step spends its device time.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 tools/torch_profile_720p.py [--config WOFT.py] [--frames 4]
                                        [--warmup 2] [--host]
                                        [--compare ROUNDS]
                                        [--compare-root DIR] [--windows]
                                        [--multi] [--ablations]

Tracks a synthetic homography walk with ``woft_tpu_torch/configs/<config>``
(``WOFT.py``, the canonical tracker, or ``WOFT_fast.py``, block-local
correlation in bf16; full-width RAFT-large on the weights the config
loads, the trained ``weights/wraft_tpu_v4_torch.pt``) and profiles
``--frames`` steady frames with ``torch.profiler`` (a bf16 config runs the
loop's card route, kernels G, H and I). Prints the card, the per-frame wall
time, the device busy share of the profiled window, the device time by
kernel category and the top kernels by device time. ``--host`` then runs
the same frames again under ``cProfile`` and prints the Python functions by
cumulative host time (``cProfile`` inflates every Python call, so read the
proportions, not the totals). ``--compare ROUNDS`` first times the frames
with the loop's route and with its unfused route (the route's card
predicate answering no for the second tracker) in turns in this one
process (two trackers on the same frames, the order swapped every round),
because frame times on a shared host differ more between two runs than
between the two paths. ``--compare-root DIR`` compares this tree's tracker
instead with the one of the ``woft_tpu_torch`` tree under ``DIR`` (an
older commit unpacked by ``git archive``, imported here under another
package name), in turns in this one process. ``--windows`` profiles
instead each window path that ``chip_smoke.py`` drives (``WINDOW_TRACKS``:
``WOFT_window.py`` at 1280x720 and 1920x1080, ``WOFT_window_native.py`` at
1280x720, ``bench.py``'s block-local bf16 window step at 1920x1080; the
trained window-mode weights) on that script's walk. ``--multi`` profiles
instead its multi-target paths at 1920x1080: the shared-flow tracker with
8 and 64 targets on ``WOFT_fast.py`` and the per-window batch of 8 on
``WOFT_window.py``. ``--ablations`` profiles instead its ablation tracks
(``ABLATION_TRACKS``: the downscale configs, ``WOFT_wIRLSq.py`` and
``WOFT.py`` with the dense weight head; where ``cv2`` can be imported also
``HOST_FIT_TRACKS``, the host fits). Imports no JAX.
"""

import argparse
import contextlib
import cProfile
import importlib
import importlib.util
import io
import math
import os
import pstats
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# substrings of device kernel names -> category, first match wins
CATEGORIES = (
    ("kernel G (fused GRU)", ("gru_update_kernel",)),
    ("kernel I (flow head)", ("flow_head_kernel",)),
    ("kernel H (motion tail)", ("motion_stage1_kernel",
                                "motion_stage2_kernel")),
    ("kernel B (corr lookup)", ("corr_lookup_kernel",)),
    ("kernel C (local volume)", ("local_corr_",)),
    ("kernel E (exact local lookup)", ("local_lookup_exact_kernel",)),
    ("kernels D/F (fine local lookup)", ("local_lookup_fine_kernel",)),
    ("kernel A (pre-warp)", ("warp_bilinear_kernel",)),
    ("convolution", ("fprop", "conv", "cudnn", "winograd", "fft", "cf32",
                     "nchwtonhwc", "nhwctonchw")),
    ("matmul", ("gemm", "cutlass", "cublas", "matmul")),
    ("qr / solve", ("geqrf", "orgqr", "trsm", "getrf", "potrf", "cusolver",
                    "magma")),
    ("normalisation", ("batch_norm", "norm", "softmax")),
    ("reduction", ("reduce",)),
    ("gather / index", ("index", "gather", "scatter", "sort", "scan")),
)


def category(name):
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "elementwise / other"


def other_tree(root):
    """The ``woft_tpu_torch`` package of the tree at ``root``, imported as
    ``woft_tpu_torch_other``: (its tracker module, its flow wrapper
    module). Its config files import ``woft_tpu_torch`` itself, so the
    caller loads the config with this tree's loader and points its flow
    class at the other tree's."""
    name = "woft_tpu_torch_other"
    pkg = os.path.join(os.path.abspath(root), "woft_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(f"{name}.tracker"),
            importlib.import_module(f"{name}.flow.wrapper"))


def compare(first, second, template, mask, frames, args,
            labels=("the loop's route", "its unfused route"),
            scope=contextlib.nullcontext):
    """Frame times of two trackers on the same frames, in turns; the first
    is initialised and warmed up already, the second's calls run inside
    ``scope()``."""
    with scope():
        second.init(template, mask)
        for f in frames[:args.warmup]:
            second.track(f)
    times = {labels[0]: [], labels[1]: []}
    pair = [(labels[0], first, contextlib.nullcontext),
            (labels[1], second, scope)]
    for _ in range(args.compare):
        for f in frames[args.warmup:]:
            for name, tr, ctx in pair:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with ctx():
                    tr.track(f)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t0) * 1e3)
        pair.reverse()
    for name, ms in times.items():
        ms = sorted(ms)
        print(f"compare, {name}: {len(ms)} frames, min {ms[0]:.2f} median "
              f"{ms[len(ms) // 2]:.2f} mean {sum(ms) / len(ms):.2f} max "
              f"{ms[-1]:.2f} ms")


def profile_frames(track, n, label):
    """Profile ``track(i)`` for i in 0..n-1 (each ends in a host sync) with
    ``torch.profiler``; print the wall time a frame, the device busy and
    idle shares of the profiled window, the device time by category and
    the top kernels. Returns 1 when the profiler saw no device event."""
    walls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_start = time.perf_counter()
        for i in range(n):
            t0 = time.perf_counter()
            track(i)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        window_ms = (time.perf_counter() - t_start) * 1e3
    print(f"{label}: frame wall ms:", " ".join(f"{x:.2f}" for x in walls))

    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            stat = by_name[e.name]
            stat[0] += e.time_range.elapsed_us() / 1e3
            stat[1] += 1
    busy_ms = sum(v[0] for v in by_name.values())
    if busy_ms == 0:
        print("the profiler recorded no device events")
        return 1
    launches = sum(v[1] for v in by_name.values())
    print(f"{label}: profiled window {window_ms:.2f} ms over {n} frames; "
          f"device busy {busy_ms:.2f} ms ({100 * busy_ms / window_ms:.1f}%), "
          f"idle share {100 * (1 - busy_ms / window_ms):.1f}%; "
          f"{busy_ms / n:.3f} ms and {launches / n:.1f} launches a frame")
    cats = defaultdict(lambda: [0.0, 0])
    for name, (ms, cnt) in by_name.items():
        cats[category(name)][0] += ms
        cats[category(name)][1] += cnt
    print("device ms per frame by category:")
    for cat, (ms, cnt) in sorted(cats.items(), key=lambda kv: -kv[1][0]):
        print(f"  {cat:26s} {ms / n:9.3f} ms  {100 * ms / busy_ms:5.1f}%  "
              f"{cnt / n:7.1f} launches")
    print("top kernels (device ms per frame, launches per frame):")
    for name, (ms, cnt) in sorted(by_name.items(),
                                  key=lambda kv: -kv[1][0])[:15]:
        print(f"  {ms / n:9.3f} ms {cnt / n:7.1f}  {name[:110]}")
    return 0


def profile_windows(args):
    """``--windows``: each window path of ``chip_smoke.py``
    (``WINDOW_TRACKS``) on its walk, ``--warmup`` frames, then ``--frames``
    profiled."""
    import chip_smoke

    dev = torch.device("cuda")
    for what, h, w in chip_smoke.WINDOW_TRACKS:
        template, frames, _ = chip_smoke.walk(h, w, dev,
                                              n=args.warmup + args.frames)
        mask, _ = chip_smoke.centred_mask(h, w, 1 / 3)
        runner = chip_smoke.window_runner(dev, what, template, frames, mask)
        track, shape = runner()
        for i in range(args.warmup):
            track(i)
        torch.cuda.synchronize()
        label = f"{what} at {w}x{h}, window {shape[0]}x{shape[1]}"
        if profile_frames(lambda i: track(args.warmup + i), args.frames,
                          label):
            return 1
        torch.cuda.empty_cache()
    return 0


def profile_multi(args):
    """``--multi``: the multi-target paths of ``chip_smoke.py`` at
    1920x1080 on its walk: ``SharedMultiTracker`` on ``WOFT_fast.py`` with
    8 and 64 targets, ``MultiTargetTracker`` on ``WOFT_window.py`` with 8
    windows of 256; ``--warmup`` frames, then ``--frames`` profiled."""
    import chip_smoke as cs
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.flow import RaftFlow
    from woft_tpu_torch.pipeline import MultiTargetTracker, SharedMultiTracker
    from woft_tpu_torch.tracker import WindowParams

    dev = torch.device("cuda")
    n = args.warmup + args.frames
    template, frames, _ = cs.walk(cs.MULTI_H, cs.MULTI_W, dev, n=n)
    paths = []
    for config in ("WOFT_fast.py", "WOFT_window.py"):
        conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                        config))
        flower = RaftFlow(conf.flow_config, device=dev)
        if config == "WOFT_fast.py":
            for k in (8, 64):
                paths.append((f"shared x{k}", SharedMultiTracker(
                    flower.model, flower.cfg, conf.tracker_params,
                    device=dev), cs.shared_masks(k)))
        else:
            paths.append(("window batch x8", MultiTargetTracker(
                flower.model, flower.cfg, conf.tracker_params,
                WindowParams(size=256), device=dev), cs.window_masks(8)))
    for label, tracker, masks in paths:
        tracker.init(template, masks)
        for i in range(args.warmup):
            tracker.track(frames[i])
        torch.cuda.synchronize()
        if profile_frames(lambda i: tracker.track(frames[args.warmup + i]),
                          args.frames, f"{label} at 1920x1080"):
            return 1
        del tracker
        torch.cuda.empty_cache()
    return 0


def profile_ablations(args):
    """``--ablations``: each ablation track of ``chip_smoke.py``
    (``ABLATION_TRACKS``) through ``WOFTTracker`` on its walk, ``--warmup``
    frames, then ``--frames`` profiled."""
    from dataclasses import replace

    import chip_smoke
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.tracker import WOFTTracker

    dev = torch.device("cuda")
    tracks = chip_smoke.ABLATION_TRACKS + (
        chip_smoke.HOST_FIT_TRACKS if importlib.util.find_spec("cv2")
        else ())
    for config, h, w, overrides in tracks:
        template, frames, _ = chip_smoke.walk(h, w, dev,
                                              n=args.warmup + args.frames)
        mask, _ = chip_smoke.centred_mask(h, w, 0.5)
        conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                        config))
        conf.tracker_params = replace(conf.tracker_params, **overrides)
        tracker = WOFTTracker(conf, device=dev)
        tracker.init(template, mask)
        for i in range(args.warmup):
            tracker.track(frames[i])
        torch.cuda.synchronize()
        label = f"{chip_smoke.ablation_label(config, overrides)} at {w}x{h}"
        if profile_frames(lambda i: tracker.track(frames[args.warmup + i]),
                          args.frames, label):
            return 1
        del tracker
        torch.cuda.empty_cache()
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="WOFT.py",
                    help="file under woft_tpu_torch/configs/")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--host", action="store_true",
                    help="also profile the host side with cProfile")
    ap.add_argument("--compare", type=int, default=0, metavar="ROUNDS",
                    help="time the tracker on the loop's route and on its "
                         "unfused route in turns over ROUNDS passes of the "
                         "frames")
    ap.add_argument("--windows", action="store_true",
                    help="profile the window paths of chip_smoke.py "
                         "instead of the 720p tracker")
    ap.add_argument("--multi", action="store_true",
                    help="profile the multi-target paths of chip_smoke.py "
                         "instead of the 720p tracker")
    ap.add_argument("--ablations", action="store_true",
                    help="profile the ablation tracks of chip_smoke.py "
                         "instead of the 720p tracker")
    ap.add_argument("--compare-root", metavar="DIR",
                    help="with --compare: time this tree's tracker against "
                         "the one of the tree under DIR instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_720p: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from woft_tpu_torch.config import load_config
    from woft_tpu_torch.device import resolve_device
    from woft_tpu_torch.ops.warp import warp_perspective
    from woft_tpu_torch.tracker import WOFTTracker

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    if args.windows or args.multi or args.ablations:
        resolve_device("cuda")
        if args.ablations:
            return profile_ablations(args)
        return profile_windows(args) if args.windows else profile_multi(args)
    print(f"config {args.config}")
    tracker = WOFTTracker(load_config(os.path.join(
        ROOT, "woft_tpu_torch", "configs", args.config)))
    dev = tracker.device
    g = torch.Generator().manual_seed(2)
    h, w = 720, 1280
    img = torch.zeros(1, 3, h, w)
    for scale, amp in ((64, 1.0), (16, 0.5), (4, 0.25)):
        img += amp * torch.nn.functional.interpolate(
            torch.rand(1, 3, h // scale + 1, w // scale + 1, generator=g),
            size=(h, w), mode="bilinear", align_corners=False)
    img = (img - img.min()) / (img.max() - img.min()) * 255
    template = img[0].permute(1, 2, 0).round().to(torch.uint8)
    mask = np.zeros((h, w), bool)
    mask[h // 4:3 * h // 4, w // 4:3 * w // 4] = True
    frames = []
    for t in range(1, args.warmup + args.frames + 1):
        th, s = 0.004 * t, 1 + 0.004 * t
        H = torch.tensor([[s * math.cos(th), -s * math.sin(th), 2.0 * t],
                          [s * math.sin(th), s * math.cos(th), -1.5 * t],
                          [0.0, 0.0, 1.0]], device=dev)
        f = warp_perspective(template.to(dev).float()[None], H)[0]
        frames.append(f.round().clamp(0, 255).to(torch.uint8).cpu().numpy())
    tracker.init(template.numpy(), mask)
    for f in frames[:args.warmup]:
        tracker.track(f)
    torch.cuda.synchronize()
    if args.compare and args.compare_root:
        tracker_mod, wrapper_mod = other_tree(args.compare_root)
        conf = load_config(os.path.join(ROOT, "woft_tpu_torch", "configs",
                                        args.config))
        conf.flow_config.of_class = wrapper_mod.RaftFlow
        other = tracker_mod.WOFTTracker(conf)
        compare(tracker, other, template.numpy(), mask, frames, args,
                labels=("this tree", f"the tree under {args.compare_root}"))
    elif args.compare:
        import chip_smoke
        compare(tracker, WOFTTracker(tracker.C), template.numpy(), mask,
                frames, args, scope=chip_smoke.unfused_loop)

    rc = profile_frames(lambda i: tracker.track(frames[args.warmup + i]),
                        args.frames, f"{args.config} at 1280x720")
    if rc:
        return rc
    n = args.frames
    if args.host:
        t0 = time.perf_counter()
        for f in frames[args.warmup:]:
            tracker.track(f)
        plain_ms = (time.perf_counter() - t0) * 1e3 / n
        host_prof = cProfile.Profile()
        host_prof.enable()
        for f in frames[args.warmup:]:
            tracker.track(f)
        host_prof.disable()
        out = io.StringIO()
        stats = pstats.Stats(host_prof, stream=out).sort_stats("cumulative")
        stats.print_stats(40)
        print(f"host: frame {plain_ms:.2f} ms unprofiled; under cProfile "
              f"{stats.total_tt * 1e3 / n:.2f} ms; functions by cumulative "
              f"time over {n} frames:")
        print(out.getvalue()[out.getvalue().index("ncalls"):])
    return 0


if __name__ == "__main__":
    sys.exit(main())
