#!/usr/bin/env python3
"""Kernels C, D and E of a ``woft_tpu_torch`` tree, timed level by level.

Run from the repository root on a machine with an NVIDIA GPU and ``nvcc``:

    python3 tools/torch_local_times.py [--root DIR]

``DIR`` (default: this repository) is the root of a checkout whose
``woft_tpu_torch`` is imported and built; an older commit's tree unpacked
with ``git archive`` times that commit's kernels. The tool uses only calls
that every version of the port has, so the numbers of two trees compare
like for like: at the 1280x720 main-path shapes of ``chip_smoke.py``
(seeded features, 120 query blocks, D = 256, four levels, margin 16) it
times the block-local volume as four one-level ``block_local_corr`` calls
(bf16 and float32), and kernel E over one lookup as four one-level
``block_local_lookup`` calls into kernel D's bf16 output, once with the
exactness guard's flags of the smooth 720p field (the last block row's 10
blocks) and once with no block flagged; kernel D over one lookup from its
explicit operands (anchors, relative starts, fractions), and the whole
guarded lookup ``corr_lookup_local_blocked`` (the coordinate arithmetic's
small launches, D and E) on the smooth field. Times are ``chip_smoke.time_ms``
(CUDA events, launches queued behind a device-side spin). Prints the card
and one JSON line. Imports no JAX.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose woft_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_local_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(args.root))
    from woft_tpu_torch.device import resolve_device
    from woft_tpu_torch.models import corr
    from woft_tpu_torch.ops import kernels
    from woft_tpu_torch.ops.warp import avg_pool2d

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    print(f"woft_tpu_torch from {os.path.dirname(corr.__file__)}")
    dev = resolve_device("cuda")
    kernels.build()
    g = torch.Generator(device=dev).manual_seed(6)
    H1, W1, D, k = cs.H_IMG // 8, cs.W_IMG // 8, 256, 9
    f1 = torch.randn(1, H1, W1, D, device=dev, generator=g)
    f2 = torch.randn(1, H1, W1, D, device=dev, generator=g)
    meta = corr._local_layout(H1, W1, 4, 4, 16)
    nbh, nbw = meta["nbh"], meta["nbw"]
    levels = [f2]
    while len(levels) < 4:
        levels.append(avg_pool2d(levels[-1]))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        f1b = corr._to_blocked(f1.reshape(H1 * W1, D), meta).reshape(
            nbh * nbw, -1, D).to(dtype).contiguous()
        lvs = [lv[0].to(dtype).contiguous() for lv in levels]
        out[f"C {str(dtype)[6:]}, four one-level calls"] = cs.time_ms(
            lambda: [corr.block_local_corr(f1b, lv, d, nbh, nbw, dtype)
                     for d, lv in zip(meta["levels"], lvs)], iters=10)

    local = corr.build_local_corr(f1, f2, 4, 4, 16, out_dtype=torch.bfloat16)
    starts, frac = corr._local_level_coords(local, cs._local_coords(dev,
                                                                    "smooth"))
    rcs, rel, ok = corr._fine_anchor_starts(local, starts)
    data = corr.block_local_lookup_fine_multi(rcs, local.volumes, rel, frac,
                                              k, torch.bfloat16)
    out["D, explicit operands, one launch"] = cs.time_ms(
        lambda: corr.block_local_lookup_fine_multi(
            rcs, local.volumes, rel, frac, k, torch.bfloat16))
    coords = cs._local_coords(dev, "smooth")
    out["the guarded lookup corr_lookup_local_blocked, all its launches"] = \
        cs.time_ms(lambda: corr.corr_lookup_local_blocked(local, coords, 4))
    for name, flag in (("the guard's flags", (~ok).view(torch.uint8)),
                       ("no block flagged", torch.zeros_like(ok).view(
                           torch.uint8))):
        out[f"E, {name} ({int(flag.sum())} blocks), four one-level "
            f"calls"] = cs.time_ms(lambda: [corr.block_local_lookup(
                vol, starts[lvl], frac[lvl], k, flag=flag, out=data,
                channel=lvl * k * k) for lvl, vol in enumerate(local.volumes)])
    for name, ms in out.items():
        print(f"{name}: {ms:.4f} ms", flush=True)
    print(json.dumps({"ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
