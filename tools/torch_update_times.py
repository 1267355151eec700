#!/usr/bin/env python3
"""Kernels G, H and I of a ``woft_tpu_torch`` tree, timed through their
wrappers.

Run from the repository root on a machine with an NVIDIA GPU and ``nvcc``:

    python3 tools/torch_update_times.py [--root DIR]

``DIR`` (default: this repository) is the root of a checkout whose
``woft_tpu_torch`` is imported and built; an older commit's tree unpacked
with ``git archive`` times that commit's kernels, so two trees run in one
call compare like for like (run parent, this tree, this tree, parent). At
``chip_smoke.py``'s 720p loop shape (90 x 160 cells, the update block's
seeded weights, ``chip_smoke.update_case``) it times kernel G along W and
along H (``kernels.fused_gru_update``), kernel H
(``kernels.motion_encoder_tail``) and kernel I (``kernels.flow_head``),
each result first checked against its plain version within
``chip_smoke.py``'s tolerances. Times are ``chip_smoke.time_ms`` (CUDA
events, launches queued behind a device-side spin); H's launches (two
since its redesign, one before) are also timed one by one on the device
with ``torch.profiler``, under the kernels' names (``kernel_ms``). Prints the card and one
JSON line. Imports no JAX.
"""

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_ms(fn, iters=20):
    """Device time that each kernel ``fn()`` launches adds, by the kernel's
    name, mean a call, from a ``torch.profiler`` trace of ``iters`` calls:
    the span from its start, or from the end of the kernels before it if
    it started under them (H's second launch starts early and waits for the
    first, by programmatic dependent launch), to its end."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace may miss the first kernels of its window: two spins
        # lead, and are not counted
        torch.cuda._sleep(1000)
        torch.cuda._sleep(1000)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, done = defaultdict(float), 0
    for start, end, name in spans:
        if "spin" not in name:
            m = re.search(r"(\w+)\(", name)    # a kernel's own name
            total[m.group(1) if m else name] += (end - max(start, done)) / 1e3
        done = max(done, end)
    return {name: ms / iters for name, ms in total.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose woft_tpu_torch is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_update_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, os.path.abspath(args.root))
    from woft_tpu_torch.device import resolve_device
    from woft_tpu_torch.models import update
    from woft_tpu_torch.ops import kernels

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0])
    print(f"woft_tpu_torch from {os.path.dirname(update.__file__)}")
    dev = resolve_device("cuda")
    kernels.build()
    case = cs.update_case(dev)
    h, x, fh = case["h"], case["x"], case["head"]
    me = update.motion_encoder_params(case["ub"].encoder)
    c1, f1, fl = (update.nhwc(case[k]) for k in ("cor1", "flo1", "flow"))
    out = {}
    for args_ in case["fused"]:
        got = kernels.fused_gru_update(h, x, *args_)
        diff = (got - update.gru_update_plain(h, x, *args_)).abs()
        allowed = cs.GRU_TOL_ULPS * cs.BF16_ULP * h.abs().clamp(min=1.0)
        if ((diff > allowed).any()
                or (diff > 0).float().mean() > cs.UPDATE_DIFF_SHARE):
            raise AssertionError(f"kernel G [{args_[-1]}] disagrees with its "
                                 f"plain version")
        out[f"G along {args_[-1].upper()}"] = cs.time_ms(
            lambda: kernels.fused_gru_update(h, x, *args_))
    got = kernels.flow_head(h, *fh)
    want = update.flow_head_plain(h, *fh)
    if (got - want).abs().max() > (cs.HEAD_TOL_ULPS * cs.BF16_ULP
                                   * want.abs().max()):
        raise AssertionError("kernel I disagrees with its plain version")
    out["I"] = cs.time_ms(lambda: kernels.flow_head(h, *fh))
    got = kernels.motion_encoder_tail(c1, f1, fl, *me).float()
    want = update.motion_encoder_tail_plain(c1, f1, fl, *me).float()
    diff = (got - want).abs()
    if ((diff > cs.BF16_ULP * (cs.TAIL_TOL_ULPS * want.abs()
                               + want.abs().max())).any()
            or (diff > 0).float().mean() > cs.UPDATE_DIFF_SHARE):
        raise AssertionError("kernel H disagrees with its plain version")
    out["H"] = cs.time_ms(lambda: kernels.motion_encoder_tail(c1, f1, fl,
                                                              *me))
    for name, ms in kernel_ms(lambda: kernels.motion_encoder_tail(
            c1, f1, fl, *me)).items():
        out[f"H launch {name}"] = ms
    for name, ms in out.items():
        print(f"{name}: {ms:.4f} ms", flush=True)
    print(json.dumps({"ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
