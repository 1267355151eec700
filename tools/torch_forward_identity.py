"""The RAFT forward of this tree against another tree's, bit for bit.

For a change meant to leave every number as it was (a change of the
forward's structure): the same seeded frames go through both trees in
turns in one process, and every output must be ``torch.equal`` and every
kernel's launch count equal, call by call. Cases: ``WOFT.py`` (dense
pyramid, kernel G's float32 form, the sparse head and the dense head),
``WOFT_fast.py`` (block-local volume and bf16; on the card its loop is
captured at the first forward and replayed after), ``WOFT_fast.py`` with
``gru_fused`` and ``tail_fused`` (kernels G and I), ``alternate_corr``, the
shared-flow chunk step at 8 targets (``pipeline.SharedMultiTracker``) and
the spatially sharded forward, dense and block-local, as one rank of a
process group (NCCL on the card, gloo on the CPU).

From the repo root, with the other tree unpacked by ``git archive`` (its
``weights/`` left out: this tree's are read) into a directory the copy
carries, e.g. ``build/parent``:

    python3 tools/torch_forward_identity.py --root build/parent \\
        [--device cpu --hw 64 96]

It prints a line a case and ends with a JSON line ``{"ok": ..., ...}``
(also written to ``--out``); the exit code is 1 when a case differs.
"""

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the walk's frames)
from woft_tpu_torch.config import load_config  # noqa: E402
from woft_tpu_torch.flow.wrapper import raft_config  # noqa: E402
from woft_tpu_torch.parallel.mesh import process_group  # noqa: E402

CONFIGS = REPO / "woft_tpu_torch" / "configs"


def tree(root):
    """The ``woft_tpu_torch`` package of this tree (``root`` None) or of
    the tree at ``root`` (imported as ``woft_tpu_torch_other``), as the
    modules the cases call."""
    name = "woft_tpu_torch"
    if root is not None:
        name = "woft_tpu_torch_other"
        pkg = os.path.join(os.path.abspath(root), "woft_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    mods = {m: importlib.import_module(f"{name}.{m}")
            for m in ("models.raft", "flow.wrapper", "ops.kernels",
                      "pipeline", "parallel")}
    return SimpleNamespace(raft=mods["models.raft"],
                           wrapper=mods["flow.wrapper"],
                           kernels=mods["ops.kernels"],
                           pipeline=mods["pipeline"],
                           parallel=mods["parallel"])


def counters(t):
    return {n: f.launches for n, f in vars(t.kernels).items()
            if callable(f) and isinstance(getattr(f, "launches", None), int)}


def launches(t, fn):
    """(fn(), {kernel: launches during fn}) after a synchronise."""
    before = counters(t)
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    after = counters(t)
    return out, {n: after[n] - v for n, v in before.items() if after[n] != v}


def cpu(x):
    """Tensors (in dicts, lists, tuples) to the CPU; numbers as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if isinstance(x, dict):
        return {k: cpu(v) for k, v in x.items() if not callable(v)}
    if isinstance(x, (list, tuple)):
        return [cpu(v) for v in x]
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    return x


def equal(a, b, path="out"):
    """The paths where ``a`` and ``b`` differ (tensors by ``torch.equal``,
    dtype included)."""
    if isinstance(a, torch.Tensor):
        same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
        return [] if same else [path]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in equal(a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in equal(x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def flow_cfg(name, **over):
    conf = load_config(CONFIGS / name)
    return dataclasses.replace(raft_config(conf.flow_config), **over), conf


def model_of(t, cfg, conf, dev):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return t.wrapper.load_model(t.raft.RaftConfig(**fields),
                                conf.flow_config.model, dev)


def forwards(t, case, frames, dev):
    """The case's forwards on one tree: a template, then a sparse-head
    forward a frame (the second with a flow_init), then a dense-head one.
    Returns [(outputs, launches)] a call."""
    model, cfg = model_of(t, case.cfg, case.conf, dev)
    raft = t.raft
    h1, w1 = frames[0].shape[1] // 8, frames[0].shape[2] // 8
    g = torch.Generator().manual_seed(3)
    cells = torch.randperm(h1 * w1, generator=g)[:512].to(dev)
    init = (2.0 * torch.randn(1, h1, w1, 2, generator=g)).to(dev)
    feats, runs = raft.encode_template(model, cfg, frames[0]), []
    for i, frame in enumerate(frames[1:]):
        def call():
            out = raft.weighted_raft_forward(
                model, cfg, None, frame, flow_init=init if i == 1 else None,
                template_feats=feats, sparse_weight_head=True)
            out["logits"] = out.pop("weight_head_at")(cells)
            return cpu(out)
        runs.append(launches(t, call))
    runs.append(launches(t, lambda: cpu(raft.weighted_raft_forward(
        model, cfg, None, frames[-1], template_feats=feats))))
    return runs


def shared(t, case, walk, dev):
    """Two chunks of the shared-flow step at 8 targets."""
    template, frames = walk
    model, cfg = model_of(t, case.cfg, case.conf, dev)
    tracker = t.pipeline.SharedMultiTracker(model, cfg,
                                            case.conf.tracker_params,
                                            device=dev)
    h, w = template.shape[:2]
    masks = np.zeros((8, h, w), bool)
    for k in range(8):
        y, x = (k // 4) * (h // 2), (k % 4) * (w // 4)
        masks[k, y + h // 8:y + 3 * h // 8, x + w // 16:x + 3 * w // 16] = 1
    tracker.init(template, masks)
    return [launches(t, lambda s=s: cpu(tracker.track_chunk(
        np.stack(frames[s:s + 4])))) for s in (0, 4)]


def sharded(t, case, frames, dev):
    """The spatially sharded forward on one rank: two calls, with the
    shard's byte and all-reduce counts."""
    model, cfg = model_of(t, case.cfg, case.conf, dev)
    mesh = t.parallel.make_mesh(sp=1, device=dev)
    fwd = t.parallel.spatial_sharded_forward(mesh, cfg)
    runs = []
    for frame in frames[1:3]:
        out, n = launches(t, lambda f=frame: cpu(fwd(model, frames[0], f)))
        s = fwd.shard
        runs.append(([out, s.volume_bytes, s.reduce_bytes, s.reduces,
                      list(s.blocks or ())], n))
    return runs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other tree (an unpacked commit)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--hw", type=int, nargs=2, default=(720, 1280),
                    help="frame size of the forwards (the shared step and "
                         "the sharded forward take 1080p on the card)")
    ap.add_argument("--out", default=None, help="JSON result file")
    args = ap.parse_args()
    dev = torch.device(args.device)
    h, w = args.hw
    big = (1080, 1920) if dev.type == "cuda" else (h, w)
    mine, other = tree(None), tree(args.root)
    if dev.type == "cuda":
        for t in (other, mine):
            t.kernels.build()
    template, frames_bgr, _ = chip_smoke.walk(h, w, dev, n=4)

    def rgb(f):
        return torch.from_numpy(np.ascontiguousarray(f[..., ::-1])).to(
            dev).to(torch.float32)[None]

    frames = [rgb(template)] + [rgb(f) for f in frames_bgr]
    walk8 = chip_smoke.walk(*big, dev, n=8)[:2]
    frames_big = [rgb(walk8[0])] + [rgb(f) for f in walk8[1][:2]]
    cases = []
    for name, cfg_file, over, run, data in (
            ("woft", "WOFT.py", {}, forwards, frames),
            ("woft_fast", "WOFT_fast.py", {}, forwards, frames),
            ("woft_fast_fused", "WOFT_fast.py",
             dict(gru_fused=True, tail_fused=True), forwards, frames),
            ("alternate", "WOFT.py", dict(alternate_corr=True), forwards,
             frames),
            ("shared8", "WOFT_fast.py", {}, shared, walk8),
            ("sharded_dense", "WOFT.py", {}, sharded, frames_big),
            ("sharded_local", "WOFT_fast.py", {}, sharded, frames_big)):
        cfg, conf = flow_cfg(cfg_file, **over)
        cases.append((name, SimpleNamespace(cfg=cfg, conf=conf), run, data))
    result = {"device": (torch.cuda.get_device_name(0)
                         if dev.type == "cuda" else "cpu"), "cases": {}}
    if dev.type == "cuda":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    ok = True
    with tempfile.TemporaryDirectory() as tmp, process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            os.path.join(tmp, "store"), 0, 1):
        for name, case, run, data in cases:
            ref = run(other, case, data, dev)
            got = run(mine, case, data, dev)
            diff = [d for i, ((a, na), (b, nb)) in enumerate(zip(ref, got))
                    for d in (equal(a, b, f"call{i}")
                              + ([] if na == nb else [f"call{i} launches"]))]
            ok &= not diff
            total = {}
            for _, n in got:
                for k, v in n.items():
                    total[k] = total.get(k, 0) + v
            result["cases"][name] = dict(equal=not diff, differs=diff,
                                         calls=len(got), launches=total)
            print(f"{name}: {'equal' if not diff else 'DIFFERS'} over "
                  f"{len(got)} calls, launches {total}"
                  + (f", differs at {diff}" if diff else ""), flush=True)
    result["ok"] = ok
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
