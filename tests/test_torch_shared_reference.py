"""The port's shared-flow multi-target tracker against the benchmark's
plain reference of the shared step (``benchmark/reference/shared.py``:
float32 PyTorch from the published description, float64 fits, nothing of
the port), on the CPU at a small size.

``SharedMultiTracker`` on the block-local volume (``corr_impl='local'``)
with RAFT-large's widths, two iterations and seeded random weights (the
flow head's and the weight head's last convolutions scaled by 10 and 30:
a random network's flow is otherwise so near a homography, and its
weights so near 0.5, that the weights hardly move a fit), three targets
in the benchmark's layout (``benchmark/entries/shared.py:
shared_masks``) on 96x128 frames of the benchmark's walk; through
``track`` a frame at a time and through ``track_chunk``. Each frame is
stepped again by the reference from the state the port reported for it
(the H it was pre-warped by, each target's H of the frame before), as the
benchmark's check does, and the reported pre-warp must follow target 0's
ladder.

Tolerances, on the largest corner gap over the targets and frames:
- float32 (``precision='highest'``): 2e-4 px. The port fits in float32
  (QR) where the reference fits in float64, and sums its lookups in
  another order; the gaps seen are about 2e-5 px, and a fault (the
  previous H handed back, or uniform weights) moves them by 3.7e-3 px and
  more;
- bf16: 0.05 px. The port rounds every convolution's operands to bf16 (8
  bits of mantissa), which moves the flow, here amplified tenfold by the
  scaled flow head; the gaps seen are about 0.019 px.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.entries.online import corner_gap_px
from benchmark.entries.shared import shared_masks
from benchmark.harness import traffic as tf
from benchmark.reference import raft as rraft
from benchmark.reference import shared as rshared
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.pipeline import SharedMultiTracker
from woft_tpu_torch.tracker import woft as tw

ROOT = Path(__file__).resolve().parents[1]
H_IMG, W_IMG, TARGETS, ITERS, FRAMES = 96, 128, 3, 2, 4
TOL_PX = {"highest": 2e-4, "bf16": 0.05}
SCALED = {"update_block.flow_head.conv2": 10.0, "weight_head.net.6": 30.0}
WALK = {"height": H_IMG, "width": W_IMG, "octaves": [[16, 1.0], [4, 0.5]],
        "poses": FRAMES, "schedule": "pingpong",
        "step": {"theta": 0.004, "scale": 0.004, "tx": 1.0, "ty": -0.75,
                 "px": 0.0, "py": 0.0},
        "target_frac": 0.5}
MODEL = {"fnet_dim": 256, "hidden_dim": 128, "context_dim": 128,
         "corr_levels": 4, "corr_radius": 4, "iters": ITERS,
         "weight_head_structure": [[128, 3]] * 3}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once: two intra-op
    threads while the module runs, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def walk():
    traffic = tf.Traffic(WALK, 7, torch.device("cpu"))
    masks, corners = shared_masks(TARGETS, H_IMG, W_IMG)
    return traffic, masks, corners


def rgb(bgr):
    return torch.from_numpy(np.ascontiguousarray(bgr[:, :, ::-1])).float()[
        None]


def tracked(walk, precision, chunked):
    """The port's answers over the walk's frames and the reference's from
    the state the port reported: [(port H (N, 3, 3), port ok, reference
    step's dict)] a frame, and whether the reported pre-warps follow
    target 0's ladder."""
    traffic, masks, _ = walk
    cfg = traft.RaftConfig(iters=ITERS, corr_impl="local",
                           precision=precision)
    model = traft.init_raft_params(cfg, seed=3)
    layers = dict(model.named_modules())
    with torch.no_grad():
        for name, factor in SCALED.items():
            layers[name].weight.mul_(factor)
            layers[name].bias.mul_(factor)
    tp = tw.TrackerParams()
    tracker = SharedMultiTracker(model, cfg, tp, device="cpu")
    tracker.init(traffic.template, masks)
    frames = traffic.frames[:FRAMES]
    if chunked:
        hs, meta = tracker.track_chunk(np.stack(frames))
    else:
        outs = [tracker.track(f) for f in frames]
        hs = np.stack([h for h, _ in outs])
        meta = {k: np.stack([m[k] for _, m in outs]) for k in outs[0][1]}
    net = rraft.WeightedRaft(model.state_dict(), MODEL, torch.device("cpu"))
    ref = rshared.SharedTracker(net, rgb(traffic.template),
                                torch.from_numpy(masks),
                                dataclasses.asdict(tp))
    prev = np.stack([np.eye(3)] * TARGETS)
    last_good, n_lost = np.eye(3, dtype=np.float32), 0
    ladder_ok, out = True, []
    for f, h, ok, lg, nl in zip(frames, hs, meta["global_H_success"],
                                meta["last_good_H2init"], meta["N_lost"]):
        want_lg = rshared.prewarp_h(last_good, n_lost,
                                    tp.no_prewarp_after_n)
        last_good, n_lost = rshared.advance(lg, n_lost, h[0], ok[0])
        ladder_ok &= np.array_equal(lg, want_lg) and nl == n_lost
        out.append((h.astype(np.float64), ok,
                    ref.step(rgb(f), torch.from_numpy(lg), prev)))
        prev = h.astype(np.float64)
    return out, ladder_ok


def worst_gap(out, corners, answers=None):
    answers = answers or [h for h, _, _ in out]
    return max(corner_gap_px(a[t], want["H"][t], corners[t])
               for a, (_, _, want) in zip(answers, out)
               for t in range(TARGETS))


@pytest.mark.parametrize("chunked", [False, True], ids=["track", "chunk"])
@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_port_matches_the_reference(walk, precision, chunked):
    out, ladder_ok = tracked(walk, precision, chunked)
    assert ladder_ok
    for _, ok, want in out:
        np.testing.assert_array_equal(ok, want["ok"])
        assert ok.all()
    assert worst_gap(out, walk[2]) < TOL_PX[precision]


@pytest.mark.parametrize("fault", ["previous H", "uniform weights"])
def test_a_faulty_step_exceeds_the_tolerance(walk, fault, monkeypatch):
    """Float32, a frame at a time: the previous frame's H handed back for
    each frame's, or the targets' points weighted alike."""
    if fault == "uniform weights":
        monkeypatch.setattr(tw, "_sparse_point_weights",
                            lambda *a: torch.ones(a[2].shape))
    out, _ = tracked(walk, "highest", chunked=False)
    answers = [h for h, _, _ in out]
    if fault == "previous H":
        answers = [np.stack([np.eye(3)] * TARGETS)] + answers[:-1]
    assert worst_gap(out, walk[2], answers) > TOL_PX["highest"]


def test_every_target_stays_in_the_frame_along_the_walk():
    """The cell's traffic (``shared8-1080p``): every corner of every target
    at least 16 px inside the frame at every pose; target 0 drives the
    pre-warp, so its leaving the frame would fail the others. The walk's
    20th pose would put a corner outside."""
    spec = json.loads((ROOT / "benchmark" / "traffic"
                       / "shared8-1080p.json").read_text())
    h, w = spec["height"], spec["width"]
    _, corners = shared_masks(spec["targets"], h, w)
    pts = np.concatenate([corners.reshape(-1, 2), np.ones((32, 1))], 1)

    def margin(t):
        q = pts @ tf.pose(t, spec["step"], h, w).T
        x, y = q[:, 0] / q[:, 2], q[:, 1] / q[:, 2]
        return min(x.min(), y.min(), w - 1 - x.max(), h - 1 - y.max())

    assert min(margin(t) for t in range(1, spec["poses"] + 1)) >= 16
    assert margin(20) < 0
