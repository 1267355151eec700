"""RAFT's volume-free correlation (``alternate_corr``) on the CPU: the
port's route (``AlternateCorr``: fmap2's levels pooled once a flow, the
plain chain that is kernel K's CPU twin), its backward (``_AltLookup``)
and a training forward through it, the benchmark's plain reference of it
(``benchmark/reference/alternate.py``), one ``WOFTTracker`` step under
``configs/WOFT_alternate.py`` against the reference step, and the
benchmark entry: its check of the configuration as run, and its
comparison on small frames, which passes the program and catches a
correlation off by a TF32-sized error.

Tolerances:
- lookups, 1e-5 of the largest value: the alternate chain and the dense
  pyramid take the same float32 products, summed in another order (a
  batched product of gathered windows against one matrix product a
  level); the rounding seen is ~1e-7 of the largest value;
- gradients, 1e-5 of the largest value through the lookup alone (the
  plain chain's VJP, recomputed: the same terms); through a whole
  training forward against the dense path's, 1e-4 of each parameter's
  largest gradient (the same float32 terms in another order; ~1.5e-6
  seen, while a lookup gradient 1 % off reads 4e-3), over the parameters
  whose gradient reaches 1e-4 of the largest (the biases before an
  instance norm have none but rounding);
- the tracker step, 2e-4 px on the largest corner gap: the port fits in
  float32 (QR) where the reference fits in float64, and sums its products
  in another order; the gaps seen are ~1e-5 px, while a fault (the
  previous H handed back, or uniform weights) moves them by 1e-3 px and
  more (``test_torch_shared_reference.py``'s reading on the same walk).
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.entries import online, online_alternate
from benchmark.harness import spec
from benchmark.harness import traffic as tf
from benchmark.reference import alternate as ralternate
from benchmark.reference import raft as rraft
from benchmark.reference import tracker as rtracker
from woft_tpu_torch.config import load_config
from woft_tpu_torch.flow.wrapper import raft_config
from woft_tpu_torch.models import corr
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.tracker import WOFTTracker

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "woft_tpu_torch" / "configs" / "WOFT_alternate.py"
CELL = json.loads((ROOT / "benchmark" / "configs" / "woft_alt.json")
                  .read_text())
LOOKUP_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
STEP_TOL_PX = 2e-4
SCALED = {"update_block.flow_head.conv2": 10.0, "weight_head.net.6": 30.0}
WALK = {"height": 64, "width": 96, "octaves": [[16, 1.0], [4, 0.5]],
        "poses": 3, "schedule": "pingpong",
        "step": {"theta": 0.004, "scale": 0.004, "tx": 1.0, "ty": -0.75,
                 "px": 0.0, "py": 0.0},
        "target_frac": 0.5}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once: two intra-op
    threads while the module runs, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _features(B, H1, W1, D, seed):
    g = torch.Generator().manual_seed(seed)
    f1, f2 = (torch.randn(B, H1, W1, D, generator=g) for _ in range(2))
    grid = torch.stack(torch.meshgrid(torch.arange(float(W1)),
                                      torch.arange(float(H1)),
                                      indexing="xy"), -1)
    coords = (grid + 3 * torch.randn(B, H1, W1, 2, generator=g)).contiguous()
    return f1, f2, coords, g


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("B", [1, 2])
def test_cpu_route_matches_the_dense_pyramid(B):
    """The alternate lookup on levels pooled once, every query and the
    sparse head's rows (cells of every batch element, in no order, one
    twice), against kernel B's plain version on the all-pairs pyramid."""
    f1, f2, coords, g = _features(B, 12, 20, 32, seed=4)
    pyramid = corr.corr_pyramid(f1, f2, 4)
    want = corr.corr_lookup(pyramid, coords, 4)
    levels = corr.alternate_levels(f2, 4)
    assert [tuple(lv.shape) for lv in levels] == [
        (B, 12, 20, 32), (B, 6, 10, 32), (B, 3, 5, 32), (B, 1, 2, 32)]
    got = corr.corr_lookup_alternate_levels(f1, levels, coords, 4, chunk=50)
    assert got.shape == want.shape
    assert _rel(got, want) <= LOOKUP_REL
    cells = torch.randperm(B * 12 * 20, generator=g)[:37]
    cells = torch.cat([cells, cells[:1]])
    rows = corr.corr_lookup_alternate_levels(f1, levels, coords, 4, chunk=16,
                                             cells=cells)
    assert rows.shape == (38, 4 * 81)
    assert _rel(rows, want.reshape(-1, 4 * 81)[cells]) <= LOOKUP_REL
    # the twin's signature (fmap2 pooled inside) gives the same numbers
    twin = corr.corr_lookup_alternate(f1, f2, coords, 4, 4, chunk=50)
    assert torch.equal(twin, got)


def test_levels_are_pooled_once_a_flow(monkeypatch):
    """``AlternateCorr`` pools fmap2 in ``build_volume`` only: the loop's
    lookups and the sparse head's rows read the stored levels."""
    pools = []
    pool = corr.avg_pool2d
    monkeypatch.setattr(corr, "avg_pool2d",
                        lambda x: pools.append(1) or pool(x))
    f1, f2, coords, _ = _features(1, 16, 24, 32, seed=5)
    c = corr.make_correlation(traft.RaftConfig(alternate_corr=True), 1)
    assert isinstance(c, corr.AlternateCorr)
    c.build(f1, f2)
    assert len(pools) == 3
    for _ in range(3):
        c.lookup(coords)
    c.rows_at(coords)(torch.arange(0, 384, 7))
    assert len(pools) == 3


@pytest.mark.parametrize("indexed", [False, True], ids=["dense", "indexed"])
def test_lookup_backward_is_the_plain_chains(indexed):
    """Under grad the lookup goes through ``_AltLookup``; its gradients
    for the query features, the levels and the coordinates equal
    autograd's through the plain chain itself."""
    f1, f2, coords, g = _features(2, 10, 14, 32, seed=8)
    cells = (torch.randperm(2 * 10 * 14, generator=g)[:41] if indexed
             else None)

    def grads(route):
        leaves = [f1.clone().requires_grad_(), coords.clone()
                  .requires_grad_(), f2.clone().requires_grad_()]
        levels = corr.alternate_levels(leaves[2], 4)
        out = route(leaves[0], levels, leaves[1])
        w = torch.sin(torch.arange(out.numel(), dtype=torch.float32))
        (out * w.reshape(out.shape)).sum().backward()
        return out, [x.grad for x in leaves]

    out, got = grads(lambda a, lv, c: corr.corr_lookup_alternate_levels(
        a, lv, c, 4, chunk=64, cells=cells))
    assert type(out.grad_fn).__name__ == "_AltLookupBackward"
    _, want = grads(lambda a, lv, c: corr._alt_lookup_plain(
        a, lv, c, 4, 64, cells))
    for name, a, b in zip(("fmap1", "coords", "fmap2"), got, want):
        assert _rel(a, b) <= LOOKUP_REL, name


def test_train_grads_equal_dense():
    """A training forward's gradient at B = 1 under ``alternate_corr``
    equals the dense path's on every parameter."""
    cfg = traft.RaftConfig(iters=2, weight_head_structure=((32, 3),))
    model = traft.init_raft_params(cfg, seed=5)
    rng = np.random.default_rng(5)
    img1 = torch.from_numpy(rng.uniform(0, 255, (1, 64, 96, 3)).astype(
        np.float32))
    img2 = img1.roll((2, 3), (1, 2))

    def grads(c):
        model.zero_grad()
        out = traft.train_forward(model, c, img1, img2)
        (out["flow_up"].abs().mean() + out["weights_up"].mean()).backward()
        return [p.grad.clone() for p in model.parameters()]

    dense = grads(cfg)
    alt = grads(dataclasses.replace(cfg, alternate_corr=True))
    top = max(b.abs().max().item() for b in dense)
    held = [(name, _rel(a, b)) for (name, _), a, b in zip(
        model.named_parameters(), alt, dense) if b.abs().max() > 1e-4 * top]
    assert len(held) >= 90
    assert max(rel for _, rel in held) <= TRAIN_GRAD_REL, held


def test_reference_lookup_matches_the_dense_reference():
    """``reference/alternate.py`` against ``reference/raft.py`` on the
    same features: the lookup (windows inside, across and outside each
    level) and the weight head's logits, whose mean response it computes
    from the features."""
    m = {**CELL["model"], "iters": 2}
    model = traft.init_raft_params(traft.RaftConfig(iters=2), seed=6)
    state = model.state_dict()
    dense = rraft.WeightedRaft(state, m, torch.device("cpu"))
    alt = ralternate.AlternateWeightedRaft(state, m, torch.device("cpu"))
    g = torch.Generator().manual_seed(7)
    f1, f2 = (torch.randn(1, 256, 10, 14, generator=g) for _ in range(2))
    coords = torch.rand(140, 2, generator=g) * torch.tensor([24.0, 18.0]) - 5
    levels, feats = dense.pyramid(f1, f2), alt.pyramid(f1, f2)
    want = dense.lookup(levels, coords)
    assert _rel(alt.lookup(feats, coords), want) <= LOOKUP_REL
    assert _rel(alt.lookup(feats, coords[30:61], 30), want[30:61]) <= \
        LOOKUP_REL
    alt.chunk = 17                       # the chunked path
    assert _rel(alt.lookup(feats, coords), want) <= LOOKUP_REL
    logits = alt.weight_logits(feats, coords, chunk=64)
    torch.testing.assert_close(logits, dense.weight_logits(levels, coords),
                               rtol=0, atol=1e-4 * logits.abs().max().item())


def test_tracker_step_matches_the_reference(tmp_path):
    """One ``WOFTTracker`` step under ``WOFT_alternate.py`` on seeded
    weights (the flow head's and the weight head's last convolutions scaled
    by 10 and 30, so that the weights move the fit) against the reference
    step from the same state, two frames of the benchmark's walk."""
    conf = load_config(CONFIG)
    cfg = raft_config(conf.flow_config)
    assert cfg.alternate_corr and cfg.precision == "highest"
    model = traft.init_raft_params(cfg, seed=3)
    layers = dict(model.named_modules())
    with torch.no_grad():
        for name, factor in SCALED.items():
            layers[name].weight.mul_(factor)
            layers[name].bias.mul_(factor)
    path = tmp_path / "seeded.pt"
    torch.save(model.state_dict(), path)
    conf.flow_config.model = path
    walk = tf.Traffic(WALK, 11, torch.device("cpu"))
    tracker = WOFTTracker(conf, device="cpu")
    online_alternate.check_as_run(tracker, CELL)
    tracker.init(walk.template, walk.mask)

    def rgb(bgr):
        return torch.from_numpy(np.ascontiguousarray(bgr[:, :, ::-1])) \
            .float()[None]

    net = ralternate.AlternateWeightedRaft(model.state_dict(), CELL["model"],
                                           torch.device("cpu"))
    ref = rtracker.Tracker(net, rgb(walk.template),
                           torch.from_numpy(walk.mask), CELL["tracker"])
    prev, prev_h = walk.template, np.eye(3, dtype=np.float32)
    for frame in walk.frames[:2]:
        H, meta = tracker.track(frame)
        lg = np.asarray(meta.last_good_H2init, np.float32)
        want = ref.step(rgb(frame), torch.from_numpy(lg), rgb(prev),
                        torch.from_numpy(prev_h))
        assert bool(meta.global_H_success) == want["ok"]
        assert online.corner_gap_px(H, want["H"], walk.corners) <= \
            STEP_TOL_PX
        prev, prev_h = frame, np.asarray(H, np.float32)


def test_entry_checks_alternate_corr_as_run():
    """The entry's check takes ``alternate_corr`` from the configuration:
    it refuses a tracker that differs, and ``online.py``'s check refuses
    the alternate tracker."""
    conf = load_config(CONFIG)
    alt = SimpleNamespace(raft_cfg=raft_config(conf.flow_config),
                          tp=conf.tracker_params, device=torch.device("cpu"))
    dense = SimpleNamespace(
        raft_cfg=dataclasses.replace(alt.raft_cfg, alternate_corr=False),
        tp=alt.tp, device=alt.device)
    online_alternate.check_as_run(alt, CELL)
    with pytest.raises(ValueError, match="alternate_corr"):
        online_alternate.check_as_run(dense, CELL)
    with pytest.raises(ValueError, match="alternate_corr"):
        online.check_as_run(alt, {**CELL, "flow": {
            k: v for k, v in CELL["flow"].items() if k != "alternate_corr"}})
    with pytest.raises(ValueError, match="radius"):
        online_alternate.check_as_run(alt, {**CELL, "model": {
            **CELL["model"], "corr_radius": 3}})


TINY = {"entry": "online_alternate", "height": 64, "width": 96,
        "octaves": [[16, 1.0], [4, 0.5]], "poses": 4, "schedule": "pingpong",
        "step": {"theta": 0.002, "scale": 0.002, "tx": 0.5, "ty": -0.4,
                 "px": 0.0, "py": 0.0},
        "target_frac": 0.5, "warmup_calls": 1, "trace_calls": 2}
SEED = 2**31 + 11          # above 32 signed bits, as the benchmark's seeds may be


def _tiny_run():
    return run.run_cell("woft_alt-2160p-online", SEED, 0.5, 0,
                        device="cpu", traffic=TINY, log=lambda s: None)


@pytest.mark.parametrize("fault", [None, "tf32 lookup"])
def test_entry_run_on_small_frames(fault, monkeypatch):
    """A whole run of the cell on 64x96 frames of its walk (the trained
    weights, the CPU route): the program reads ``correct``, with its fit's
    points within the limits of the flow and the refit; with every lookup
    rounded to TF32's 10 mantissa bits, an error of the size the card's
    TF32 makes, the refit of its points is caught."""
    from benchmark.reference import precision

    # the suite's parity tests load JAX into this process; the guard that
    # refuses it is ``benchmark/tests``' to test
    monkeypatch.setattr(run, "guard", lambda when: None)
    if fault:
        plain = corr._alt_lookup_plain
        monkeypatch.setattr(corr, "_alt_lookup_plain",
                            lambda *a: precision.round_tf32(plain(*a)))
    r = _tiny_run()
    checks = r["checks"]
    assert set(checks) == set(spec.Cell("woft_alt-2160p-online").limits[
        "check"]["limits"])
    assert {"flow_gap_median_px", "refit_gap_median_px"} <= set(checks)
    if fault is None:
        assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    else:
        assert not r["correct"]
        assert checks["refit_gap_median_px"]["value"] > \
            checks["refit_gap_median_px"]["limit"]
