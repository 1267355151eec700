"""GMA (``models/gma.py``) on the CPU: the port's forward against the
benchmark's plain reference (``benchmark/reference/gma.py``) in float32
and bf16 mode, and against WeightedRAFT where GMA's additions are zero;
kernel M's plain version against the reference's softmax . V; kernel G's
plain version at GMA's 256-channel motion input against the unfused
512-input SepConvGRU; the template's cached attention; the loader's graft
of the v4 export; the loop's route under GMA; and the benchmark cell
``woft_gma-1080p-shared8`` run on small frames.

The networks are seeded (``init_raft_params``) with GMA's additions
grafted at ``ROWS_SCALE`` and ``GAMMA`` large enough that the aggregation
moves the flow (each forward test also checks that it does), on 64 x 96
frames and 3 iterations. Tolerances:

- float32 port against the reference, 1e-4 px on the upsampled flow and
  1e-5 on the weights: the same float32 operations in another order (the
  port scales q . k after the product, the reference q before it; the
  port's convolutions against the reference's); seen 1.5e-6 and 6e-8;
- bf16 port against the float32 reference: median 0.03 px, largest 0.06
  px; the bf16 tier's rounding of every convolution and of the stored
  attention; seen 0.010 and 0.018, where the aggregation's term moves the
  flow by 0.45 px (median) and 0.86 px (largest);
- kernel M's plain version against the reference's aggregation on the
  same bf16 q, k and mf: per entry, one bf16 ulp of the result plus gamma
  times the rounding of v and of the stored probabilities (2^-8 of the
  largest |v|, twice: each a relative 2^-9 at most);
- G's plain version at 256 channels against the unfused direction: 4 bf16
  ulps of max(1, |h|), ``test_torch_update_kernels.py``'s tolerance at 128.
"""

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.entries import shared_gma
from benchmark.harness import spec
from benchmark.reference import gma as rgma
from woft_tpu_torch.config import load_config
from woft_tpu_torch.flow import wrapper
from woft_tpu_torch.flow.wrapper import load_model, raft_config
from woft_tpu_torch.models import gma, layers, update
from woft_tpu_torch.models import raft as traft

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "woft_tpu_torch" / "configs" / "WOFT_gma_fast.py"
V4 = ROOT / "weights" / "wraft_tpu_v4_torch.pt"
CELL = json.loads((ROOT / "benchmark" / "configs" / "woft_gma_shared.json")
                  .read_text())
ITERS = 3
ROWS_SCALE, GAMMA, SEED = 4.0, 4.0, 7
ULP = 2.0 ** -8
F32_FLOW_PX, F32_WEIGHT = 1e-4, 1e-5
BF16_MEDIAN_PX, BF16_MAX_PX = 0.03, 0.06


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once: two intra-op
    threads while the module runs, the previous count restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfg(precision="highest", **kw):
    return traft.RaftConfig(gma=True, iters=ITERS, precision=precision, **kw)


@pytest.fixture(scope="module")
def nets():
    """(GMA model, its RAFT-large twin): seeded RAFT-large weights and
    GMA's additions grafted over them from ``SEED``."""
    base = traft.init_raft_params(traft.RaftConfig(iters=ITERS), seed=3)
    model = traft.init_raft_params(_cfg(), seed=0)
    gma.graft(model, base.state_dict(), SEED, ROWS_SCALE, GAMMA)
    return model, base


@pytest.fixture(scope="module")
def images():
    g = torch.Generator().manual_seed(4)
    img1 = torch.nn.functional.interpolate(
        torch.rand(1, 3, 8, 12, generator=g), size=(64, 96), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1) * 255.0
    img2 = torch.roll(img1, shifts=(1, 2), dims=(1, 2))
    return img1.contiguous(), img2.contiguous()


def _reference(model, precision="fp32"):
    m = {**CELL["model"], "iters": ITERS}
    return rgma.GmaWeightedRaft(model.state_dict(), m, torch.device("cpu"),
                                precision)


def _port(model, cfg, img1, img2):
    out = traft.weighted_raft_forward(model, cfg, img1, img2)
    return out["flow_up"][0], torch.sigmoid(out["weights_up"][0, ..., 0])


def _gamma_zero(model):
    twin = traft.init_raft_params(_cfg(), seed=0)
    twin.load_state_dict(model.state_dict())
    with torch.no_grad():
        twin.update_block.aggregator.gamma.zero_()
    return twin


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_forward_matches_the_reference(nets, images, precision):
    """(1) The port's GMA forward (flow and weights) against the plain
    reference on the same weights; the same forward with the aggregation's
    term removed (gamma 0) is far outside the tolerance."""
    model, _ = nets
    img1, img2 = images
    ref = _reference(model)
    with rgma.torch.no_grad():
        want_flow, want_w = ref.flow(ref.encode(img1), img2)
    flow, w = _port(model, _cfg(precision), img1, img2)
    gap = (flow - want_flow).norm(dim=-1)
    if precision == "highest":
        assert gap.max().item() <= F32_FLOW_PX
        assert (w - want_w).abs().max().item() <= F32_WEIGHT
        tol = F32_FLOW_PX
    else:
        assert gap.median().item() <= BF16_MEDIAN_PX
        assert gap.max().item() <= BF16_MAX_PX
        tol = BF16_MAX_PX
    off, _ = _port(_gamma_zero(model), _cfg(precision), img1, img2)
    assert (off - want_flow).norm(dim=-1).max().item() > 10 * tol


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_zero_additions_are_weighted_raft(nets, images, precision):
    """(2) With gamma 0 and the SepConvGRU's new rows zero, GMA's forward
    is WeightedRAFT's on the same weights (float32: the GRU's float32 form
    against GMA's unfused route, the same sums in another order)."""
    model, base = nets
    img1, img2 = images
    zero = traft.init_raft_params(_cfg(), seed=0)
    gma.graft(zero, base.state_dict(), SEED, 0.0, 0.0)
    got, gw = _port(zero, _cfg(precision), img1, img2)
    want, ww = _port(base, traft.RaftConfig(iters=ITERS, precision=precision),
                     img1, img2)
    if precision == "bf16":
        assert torch.equal(got, want) and torch.equal(gw, ww)
    else:
        assert (got - want).abs().max().item() <= 1e-4
        assert (gw - ww).abs().max().item() <= 1e-5


@pytest.mark.parametrize("hw", [(8, 12), (7, 9)], ids=["N96", "N63"])
def test_m_plain_matches_reference_softmax_v(nets, hw):
    """(3) Kernel M's plain version (the template's stored bf16
    probabilities, its rounding points) against the reference's
    aggregation, softmax(q k^T / sqrt(128)) . to_v(mf) computed a chunk of
    rows at a time, on the same bf16 q, k and mf; N = 63 takes the strided
    rows kernel M reads where N is not a multiple of 8."""
    model, _ = nets
    H1, W1 = hw
    N = H1 * W1
    g = torch.Generator().manual_seed(8)
    inp = torch.relu(torch.randn(1, 128, H1, W1, generator=g))
    mf = torch.relu(torch.randn(1, 128, H1, W1, generator=g)).bfloat16()
    agg = model.update_block.aggregator
    with layers.precision_scope("bf16"), torch.no_grad():
        attn = gma.template_attention(model.att, inp)
        assert attn.shape == (1, N, N) and attn.stride(1) % 8 == 0
        got = gma.aggregate(agg, attn, mf, fused=True)
        qk = layers.conv(model.att.to_qk, inp, torch.bfloat16)
    assert got.shape == (1, 256, H1, W1)
    assert torch.equal(got[:, :128], mf)
    ref = _reference(model)
    ref.chunk = 5
    q, k = qk.float().chunk(2, dim=1)
    ref._att = ((128 ** -0.5 * q).reshape(128, N).T, k.reshape(128, N).T)
    want = ref.aggregate(mf.float())
    v = ref.conv1x1(mf.float(), "update_block.aggregator.to_v")
    allowed = (ULP * want.abs()
               + 2 * GAMMA * ULP * v.abs().max() + 1e-6)
    assert ((got[:, 128:].float() - want).abs() <= allowed).all()
    assert (got[:, 128:].float() - mf.float()).abs().max() > 100 * ULP


def test_gru_plain_at_gma_width(nets):
    """(4) Kernel G's plain version at GMA's 256 motion channels against
    the unfused 512-input SepConvGRU direction, both directions."""
    model, _ = nets
    gru = model.update_block.gru
    g = torch.Generator().manual_seed(9)
    H, W = 9, 14
    net = torch.tanh(torch.randn(1, 128, H, W, generator=g))
    inp = torch.relu(torch.randn(1, 128, H, W, generator=g))
    x = torch.relu(torch.randn(1, 256, H, W, generator=g)).bfloat16()
    with layers.precision_scope("bf16"), torch.no_grad():
        fused = update.LoopRoute("bf16").context(gru, inp)
        unfused = update.LoopRoute("unfused").context(gru, inp)
        for d, args in enumerate(fused):
            assert args[2].shape == (5, 256, 384)
            assert args[3].shape == (5, 128, 384)
            got = update.gru_update_plain(update.nhwc(net), update.nhwc(x),
                                          *args)
            want = update.nhwc(update.LoopRoute("unfused").sep_conv_gru(
                net, x, unfused[d:d + 1]))
            allowed = 4 * ULP * want.abs().clamp(min=1.0)
            assert ((got - want).abs() <= allowed).all()


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_cached_template_state(nets, images, precision):
    """(5) A flow from the template's cached state (features and
    attention, ``encode_template``) equals one computed from both images:
    the attention bit for bit; the flow and weights within ``tol`` (a
    forward from both images encodes their features as one batch of two,
    whose convolutions sum in another order)."""
    model, _ = nets
    img1, img2 = images
    cfg = _cfg(precision)
    feats = traft.encode_template(model, cfg, img1)
    assert len(feats) == 4 and feats[3].shape == (1, 96, 96)
    seen = []
    inner = gma.template_attention
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gma, "template_attention",
                   lambda *a: seen.append(inner(*a)) or seen[-1])
        want = traft.weighted_raft_forward(model, cfg, img1, img2)
    assert len(seen) == 1 and torch.equal(seen[0], feats[3])
    got = traft.weighted_raft_forward(model, cfg, None, img2,
                                      template_feats=feats)
    tol = 1e-5 if precision == "highest" else 1e-3
    for key in ("flow_up", "weights_up"):
        assert (got[key] - want[key]).abs().max().item() <= tol


def test_loader_grafts_the_v4_export():
    """(6) ``RaftFlow``'s loader under ``WOFT_gma_fast.py``: every tensor
    the v4 export shares with GMA copied bit for bit (the SepConvGRU's into
    its first 384 input rows), the additions drawn from the seed the same
    way twice, and equal to the benchmark's own draw of them
    (``reference/gma.py:graft_state``)."""
    conf = load_config(CONFIG)
    cfg = raft_config(conf.flow_config)
    assert cfg.gma and cfg.precision == "bf16" and cfg.corr_impl == "local"
    state = torch.load(V4, map_location="cpu", weights_only=True)
    model, _ = load_model(cfg, V4, torch.device("cpu"))
    again, _ = load_model(cfg, V4, torch.device("cpu"))
    got = model.state_dict()
    for key, value in state.items():
        if ".gru." in key and key.endswith(".weight"):
            assert torch.equal(got[key][:, :384], value)
            assert got[key].shape[1] == 512
        else:
            assert torch.equal(got[key], value), key
    for key, value in again.state_dict().items():
        assert torch.equal(got[key], value), key
    assert float(got["update_block.aggregator.gamma"]) == wrapper.GMA_GAMMA
    drawn = rgma.graft_state(state, wrapper.GMA_SEED, wrapper.GMA_ROWS_SCALE,
                             wrapper.GMA_GAMMA)
    for key, value in drawn.items():
        assert torch.equal(got[key], value), key
    a = CELL["assumed"]
    assert (a["gma_seed"], a["gru_new_rows_scale"], a["gamma"]) == (
        wrapper.GMA_SEED, wrapper.GMA_ROWS_SCALE, wrapper.GMA_GAMMA)


def _want_route(card, precision, B, grad):
    """The route a GMA forward owes: kernel M with G, H and I on the
    card's bf16 route of one pair without grad; the plain aggregation on
    every other, 'unfused' in float32 (G's float32 form reads 128)."""
    if B == 1 and precision == "bf16" and card and not grad:
        return update.LoopRoute("bf16", tail=True, encoder=True, gma="kernel")
    return update.LoopRoute("unfused", gma="plain")


@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
@pytest.mark.parametrize("B", [1, 2], ids=["B1", "B2"])
@pytest.mark.parametrize("precision", ["bf16", "highest", "default"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_loop_route_under_gma(nets, monkeypatch, card, precision, B, grad):
    """(7) ``loop_route`` under GMA over the card (its predicate patched),
    the precision, the batch and a gradient through the update block."""
    model, _ = nets
    monkeypatch.setattr(update, "_on_card", lambda *tensors: card)
    x = torch.zeros(B, 128, 4, 6)
    with layers.precision_scope(precision), torch.set_grad_enabled(grad):
        got = update.loop_route(_cfg(precision), B, model.update_block, x)
    assert got == _want_route(card, precision, B, grad)


@pytest.mark.parametrize("gma_on", [True, False], ids=["gma", "raft"])
def test_card_route_calls_m_once_an_iteration(nets, images, monkeypatch,
                                              gma_on):
    """The card's route (its predicate patched; the plain versions run)
    calls kernel M's entry once an iteration under GMA and never without
    it; the flow within bf16 noise of the plain aggregation's route."""
    model, base = nets
    img1, img2 = images
    net, cfg = ((model, _cfg("bf16")) if gma_on else
                (base, traft.RaftConfig(iters=ITERS, precision="bf16")))
    want = traft.weighted_raft_forward(net, cfg, img1, img2)["flow_up"]
    calls = []
    inner = gma.gma_aggregate
    monkeypatch.setattr(gma, "gma_aggregate",
                        lambda *a: calls.append(1) or inner(*a))
    monkeypatch.setattr(update, "_on_card", lambda *tensors: True)
    got = traft.weighted_raft_forward(net, cfg, img1, img2)["flow_up"]
    assert len(calls) == (ITERS if gma_on else 0)
    assert (got - want).abs().max().item() < 0.05


TINY = {"entry": "shared_gma", "height": 192, "width": 288,
        "octaves": [[16, 1.0], [4, 0.5]], "poses": 4, "schedule": "pingpong",
        "step": {"theta": 0.002, "scale": 0.002, "tx": 0.5, "ty": -0.4,
                 "px": 0.0, "py": 0.0},
        "target_frac": 0.5, "warmup_calls": 1, "trace_calls": 1}
RUN_SEED = 2**31 + 29        # above 32 signed bits, as the benchmark's may be


def test_entry_run_on_small_frames(monkeypatch):
    """(8) A whole run of the cell on 192 x 288 frames of its walk (the v4
    export with GMA's additions, the CPU route): the program reads
    ``correct`` under the cell's limits, the fit points' flow gap among
    them; ``check_as_run`` refuses a program whose gamma is not the one
    the configuration assumes."""
    # the suite's parity tests load JAX into this process; the guard that
    # refuses it is ``benchmark/tests``' to test
    monkeypatch.setattr(run, "guard", lambda when: None)
    r = run.run_cell("woft_gma-1080p-shared8", RUN_SEED, 0.1, 0,
                     device="cpu", traffic=TINY, log=lambda s: None)
    checks = r["checks"]
    assert set(checks) == set(spec.Cell("woft_gma-1080p-shared8").limits[
        "check"]["limits"])
    assert "flow_gap_median_px" in checks
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    conf = load_config(CONFIG)
    cfg = raft_config(conf.flow_config)
    model = traft.init_raft_params(cfg, seed=0)      # gamma 0
    tracker = SimpleNamespace(
        raft_cfg=cfg, device=torch.device("cpu"),
        tp=dataclasses.replace(conf.tracker_params, no_local_h=True))
    with pytest.raises(ValueError, match="gamma"):
        shared_gma.check_as_run(tracker, model, CELL)
    with pytest.raises(ValueError, match="gma"):
        shared_gma.check_as_run(SimpleNamespace(
            raft_cfg=dataclasses.replace(cfg, gma=False), tp=tracker.tp,
            device=tracker.device), model, CELL)


@pytest.mark.parametrize("fallback", [False, True], ids=["global", "fallback"])
def test_woft_tracker_runs_gma(fallback):
    """``WOFTTracker`` takes ``WOFT_gma_fast.py`` through ``RaftFlow``: the
    template's attention is built at ``init`` and rides with its features
    (``state.template_feats``, 4 entries); with every check failing
    (``min_inlier_frac`` above 1) the local fallback's flow, from the
    previous frame, builds that frame's attention in the forward. The
    frames' answers are finite, and the aggregation is on each route:
    ``gma.aggregate`` once an iteration of every flow."""
    from woft_tpu_torch.tracker import WOFTTracker
    from benchmark.harness import traffic as tf

    conf = load_config(CONFIG)
    conf.flow_config.iters = ITERS
    if fallback:
        conf.tracker_params = dataclasses.replace(conf.tracker_params,
                                                  min_inlier_frac=1.01)
    walk = tf.Traffic({**TINY, "height": 64, "width": 96}, 5,
                      torch.device("cpu"))
    tracker = WOFTTracker(conf, device="cpu")
    assert tracker.raft_cfg.gma and tracker.raft_cfg.iters == ITERS
    tracker.init(walk.template, walk.mask)
    assert len(tracker.state.template_feats) == 4
    calls = []
    inner = gma.aggregate
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gma, "aggregate",
                   lambda *a: calls.append(1) or inner(*a))
        for frame in walk.frames[:2]:
            H, meta = tracker.track(frame)
            assert torch.isfinite(torch.as_tensor(H)).all()
            assert bool(meta.global_H_success) != fallback
    flows = 2 * (2 if fallback else 1)
    assert len(calls) == flows * ITERS
