"""The port's fused refinement loop (``woft_tpu_torch/models/update.py``:
kernels G, H, I) against the JAX package's Pallas kernels on the CPU.

The same numpy arrays go into both packages; the weights travel through
``params_from_jax_numpy``. The JAX side runs ``ops/pallas/gru.py`` and
``ops/pallas/update_tail.py`` in interpret mode, as its own tests do; the
port runs the kernels' plain versions (CPU tensors).

Criterion, as in ``tests/test_gru_kernel.py``: the JAX package's float32
path is the oracle, ``e_xla`` the mean distance of its own unfused bf16 path
from it. The port's plain version must be a bf16 path of the same quality,
``e_port < 1.25 * e_xla + 1e-5``, and lie closer to the Pallas kernel than
either lies to the oracle, ``mean|port - pallas| < 0.5 * e_xla + 1e-5``: both
round at the same points and differ only in the order of their float32
sums. Observed distances are stated at each test. One of them needs a word:
XLA on the CPU keeps excess precision across elementwise bf16 roundings
(its default ``xla_allow_excess_precision``), so the interpreted GRU kernel
skips the roundings of ``1 - z``, ``z * q`` and ``tanh`` that its source
states and the port makes, and about half of its float32 outputs differ
from the port's by 1e-4 to 1e-3; with that option off, 3 % differ, by 5e-7
in the mean.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.models import layers as jlayers
from woft_tpu.models import raft as jraft
from woft_tpu.ops.pallas.gru import sep_conv_gru_pallas
from woft_tpu.ops.pallas.update_tail import (flow_head_pallas,
                                             motion_encoder_pallas)
from woft_tpu_torch.models import layers, update
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_from_jax_numpy


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs in several worker processes at once, and torch's
    default of one intra-op thread a core makes this module's many small
    operations wait on each other's threads. Two threads while the module
    runs, the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _conv(rng, kh, kw, ci, co, scale):
    return {"weight": (scale * rng.normal(size=(kh, kw, ci, co))
                       ).astype(np.float32),
            "bias": (0.1 * rng.normal(size=(co,))).astype(np.float32)}


def _as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _load(module, tree):
    module.load_state_dict(params_from_jax_numpy(tree), strict=True)
    return module.eval()


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(
        0, 3, 1, 2).to(dtype)


def _nhwc_np(t):
    return t.permute(0, 2, 3, 1).float().numpy()


class jax_bf16_mode:
    """The JAX package's module-wide bf16 mode, restored on exit."""

    def __enter__(self):
        jlayers.set_precision(jax.lax.Precision("default"), jnp.bfloat16)

    def __exit__(self, *exc):
        jlayers.set_precision(jax.lax.Precision("highest"), None)


def _check(port, pallas, xla, oracle):
    e_xla = np.abs(xla - oracle).mean()
    e_port = np.abs(port - oracle).mean()
    assert e_port < 1.25 * e_xla + 1e-5, (e_port, e_xla)
    d_mut = np.abs(port - pallas).mean()
    assert d_mut < 0.5 * e_xla + 1e-5, (d_mut, e_xla)
    # shown with ``pytest -s``: the distances the docstrings quote
    print(f"e_xla {e_xla:.3g} e_port {e_port:.3g} mean|port - pallas| "
          f"{d_mut:.3g} max {np.abs(port - pallas).max():.3g} differing "
          f"{(port != pallas).mean():.3%} scale {np.abs(oracle).max():.3g}")


# ---------------------------------------------------------------------------
# G: the SepConvGRU
# ---------------------------------------------------------------------------

def _gru_tree(seed):
    rng = np.random.default_rng(seed)
    return {name: _conv(rng, kh, kw, 384, 128, 0.3)
            for name, kh, kw in (("convz1", 1, 5), ("convr1", 1, 5),
                                 ("convq1", 1, 5), ("convz2", 5, 1),
                                 ("convr2", 5, 1), ("convq2", 5, 1))}


def _gru_three_ways(tree, h, x, inp):
    """(float32 oracle, unfused bf16, Pallas interpret) of the JAX package
    and the port's fused path on the same arrays, all (1, H, W, 128)."""
    p = _as_jax(tree)
    hj, xj, ij = jnp.asarray(h), jnp.asarray(x), jnp.asarray(inp)
    pre32 = jraft.precompute_gru_context(p, ij, 128)
    oracle = np.asarray(jraft._sep_conv_gru(p, hj, xj, pre32))
    with jax_bf16_mode():
        pre = jraft.precompute_gru_context(p, ij, 128)
        xla = np.asarray(jraft._sep_conv_gru(p, hj, xj.astype(jnp.bfloat16),
                                             pre))
        pallas = np.asarray(sep_conv_gru_pallas(p, hj, xj, pre,
                                                interpret=True))
    gru = _load(traft.SepConvGRU(128, 256), tree)
    route = update.LoopRoute("bf16")
    with layers.precision_scope("bf16"), torch.no_grad():
        tpre = route.context(gru, _nchw(inp))
        port = route.sep_conv_gru(_nchw(h), _nchw(x, torch.bfloat16), tpre)
    assert port.dtype == torch.float32
    return oracle, xla, pallas, _nhwc_np(port)


@pytest.mark.parametrize("H,W", [(16, 32), (19, 28), (2, 61), (11, 15)])
def test_gru_plain_matches_pallas(H, W):
    """Both directions through the bf16 route's
    ``LoopRoute.sep_conv_gru``. Observed:
    e_xla 4.2e-3, e_port 3.9e-3, mean|port - pallas| 7.5e-4, largest single
    difference 0.105 (a gate whose rounding fell the other way in the first
    direction, on a state near 4)."""
    rng = np.random.default_rng(1)
    h, x, inp = (rng.normal(size=(1, H, W, 128)).astype(np.float32)
                 for _ in range(3))
    oracle, xla, pallas, port = _gru_three_ways(_gru_tree(0), h, x, inp)
    assert port.shape == pallas.shape == (1, H, W, 128)
    _check(port, pallas, xla, oracle)


def test_gru_plain_border_zero_padding():
    """Impulses at opposite corners and a constant context probe the zero
    padding of both convolutions, ``r * h`` outside the image included."""
    H, W = 8, 16
    h = np.zeros((1, H, W, 128), np.float32)
    h[0, 0, 0] = 1.0
    x = np.zeros((1, H, W, 128), np.float32)
    x[0, H - 1, W - 1] = 1.0
    inp = np.ones((1, H, W, 128), np.float32)
    oracle, xla, pallas, port = _gru_three_ways(_gru_tree(2), h, x, inp)
    _check(port, pallas, xla, oracle)


# ---------------------------------------------------------------------------
# H: the motion encoder's 3x3 stack
# ---------------------------------------------------------------------------

def _me_tree(seed):
    rng = np.random.default_rng(seed)
    return {"convc1": _conv(rng, 1, 1, 324, 256, 0.2),
            "convc2": _conv(rng, 3, 3, 256, 192, 0.2),
            "convf1": _conv(rng, 7, 7, 2, 128, 0.2),
            "convf2": _conv(rng, 3, 3, 128, 64, 0.2),
            "conv": _conv(rng, 3, 3, 256, 126, 0.2)}


def _me_jax(tree, corr, flow):
    """(float32 oracle, unfused bf16, Pallas interpret) of the JAX package,
    and the first-stage activations its kernel takes, (cor1, flo1) as bf16
    torch tensors."""
    p = _as_jax(tree)
    cj, fj = jnp.asarray(corr), jnp.asarray(flow)
    oracle = np.asarray(jraft._basic_motion_encoder(p, fj, cj))
    with jax_bf16_mode():
        xla = np.asarray(jraft._basic_motion_encoder(p, fj, cj), np.float32)
        cor1 = jlayers.relu(jlayers.conv2d(p["convc1"], cj,
                                           out_dtype=jnp.bfloat16))
        flo1 = jlayers.relu(jlayers.conv2d(p["convf1"], fj, padding=3,
                                           out_dtype=jnp.bfloat16))
        pallas = np.asarray(motion_encoder_pallas(p, fj, cor1, flo1, tile=8,
                                                  interpret=True), np.float32)

    def bf16(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    return oracle, xla, pallas, bf16(cor1), bf16(flo1)


def _me_three_ways(tree, corr, flow):
    oracle, xla, pallas, cor1, flo1 = _me_jax(tree, corr, flow)
    # the kernel's function on the very same first-stage activations
    enc = _load(traft.BasicMotionEncoder(324), tree)
    port = update.motion_encoder_tail(cor1, flo1, torch.from_numpy(flow),
                                      *update.motion_encoder_params(enc))
    assert port.dtype == torch.bfloat16
    # and the module's switch, from the raw lookup and flow
    with layers.precision_scope("bf16"), torch.no_grad():
        mod = enc(_nchw(flow), _nchw(corr), fused=True)
    return oracle, xla, pallas, port.float().numpy(), _nhwc_np(mod)


@pytest.mark.parametrize("H,W", [(16, 32), (19, 40)])
def test_motion_encoder_plain_matches_pallas(H, W):
    """The kernel's function on the JAX side's own first-stage activations
    (``port``) and the module's switch from the raw lookup (``mod``).
    Observed at (16, 32), outputs up to 768: e_xla 0.278; port vs Pallas
    mean 1.3e-4, 0.08 % of the entries differ, by one bf16 ulp (at most 1.0);
    module vs Pallas mean 0.03, 9 % differ (its first-stage activations come
    from another library's convolutions)."""
    rng = np.random.default_rng(3)
    corr = rng.normal(size=(1, H, W, 324)).astype(np.float32)
    flow = (3.0 * rng.normal(size=(1, H, W, 2))).astype(np.float32)
    oracle, xla, pallas, port, mod = _me_three_ways(_me_tree(0), corr, flow)
    assert port.shape == mod.shape == pallas.shape == (1, H, W, 128)
    _check(port, pallas, xla, oracle)
    _check(mod, pallas, xla, oracle)
    # the raw flow channels pass through exactly
    want = torch.from_numpy(flow).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(port[..., 126:], want)
    np.testing.assert_array_equal(mod[..., 126:], want)


def test_motion_encoder_plain_border_zero_padding():
    """Corner impulses: the second convolution must see zeros outside the
    image, not the relu(bias) a first stage computes there."""
    H, W = 16, 32
    corr = np.zeros((1, H, W, 324), np.float32)
    corr[0, 0, 0] = 1.0
    corr[0, H - 1, W - 1] = -1.0
    flow = np.zeros((1, H, W, 2), np.float32)
    flow[0, 0, W - 1, 0] = 2.0
    oracle, xla, pallas, port, mod = _me_three_ways(_me_tree(2), corr, flow)
    _check(port, pallas, xla, oracle)
    _check(mod, pallas, xla, oracle)


@pytest.mark.parametrize("H,W", [(7, 13), (9, 17)])
def test_motion_encoder_stages_match_pallas(H, W):
    """Kernel H's two launches, by their plain versions: stage 1's
    (1, H, W, 256) map of ``cat(cor2, flo2)``, then stage 2's convolution
    of it, at shapes that cut the kernel's 8 x 16 tiles on both axes. The
    composition is ``motion_encoder_tail_plain`` bit for bit and as close
    to the Pallas kernel as the criterion above asks. Observed at (7, 13)
    and (9, 17), outputs up to 543 and 574: e_xla 0.25 and 0.26, mean|port
    - pallas| 2.2e-4 and 2.5e-4, 0.09 % and 0.05 % of the entries differ
    (at most 1 and 2)."""
    rng = np.random.default_rng(5)
    corr = rng.normal(size=(1, H, W, 324)).astype(np.float32)
    flow = (3.0 * rng.normal(size=(1, H, W, 2))).astype(np.float32)
    tree = _me_tree(4)
    oracle, xla, pallas, cor1, flo1 = _me_jax(tree, corr, flow)
    wc2, bc2, wf2, bf2, wcv, bcv = update.motion_encoder_params(
        _load(traft.BasicMotionEncoder(324), tree))
    fl = torch.from_numpy(flow)
    mid = update.motion_encoder_stage1_plain(cor1, flo1, wc2, bc2, wf2, bf2)
    assert mid.shape == (1, H, W, 256) and mid.dtype == torch.bfloat16
    assert (mid >= 0).all()
    port = update.motion_encoder_stage2_plain(mid, fl, wcv, bcv)
    assert torch.equal(port, update.motion_encoder_tail_plain(
        cor1, flo1, fl, wc2, bc2, wf2, bf2, wcv, bcv))
    port = port.float().numpy()
    assert port.shape == pallas.shape == (1, H, W, 128)
    _check(port, pallas, xla, oracle)
    np.testing.assert_array_equal(
        port[..., 126:], fl.to(torch.bfloat16).float().numpy())


# ---------------------------------------------------------------------------
# I: the flow head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H,W", [(16, 32), (19, 40), (9, 13), (10, 14),
                                 (11, 15)])
def test_flow_head_plain_matches_pallas(H, W):
    """The delta is float32 and never rounded. Observed, deltas up to 189:
    e_xla 0.12, mean|port - pallas| 6.7e-5, largest single difference
    0.0157 (float32 summation order, and the few hidden activations whose
    rounding fell the other way)."""
    rng = np.random.default_rng(4)
    tree = {"conv1": _conv(rng, 3, 3, 128, 256, 0.2),
            "conv2": _conv(rng, 3, 3, 256, 2, 0.2)}
    net = rng.normal(size=(1, H, W, 128)).astype(np.float32)
    p = _as_jax(tree)
    nj = jnp.asarray(net)
    oracle = np.asarray(jraft._flow_head(p, nj))
    with jax_bf16_mode():
        xla = np.asarray(jraft._flow_head(p, nj.astype(jnp.bfloat16)))
        pallas = np.asarray(flow_head_pallas(p, nj, tile=8, interpret=True))
    head = _load(traft.FlowHead(128, 256), tree)
    with layers.precision_scope("bf16"), torch.no_grad():
        port = head(_nchw(net), fused=True)
    assert port.dtype == torch.float32
    port = _nhwc_np(port)
    assert port.shape == pallas.shape == (1, H, W, 2)
    _check(port, pallas, xla, oracle)


# ---------------------------------------------------------------------------
# the switches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_forward():
    rng = np.random.default_rng(0)
    img1 = torch.from_numpy(
        rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32))
    img2 = torch.roll(img1, shifts=(2, 3), dims=(1, 2))
    model = traft.init_raft_params(traft.RaftConfig(), seed=3)
    return model, img1, img2


def _cfg(precision, **flags):
    return traft.RaftConfig(iters=2, corr_impl="local", local_margin=8,
                            precision=precision, **flags)


def test_flags_do_nothing_in_float32(small_forward):
    """``precision='highest'``: the fused kernels are bf16-mode kernels, so
    the flags leave the unfused path in place, bit for bit."""
    model, img1, img2 = small_forward
    got = traft.weighted_raft_forward(
        model, _cfg("highest", gru_fused=True, tail_fused=True), img1, img2)
    want = traft.weighted_raft_forward(model, _cfg("highest"), img1, img2)
    for key in ("flow", "flow_up", "weights_up"):
        assert torch.equal(got[key], want[key]), key


def test_flags_do_nothing_for_a_batch(small_forward):
    """Two frame pairs in bf16 mode: the unfused path, bit for bit."""
    model, img1, img2 = small_forward
    pair = [torch.cat([a, a.flip(1)]) for a in (img1, img2)]
    got = traft.weighted_raft_forward(
        model, _cfg("bf16", gru_fused=True, tail_fused=True), *pair)
    want = traft.weighted_raft_forward(model, _cfg("bf16"), *pair)
    for key in ("flow", "flow_up", "weights_up"):
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("flags", [dict(gru_fused=True),
                                   dict(tail_fused=True)],
                         ids=["gru", "tail"])
def test_each_flag_changes_the_bf16_path(small_forward, flags):
    """One frame pair in bf16 mode: each flag alone takes its fused path
    (the result differs from the unfused one, by rounding noise only)."""
    model, img1, img2 = small_forward
    got = traft.weighted_raft_forward(model, _cfg("bf16", **flags), img1,
                                      img2)["flow_up"]
    want = traft.weighted_raft_forward(model, _cfg("bf16"), img1,
                                       img2)["flow_up"]
    assert not torch.equal(got, want)
    assert (got - want).abs().max().item() < 0.02


def test_fused_paths_refuse_float32_mode():
    enc = traft.BasicMotionEncoder(324).eval()
    head = traft.FlowHead(128, 256).eval()
    with torch.no_grad():
        with pytest.raises(ValueError):
            head(torch.zeros(1, 128, 8, 8), fused=True)
        with pytest.raises(ValueError):
            enc(torch.zeros(1, 2, 8, 8), torch.zeros(1, 324, 8, 8),
                fused=True)
        with pytest.raises(ValueError):
            update.LoopRoute("bf16").context(traft.SepConvGRU(128, 256),
                                             torch.zeros(1, 128, 8, 8))


def test_a_cuda_tensor_never_takes_a_plain_version():
    """The dispatch is by the tensor's device alone: a CPU tensor takes the
    plain version, and the launch wrappers refuse it."""
    from woft_tpu_torch.ops import kernels

    head = traft.FlowHead(128, 256).eval()
    net = torch.zeros(1, 8, 8, 128)
    with pytest.raises(ValueError):
        kernels.flow_head(net, *update.flow_head_params(head))
    with pytest.raises(ValueError):
        kernels.fused_gru_update(net, *[None] * 7, "w")
    with pytest.raises(ValueError):
        kernels.motion_encoder_tail(torch.zeros(1, 8, 8, 256), *[None] * 8)
    assert set(kernels.SOURCES) >= {"gru", "update_tail"}
    for name in ("gru", "update_tail"):
        assert (kernels.CSRC / f"{name}.cu").exists()
        assert kernels.library_path(name).parent == kernels.BUILD_DIR


# ---------------------------------------------------------------------------
# G's float32 form: the canonical float32 route
# ---------------------------------------------------------------------------
#
# Tolerance of the float32 form against the unfused float32 path: both sum
# the same 1,280 float32 products a z|r or q entry, in another order (tap
# by tap here, the CPU library's order there), then take the same sigmoid,
# tanh and blend in float32, so they differ by the rounding of differently
# ordered float32 sums alone. With the network's own initial weights
# (``init_raft_params``) and |h| < 1 that is a few ulps of the state:
# observed at most 8.3e-7 over three seeds and five map sizes; 1e-5 is
# twelve times that, while the taps in reverse order, or h and x swapped,
# move the state by 0.7.
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def f32_gru():
    return traft.init_raft_params(traft.RaftConfig(), seed=1).update_block.gru


def _f32_case(seed, H, W):
    rng = np.random.default_rng(seed)
    h = np.tanh(rng.normal(size=(1, H, W, 128))).astype(np.float32)
    x = np.maximum(rng.normal(size=(1, H, W, 128)), 0).astype(np.float32)
    inp = np.maximum(rng.normal(size=(1, H, W, 128)), 0).astype(np.float32)
    return _nchw(h), _nchw(x), _nchw(inp)


def _f32_directions(gru, h, x, inp):
    """Each direction's unfused step and float32-form step from the same
    state, as (axis, unfused, float32 form) NCHW tensors."""
    unfused, f32 = update.LoopRoute("unfused"), update.LoopRoute("f32")
    with layers.precision_scope("highest"), torch.no_grad():
        pre = unfused.context(gru, inp)
        pre32 = f32.context(gru, inp)
        return [(pre32[d][-1], unfused.sep_conv_gru(h, x, pre[d:d + 1]),
                 f32.sep_conv_gru(h, x, pre32[d:d + 1]))
                for d in range(2)]


@pytest.mark.parametrize("H,W", [(16, 32), (19, 28), (2, 61), (11, 15),
                                 (5, 3)])
def test_gru_f32_plain_matches_unfused(f32_gru, H, W):
    """Both axes (the 1x5 and the 5x1 direction), on map sizes that cut
    nothing evenly, from the same state."""
    got = _f32_directions(f32_gru, *_f32_case(3, H, W))
    assert [axis for axis, _, _ in got] == ["w", "h"]
    for axis, want, port in got:
        assert port.shape == want.shape == (1, 128, H, W)
        assert port.dtype == torch.float32
        assert (port - want).abs().max().item() <= F32_TOL, axis
        assert port.abs().max().item() > 0.1


def test_gru_f32_plain_border_zero_padding(f32_gru):
    """Impulses at opposite corners and a constant context probe the zero
    padding of both convolutions along each axis, ``r * h`` outside the
    image included: the border rows and columns differ from the interior,
    and the float32 form follows the unfused path there too."""
    H, W = 8, 16
    h = torch.zeros(1, 128, H, W)
    h[0, :, 0, 0] = 1.0
    x = torch.zeros(1, 128, H, W)
    x[0, :, H - 1, W - 1] = 1.0
    inp = torch.ones(1, 128, H, W)
    for axis, want, port in _f32_directions(f32_gru, h, x, inp):
        assert (port - want).abs().max().item() <= F32_TOL, axis
        edge = want[0, :, 0, 0] if axis == "w" else want[0, :, 0, 3]
        assert not torch.allclose(edge, want[0, :, 4, 8]), axis


def test_gru_f32_taps_layout():
    """``gru_taps_f32``: the z, r and q weights with the context rows
    dropped, as (pass, input channel, tap, output channel), and the three
    biases in order."""
    gru = _load(traft.SepConvGRU(128, 256), _gru_tree(4))
    for names in (("convz1", "convr1", "convq1"),
                  ("convz2", "convr2", "convq2")):
        w, b = update.gru_taps_f32(gru, names, 128, 128)
        assert w.shape == (3, 256, 5, 128) and w.is_contiguous()
        assert b.shape == (384,) and w.dtype == b.dtype == torch.float32
        for p, name in enumerate(names):
            conv = getattr(gru, name)
            full = conv.weight.detach().reshape(128, 384, 5)
            assert torch.equal(w[p, :128], full[:, :128].permute(1, 2, 0))
            assert torch.equal(w[p, 128:], full[:, 256:].permute(1, 2, 0))
            assert torch.equal(b[128 * p:128 * (p + 1)], conv.bias.detach())


class _RouteSpy:
    """Counts the calls of the two fused GRU steps of ``models/update.py``
    (``LoopRoute`` reaches them through the module at call time)."""

    def __init__(self, monkeypatch):
        self.calls = {"gru_update_f32": 0, "gru_update": 0}
        for name in self.calls:
            fn = getattr(update, name)
            monkeypatch.setattr(update, name, self._counted(name, fn))

    def _counted(self, name, fn):
        def step(*args):
            self.calls[name] += 1
            return fn(*args)
        return step


def _forced_unfused(monkeypatch, run):
    """``run()`` with the SepConvGRU's unfused route forced (RAFT-small
    keeps its own block), the route restored after."""
    route = update.loop_route

    def unfused(*args):
        r = route(*args)
        return r if r.gru == "small" else dataclasses.replace(r,
                                                              gru="unfused")

    with monkeypatch.context() as m:
        m.setattr(update, "loop_route", unfused)
        return run()


ROUTE_CASES = {
    # name: (config overrides, frame pairs, float32 form expected)
    "highest": (dict(), 1, True),
    "default": (dict(precision="default"), 1, False),
    "bf16-no-flag": (dict(precision="bf16"), 1, False),
    "small": (dict(small=True), 1, False),
    "batch-2": (dict(), 2, False),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_gru_route_by_what_the_forward_observes(small_forward, monkeypatch,
                                                case):
    """The float32 form runs for 'highest', one frame pair, RAFT-large,
    without grad: two launches an iteration, and the flow within float32
    noise of the unfused route's. Everywhere else the unfused path runs,
    bit for bit as with the route forced off."""
    overrides, B, engaged = ROUTE_CASES[case]
    _, img1, img2 = small_forward
    if B > 1:
        img1, img2 = (torch.cat([a, a.flip(1)]) for a in (img1, img2))
    cfg = traft.RaftConfig(iters=2, **overrides)
    model = traft.init_raft_params(cfg, seed=3)
    spy = _RouteSpy(monkeypatch)

    def run():
        return traft.weighted_raft_forward(model, cfg, img1, img2)

    got = run()
    assert spy.calls == {"gru_update_f32": 2 * cfg.iters if engaged else 0,
                         "gru_update": 0}
    want = _forced_unfused(monkeypatch, run)
    for key in ("flow", "flow_up"):
        if engaged:
            assert (got[key] - want[key]).abs().max().item() <= 1e-4, key
        else:
            assert torch.equal(got[key], want[key]), key


def test_gru_route_keeps_unfused_under_training(small_forward, monkeypatch):
    """A whole-net training forward records a gradient through the GRU: the
    unfused path, bit for bit, gradients included."""
    _, img1, img2 = small_forward
    cfg = traft.RaftConfig(iters=2)
    spy = _RouteSpy(monkeypatch)

    def run():
        model = traft.init_raft_params(cfg, seed=3)
        out = traft.train_forward(model, cfg, img1, img2)
        out["flow_up"].abs().mean().backward()
        return out["flow_up"].detach(), model.update_block.gru.convz1.weight.grad

    flow, grad = run()
    assert spy.calls == {"gru_update_f32": 0, "gru_update": 0}
    want_flow, want_grad = _forced_unfused(monkeypatch, run)
    assert torch.equal(flow, want_flow) and torch.equal(grad, want_grad)


def test_gru_route_takes_float32_form_for_a_frozen_network(small_forward,
                                                           monkeypatch):
    """Weight-head-only training: the network's parameters do not require
    grad, so its forward takes the float32 form under grad mode too, and
    the head still gets its gradient."""
    _, img1, img2 = small_forward
    cfg = traft.RaftConfig(iters=2)
    model = traft.init_raft_params(cfg, seed=3)
    for name, p in model.named_parameters():
        p.requires_grad_(name.startswith("weight_head"))
    spy = _RouteSpy(monkeypatch)
    out = traft.train_forward(model, cfg, img1, img2)
    assert spy.calls["gru_update_f32"] == 2 * cfg.iters
    out["weights"].mean().backward()
    assert model.weight_head.net[0].weight.grad is not None


def test_gru_f32_wrappers_refuse_and_dispatch():
    """The launch wrapper refuses a CPU tensor; the step's dispatch has no
    ``try``; under grad the step raises rather than lose the gradient."""
    import ast
    import inspect

    from woft_tpu_torch.ops import kernels

    h = torch.zeros(1, 4, 6, 128)
    w, b = update.gru_taps_f32(traft.SepConvGRU(128, 256),
                               ("convz1", "convr1", "convq1"), 128, 128)
    args = (h, h, torch.zeros(1, 4, 6, 256), h, w, b, "w")
    with pytest.raises(ValueError):
        kernels.fused_gru_update_f32(*args)
    for fn in (update.gru_update_f32, kernels.fused_gru_update_f32):
        tree = ast.parse(inspect.getsource(fn))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
    with pytest.raises(RuntimeError):
        update.gru_update_f32(h.clone().requires_grad_(), *args[1:])
    assert update.gru_update_f32(*args).shape == h.shape
    with layers.precision_scope("bf16"), pytest.raises(ValueError):
        update.LoopRoute("f32").context(traft.SepConvGRU(128, 256),
                                        torch.zeros(1, 128, 4, 6))


# ---------------------------------------------------------------------------
# the card's bf16 route: kernels G, H and I by observation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def route_block():
    return traft.init_raft_params(traft.RaftConfig(), seed=5).update_block


def _want_route(card, precision, B, grad, flags):
    """The route ``loop_route`` owes a forward of RAFT-large: a batch and a
    forward that trains the loop run unfused, except that the flags keep
    their meaning in bf16 off the card's route; one frame pair without a
    gradient runs G, H and I in bf16 on the card, G's float32 form in
    'highest'."""
    if B != 1:
        return update.LoopRoute("unfused")
    if precision == "bf16":
        if card and not grad:
            return update.LoopRoute("bf16", tail=True, encoder=True)
        return update.LoopRoute("bf16" if flags else "unfused", flags)
    if precision == "highest" and not grad:
        return update.LoopRoute("f32")
    return update.LoopRoute("unfused")


@pytest.mark.parametrize("flags", [False, True], ids=["no-flags", "flags"])
@pytest.mark.parametrize("grad", [False, True], ids=["no-grad", "grad"])
@pytest.mark.parametrize("B", [1, 2], ids=["B1", "B2"])
@pytest.mark.parametrize("precision", ["bf16", "highest", "default"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_loop_route_by_what_the_forward_observes(route_block, monkeypatch,
                                                 card, precision, B, grad,
                                                 flags):
    """``loop_route`` over the card (its predicate patched, as J's is),
    the precision, the batch, a gradient through the update block and the
    flags: on the card a bf16 forward of one pair without grad takes G, H
    and I whatever the flags; the CPU keeps the flags' parity route."""
    monkeypatch.setattr(update, "_on_card", lambda *tensors: card)
    cfg = traft.RaftConfig(precision=precision, gru_fused=flags,
                           tail_fused=flags)
    x = torch.zeros(B, 128, 4, 6)
    with layers.precision_scope(precision), torch.set_grad_enabled(grad):
        got = update.loop_route(cfg, B, route_block, x, x)
    assert got == _want_route(card, precision, B, grad, flags)


@pytest.mark.parametrize("precision", ["bf16", "highest", "default"])
@pytest.mark.parametrize("card", [False, True], ids=["cpu", "card"])
def test_loop_route_small_keeps_its_block(monkeypatch, card, precision):
    """RAFT-small runs its own block on every route, flags and card alike."""
    monkeypatch.setattr(update, "_on_card", lambda *tensors: card)
    cfg = traft.RaftConfig(small=True, precision=precision, gru_fused=True,
                           tail_fused=True)
    block = traft.SmallUpdateBlock(196, 96)
    x = torch.zeros(1, 96, 4, 6)
    with layers.precision_scope(precision), torch.no_grad():
        assert update.loop_route(cfg, 1, block, x) == update.LoopRoute("small")


ULP = 2.0 ** -8            # one bf16 ulp relative to a value's binade top


def test_card_route_step_matches_unfused_step(route_block):
    """One bf16 step of the card's route (kernels G, H, I through their
    plain versions: CPU tensors) against the unfused step from the same
    state, on a 17 x 30 grid (odd, as 1080p's 135 x 240 is against the
    kernels' tiles), each stage from the same inputs within the kernels'
    tolerances (README): H 2 ulps plus one of the map's scale, G 4 ulps of
    max(1, |h|), I one ulp of its scale; the step's state and delta within
    G's and I's. The two round at other points (the unfused path rounds
    each bias to bf16 before its convolution): observed at 0.04-0.08, 0.25-
    0.29 and 0.13-0.15 of the tolerances over three seeds, the step's
    state at 0.3 and its delta at 0.5."""
    ub = route_block
    g = torch.Generator().manual_seed(6)
    H, W = 17, 30
    net = torch.tanh(torch.randn(1, 128, H, W, generator=g))
    inp = torch.relu(torch.randn(1, 128, H, W, generator=g))
    corr = torch.randn(1, 324, H, W, generator=g)
    flow = 3 * torch.randn(1, 2, H, W, generator=g)
    card = update.LoopRoute("bf16", tail=True, encoder=True)
    unfused = update.LoopRoute("unfused")

    def check_map(got, want):           # H's tolerance
        got, want = got.float(), want.float()
        allowed = 2 * ULP * want.abs() + ULP * want.abs().max()
        assert ((got - want).abs() <= allowed).all()

    def check_state(got, want):         # G's
        allowed = 4 * ULP * want.abs().clamp(min=1.0)
        assert ((got - want).abs() <= allowed).all()

    def check_delta(got, want):         # I's
        assert (got - want).abs().max() <= ULP * want.abs().max()

    with layers.precision_scope("bf16"), torch.no_grad():
        ctx_c, ctx_u = card.context(ub.gru, inp), unfused.context(ub.gru, inp)
        motion = ub.encoder(flow, corr)
        check_map(ub.encoder(flow, corr, fused=True), motion)
        check_state(card.sep_conv_gru(net, motion, ctx_c),
                    unfused.sep_conv_gru(net, motion, ctx_u))
        check_delta(ub.flow_head(net, fused=True), ub.flow_head(net))
        net_c, delta_c = card.step(ub, net, corr, flow, ctx_c)
        net_u, delta_u = unfused.step(ub, net, corr, flow, ctx_u)
    assert net_c.dtype == delta_c.dtype == torch.float32
    assert net_c.shape == net_u.shape and delta_c.shape == delta_u.shape
    check_state(net_c, net_u)
    check_delta(delta_c, delta_u)
    assert delta_u.abs().max().item() > 0.05


def test_card_route_forward_on_the_cpu(small_forward, monkeypatch):
    """A bf16 forward with the card's predicate patched takes the card's
    route through the plain versions: each iteration one call of H, two of
    G and one of I, with no flag; the kernels' taps made once a forward,
    not once an iteration; the flow within bf16 noise of the unfused
    forward's."""
    model, img1, img2 = small_forward
    cfg = _cfg("bf16")
    want = traft.weighted_raft_forward(model, cfg, img1, img2)["flow_up"]
    calls = dict.fromkeys(("gru_update", "motion_encoder_tail", "flow_head",
                           "taps"), 0)

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(update, name, counted(name, getattr(update,
                                                                 name)))
    monkeypatch.setattr(update, "_on_card", lambda *tensors: True)
    got = traft.weighted_raft_forward(model, cfg, img1, img2)["flow_up"]
    n = cfg.iters
    # taps: G's four (z|r and q, two directions), H's three, I's two
    assert calls == {"gru_update": 2 * n, "motion_encoder_tail": n,
                     "flow_head": n, "taps": 9}
    assert not torch.equal(got, want)
    assert (got - want).abs().max().item() < 0.02
