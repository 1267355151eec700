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
    with layers.precision_scope("bf16"), torch.no_grad():
        tpre = traft.precompute_gru_context(gru, _nchw(inp), 128, fused=True)
        port = traft._sep_conv_gru(_nchw(h), _nchw(x, torch.bfloat16), tpre,
                                   fused=True)
    assert port.dtype == torch.float32
    return oracle, xla, pallas, _nhwc_np(port)


@pytest.mark.parametrize("H,W", [(16, 32), (19, 28), (2, 61), (11, 15)])
def test_gru_plain_matches_pallas(H, W):
    """Both directions through ``_sep_conv_gru(fused=True)``. Observed:
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
            traft.precompute_gru_context(traft.SepConvGRU(128, 256),
                                         torch.zeros(1, 128, 8, 8), 128,
                                         fused=True)


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
