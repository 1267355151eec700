"""Gradients of the port against ``woft_tpu`` on the CPU: the repairs
training needed (a differentiable batched QR fit, bf16 casts that keep the
graph, kernels without a backward that refuse grad), kernel B's
``autograd.Function`` (B' on the card, autograd through the plain lookup
here) and the block-local path's ``Function``s (C, D, E).

Tolerances: the fit's value and gradients 1e-4 of the largest magnitude
(float32 QR in two libraries); lookups' gradients 1e-5 of the largest
value in float32 (the same float32 terms, summed in another order), a bf16
level's gradient within one bf16 ulp of JAX's float32 one (the port rounds
its float32 sum once); the block-local path 2e-4 / 1e-4, the JAX package's
own bound for its kernel gradients (``tests/test_kernel_grads.py``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.geometry import homography as jhom
from woft_tpu.models import corr as jcorr
from woft_tpu_torch.geometry import homography as thom
from woft_tpu_torch.models import corr as tcorr
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models import update
from woft_tpu_torch.ops import kernels, warp

FIT_REL = 1e-4
LOOKUP_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs; the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _close(a, b, rel, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-12)
    err = np.abs(a - b).max()
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _fit_inputs(B=3, N=500, seed=0):
    rng = np.random.default_rng(seed)
    p1 = rng.uniform(0, 200, (B, N, 2)).astype(np.float32)
    H = np.eye(3) + rng.normal(0, 0.05, (B, 3, 3)) * [[1, 1, 20],
                                                      [1, 1, 20],
                                                      [1e-3, 1e-3, 0]]
    h = np.einsum("bij,bnj->bni", H, np.concatenate(
        [p1, np.ones((B, N, 1))], -1))
    p2 = (h[..., :2] / h[..., 2:] + rng.normal(0, 0.5, (B, N, 2))).astype(
        np.float32)
    w = rng.uniform(0.05, 1.0, (B, N)).astype(np.float32)
    r = rng.normal(size=(B, 3, 3)).astype(np.float32)
    return p1, p2, w, r


def test_batched_fit_value_and_grads_match_jax():
    """Repair a: the batched fit under grad takes the reduced QR, which
    autograd differentiates (the TSQR's ``mode='r'`` raised)."""
    p1, p2, w, r = _fit_inputs()

    def jloss(a, b, c):
        H = jhom.find_homography_wls_qr(a, b, c)
        return jnp.sum(H * r), H

    (jl, jH), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                      has_aux=True)(p1, p2, w)
    t = [torch.tensor(x, requires_grad=True) for x in (p1, p2, w)]
    H = thom.find_homography_wls_qr(*t)
    (H * torch.from_numpy(r)).sum().backward()
    _close(H.detach(), jH, FIT_REL, "H")
    for name, a, b in zip(("points1", "points2", "weights"), t, jg):
        _close(a.grad, b, FIT_REL, name)


def test_batched_fit_without_grad_is_unchanged():
    """The trackers' batched fit (no grad) still solves by the two-level
    tall-skinny QR, bit for bit."""
    p1, p2, w, _ = _fit_inputs()
    a, b, c = (torch.from_numpy(x) for x in (p1, p2, w))
    with torch.no_grad():
        got = thom.find_homography_wls_qr(a.requires_grad_(), b, c)
    p1n, t1 = thom.normalize_points(a.detach(), c)
    p2n, t2 = thom.normalize_points(b, c)
    A, rhs = thom._build_nonhomogeneous_system(p1n, p2n, c)
    want = thom._solution_to_h(thom._lstsq_tsqr(A, rhs), t1, t2)
    assert torch.equal(got, want)


def test_bf16_forward_keeps_the_weights_in_the_graph():
    """Repair b: bf16 mode's cached casts are detached; under grad a
    parameter that requires grad is cast in the graph."""
    cfg = traft.RaftConfig(small=True, iters=2, precision="bf16",
                           weight_head_structure=((32, 3),))
    model = traft.init_raft_params(cfg, seed=1)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (2, 32, 48, 3)).astype(
        np.float32))
    out = traft.train_forward(model, cfg, img, img.roll(2, 2))
    (out["flow_up"].square().mean() + out["weights_up"].mean()).backward()
    for name, p in model.named_parameters():
        if name.endswith("weight") and p.dim() == 4:
            assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_train_forward_detaches_the_coordinates_each_iteration():
    """The refinement loop cuts the coordinate chain at each iteration:
    the first iteration's flow head gets no gradient through the later
    lookups' coordinates, only through the final ones."""
    cfg = traft.RaftConfig(small=True, iters=2,
                           weight_head_structure=((32, 3),))
    model = traft.init_raft_params(cfg, seed=2)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.uniform(0, 255, (1, 32, 48, 3)).astype(
        np.float32))
    out = traft.train_forward(model, cfg, img, img.roll(1, 2))
    assert out["flow_up"].requires_grad
    # no_grad twin: the same numbers
    ref = traft.weighted_raft_forward(model, cfg, img, img.roll(1, 2))
    np.testing.assert_allclose(out["flow_up"].detach(), ref["flow_up"],
                               atol=1e-4)


def _fused_model():
    cfg = traft.RaftConfig(iters=1, precision="bf16",
                           weight_head_structure=((32, 3),))
    return cfg, traft.init_raft_params(cfg, seed=0)


def _raises_a():
    img = torch.rand(1, 16, 16, 3, requires_grad=True)
    warp.warp_perspective_fast(img, torch.eye(3))


def _raises_f():
    local = tcorr.build_local_corr(torch.rand(1, 8, 16, 32),
                                   torch.rand(1, 8, 16, 32), 4, 2, 8)
    starts, frac = tcorr._local_level_coords(local,
                                             torch.rand(1, 8, 16, 2) * 8)
    rcs, rel, _ = tcorr._fine_anchor_starts(local, starts)
    tcorr.block_local_lookup_fine(rcs[:, 0].contiguous(),
                                  local.volumes[0].requires_grad_(),
                                  rel[0], frac[0], 9)


def _raises_fused(**flags):
    cfg, model = _fused_model()
    img = torch.rand(1, 32, 48, 3) * 255
    traft.train_forward(model, traft.RaftConfig(
        iters=1, precision="bf16", weight_head_structure=((32, 3),),
        **flags), img, img)


def _raises_g_wrapper():
    h = torch.zeros(1, 4, 4, 128, requires_grad=True)
    x = torch.zeros(1, 4, 4, 128, dtype=torch.bfloat16)
    update.gru_update(h, x, x.repeat(1, 1, 1, 2), x,
                      torch.zeros(5, 256, 256, dtype=torch.bfloat16),
                      torch.zeros(5, 128, 256, dtype=torch.bfloat16),
                      torch.zeros(256), torch.zeros(128), "w")


def _raises_h():
    _, model = _fused_model()
    enc = model.update_block.encoder
    from woft_tpu_torch.models import layers
    with layers.precision_scope("bf16"):
        enc(torch.zeros(1, 2, 4, 4), torch.zeros(1, 324, 4, 4), fused=True)


def _raises_i_wrapper():
    net = torch.zeros(1, 4, 4, 128, requires_grad=True)
    update.flow_head(net, torch.zeros(9, 256, 128, dtype=torch.bfloat16),
                     torch.zeros(256),
                     torch.zeros(9, 2, 256, dtype=torch.bfloat16),
                     torch.zeros(2))


@pytest.mark.parametrize("kernel,call", [
    ("A", _raises_a), ("F", _raises_f),
    ("G", lambda: _raises_fused(gru_fused=True)),
    ("G", _raises_g_wrapper), ("H", _raises_h),
    ("I", lambda: _raises_fused(tail_fused=True)),
    ("I", _raises_i_wrapper)],
    ids=["A", "F", "G-config", "G-wrapper", "H", "I-config", "I-wrapper"])
def test_kernels_without_backward_raise_under_grad(kernel, call):
    """Repair d: A, F, G, H and I have no backward (nor in the JAX
    package): under grad they raise, naming the kernel, on both devices."""
    with pytest.raises(RuntimeError, match=f"kernel {kernel} "):
        call()


def _lookup_case(dtype, seed=0):
    """A 3 x 4 x 6-query pyramid of four levels (the last 1 x 2), with
    centroids at integer positions, inside, partly and wholly outside."""
    rng = np.random.default_rng(seed)
    B, H1, W1 = 3, 4, 6
    Q = B * H1 * W1
    shapes = [(H1, W1), (2, 3), (1, 1), (1, 1)]
    levels = [rng.normal(size=(Q, h, w)).astype(np.float32)
              for h, w in shapes]
    coords = rng.uniform(-3, 9, (B, H1, W1, 2)).astype(np.float32)
    coords[0, 0] = np.floor(coords[0, 0])
    coords[1, 1, :3] += 20.0
    g = rng.normal(size=(B, H1, W1, 4 * 81)).astype(np.float32)
    if dtype == torch.bfloat16:         # the values bf16 levels hold
        levels = [torch.from_numpy(lv).to(dtype).float().numpy()
                  for lv in levels]
    return levels, coords, g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_lookup_function_grads_match_jax(dtype):
    """Kernel B's ``Function`` (its CPU path: the plain forward, autograd
    through the plain version on float32-widened levels backward) against
    ``jax.grad`` through ``woft_tpu``'s one-hot lookup on the same float32
    values, and against autograd through ``corr_lookup_plain``."""
    levels, coords, g = _lookup_case(dtype)

    def jloss(lv, c):
        return jnp.sum(jcorr.corr_lookup(lv, c, 4, impl="onehot") * g)

    jg_lv, jg_c = jax.grad(jloss, argnums=(0, 1))(
        [jnp.asarray(x) for x in levels], jnp.asarray(coords))
    lv = [torch.from_numpy(x).to(dtype).requires_grad_() for x in levels]
    c = torch.from_numpy(coords).requires_grad_()
    out = tcorr.corr_lookup(lv, c, 4)
    assert type(out.grad_fn).__name__ == "_CorrLookupBackward"
    (out * torch.from_numpy(g)).sum().backward()
    _close(c.grad, jg_c, LOOKUP_REL, "coords")
    for lvl, (a, b) in enumerate(zip(lv, jg_lv)):
        assert a.grad.dtype == dtype
        if dtype == torch.float32:
            _close(a.grad, b, LOOKUP_REL, f"level {lvl}")
        else:       # one rounding of JAX's float32 sum
            b = np.asarray(b)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(b), 1e-30))
                                   ) - 7)
            assert (np.abs(a.grad.float().numpy() - b) <= ulp).all(), lvl

    # the same as autograd through the plain lookup itself
    lv2 = [torch.from_numpy(x).requires_grad_() for x in levels]
    c2 = torch.from_numpy(coords).requires_grad_()
    (tcorr.corr_lookup_plain(lv2, c2, 4) * torch.from_numpy(g)).sum(
    ).backward()
    _close(c.grad, c2.grad, LOOKUP_REL, "coords vs plain")
    for a, b in zip(lv, lv2):
        if dtype == torch.float32:
            _close(a.grad, b.grad, LOOKUP_REL, "level vs plain")


def test_indexed_lookup_under_grad_raises():
    pyr = [torch.rand(4, 3, 3, requires_grad=True)]
    with pytest.raises(ValueError, match="rows="):
        tcorr.corr_lookup(pyr, torch.rand(1, 1, 2, 2), 1,
                          rows=torch.tensor([0, 3]))


def _smooth_coords(H1, W1):
    ys, xs = np.meshgrid(np.arange(H1, dtype=np.float32),
                         np.arange(W1, dtype=np.float32), indexing="ij")
    res = np.stack([0.15 * ys - 0.1 * xs + 2.3, 0.12 * xs + 0.05 * ys - 3.1],
                   -1)
    return (np.stack([xs, ys], -1) + res).astype(np.float32)[None]


@pytest.mark.parametrize("fine", [True, False], ids=["guarded", "exact"])
def test_block_local_grads_match_jax_dense(fine):
    """C, D and E under grad: the port's block-local path (``_LocalCorr``,
    ``_LocalLookup``; their CPU forwards are the plain versions, their
    backwards the plain versions' VJPs) against ``jax.grad`` through
    ``woft_tpu``'s dense (XLA) block-local path, at the shapes of the JAX
    package's own kernel-gradient tests."""
    rng = np.random.default_rng(3)
    H1, W1, D = 16, 32, 64
    f1 = rng.normal(size=(1, H1, W1, D)).astype(np.float32)
    f2 = rng.normal(size=(1, H1, W1, D)).astype(np.float32)
    coords = _smooth_coords(H1, W1)
    n = 3 * 81 * H1 * W1
    sw = np.sin(np.arange(n, dtype=np.float32) * 1e-3).reshape(
        1, H1, W1, 3 * 81)

    def jloss(a, b, c):
        vol = jcorr.build_local_corr(a, b, radius=4, num_levels=3, margin=8,
                                     use_pallas=False, layout="q")
        return jnp.sum(jcorr.corr_lookup_local(vol, c, 4, fine=fine) * sw)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(f1, f2, coords)
    t = [torch.from_numpy(x).requires_grad_() for x in (f1, f2, coords)]
    local = tcorr.build_local_corr(t[0], t[1], 4, 3, 8)
    assert type(local.volumes[0].grad_fn).__name__ == "_LocalCorrBackward"
    out = tcorr.corr_lookup_local(local, t[2], 4, fine=fine)
    (out * torch.from_numpy(sw)).sum().backward()
    for name, a, b in zip(("fmap1", "fmap2", "coords"), t, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   atol=2e-4, rtol=1e-4, err_msg=name)


def test_local_train_grads_equal_dense():
    """A train_flow-style gradient of the whole forward at B = 1 through
    the block-local path (C, D, E under grad) equals the dense path's (B)
    on every parameter: the CPU twin of the card's check."""
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
    local = grads(traft.RaftConfig(iters=2, corr_impl="local",
                                   weight_head_structure=((32, 3),)))
    for (name, _), a, b in zip(model.named_parameters(), local, dense):
        np.testing.assert_allclose(a, b, atol=5e-4, rtol=5e-4, err_msg=name)
