"""Kernel L's model side on the CPU: ``ops/kernels.py:instance_norm_act``'s
CPU path (``instance_norm_act_plain``) against the encoder modules' own
calls and against the JAX package's ``instance_norm``, the kernel's split
plans, and the encoders' route (``models/raft.py:_norm_route``).

The plain version makes the modules' calls (the convolution's bias add,
``F.instance_norm``, ``F.relu``, the add), so it equals them bit for bit.
Against ``woft_tpu`` (XLA's mean and variance in float32, ``rsqrt``):
float32 within 1e-5 of the largest value; bf16 within 2^-6 of it, since
PyTorch's CPU batch norm on a bf16 map keeps its statistics coarser than
float32 (the plain version's own rounding on the CPU, up to 0.0086 of the
largest value on these cases; on the card PyTorch's statistics are float32,
and the card's tests hold kernel L to the plain version within one bf16
ulp a rounding: ``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from woft_tpu.models import layers as jlayers
from woft_tpu_torch.models import layers
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.ops import kernels

SHAPES = [(1, 8, 16, 24), (2, 3, 7, 9), (1, 5, 1, 13)]
SHAPE_IDS = ["1x8x16x24", "2x3x7x9-odd", "1x5x1x13"]
MODES = ["relu", "residual", "shortcut"]
DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}
F32_REL = 1e-5
BF16_REL = 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs (the suite's workers run
    side by side), the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _inputs(shape, dtype, seed):
    """A convolution-like map (each plane its own offset and scale), a
    shortcut's, a block input (after a ReLU) and the two biases, seeded
    with numpy, in ``dtype``."""
    rng = np.random.default_rng(seed)
    n, c = shape[:2]
    scale = rng.uniform(0.2, 3.0, (n, c, 1, 1))
    offset = rng.uniform(-3.0, 3.0, (n, c, 1, 1))
    x = rng.standard_normal(shape) * scale + offset
    sc = rng.standard_normal(shape) * scale - offset
    r = np.maximum(rng.standard_normal(shape), 0.0)
    b, sb = rng.standard_normal((2, c))
    return tuple(torch.from_numpy(np.float32(a)).to(dtype)
                 for a in (x, sc, r, b, sb))


def _modules(x, mode, sc, r, b, sb):
    """The encoder modules' calls on a convolution's output without its
    bias: the bias add, ``nn.InstanceNorm2d``, ReLU (and the residual or the
    normalised shortcut, the add, ReLU)."""
    y = F.relu(nn.InstanceNorm2d(x.shape[1])(x + b.view(1, -1, 1, 1)))
    if mode == "relu":
        return y
    if mode == "shortcut":
        r = nn.InstanceNorm2d(x.shape[1])(sc + sb.view(1, -1, 1, 1))
    return F.relu(r + y)


def _kwargs(mode, sc, r, b, sb):
    kw = {"relu": {}, "residual": {"residual": r},
          "shortcut": {"shortcut": sc, "shortcut_bias": sb}}[mode]
    return dict(kw, bias=b)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_equals_modules(shape, dtype, mode):
    """The wrapper on CPU tensors (its plain version) equals the modules'
    calls bit for bit, with and without the biases, and launches nothing."""
    x, sc, r, b, sb = _inputs(shape, DTYPES[dtype], seed=sum(shape))
    n0 = kernels.instance_norm_act.launches
    with torch.no_grad():
        got = kernels.instance_norm_act(x, **_kwargs(mode, sc, r, b, sb))
        want = _modules(x, mode, sc, r, b, sb)
        zero = torch.zeros_like(b)
        got0 = kernels.instance_norm_act(x, **_kwargs(mode, sc, r, None,
                                                      None))
        want0 = _modules(x, mode, sc, r, zero, zero)
    assert got.dtype == x.dtype and torch.equal(got, want)
    assert torch.equal(got0, want0)
    assert kernels.instance_norm_act.launches == n0


def _jax_nchw(t):
    """A torch NCHW tensor -> the JAX package's NHWC array, same values."""
    a = jnp.asarray(t.float().permute(0, 2, 3, 1).numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_matches_jax(shape, dtype, mode):
    """Against ``woft_tpu.models.layers.instance_norm`` with its ReLU (and
    the residual or the normalised shortcut, the add, ReLU), on the same
    biased inputs (the bias add rounded by torch: the JAX side's excess
    precision would skip that rounding)."""
    torch_dtype = DTYPES[dtype]
    x, sc, r, b, sb = _inputs(shape, torch_dtype, seed=7 + sum(shape))
    xb = x + b.view(1, -1, 1, 1)
    scb = sc + sb.view(1, -1, 1, 1)
    with torch.no_grad():
        got = kernels.instance_norm_act(
            xb, **{"relu": {}, "residual": {"residual": r},
                   "shortcut": {"shortcut": scb}}[mode]).float()
    jy = jlayers.relu(jlayers.instance_norm(_jax_nchw(xb)))
    if mode == "relu":
        want = jy
    else:
        jr = (_jax_nchw(r) if mode == "residual"
              else jlayers.instance_norm(_jax_nchw(scb)))
        want = jlayers.relu(jr + jy)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32))).permute(
        0, 3, 1, 2)
    rel = F32_REL if torch_dtype == torch.float32 else BF16_REL
    assert (got - want).abs().max() <= rel * want.abs().max()


# (planes, H*W, elements a load) of the encoders' norms in the three
# benchmark cells (RAFT-large, one image: layer1 at half the frame, layer2
# at a quarter, layer3 at an eighth), and odd ones
CELL_PLANES = [(64, 360 * 640, 4), (96, 180 * 320, 4), (128, 90 * 160, 4),
               (64, 540 * 960, 8), (96, 270 * 480, 8), (128, 135 * 240, 8),
               (64, 1080 * 1920, 4), (96, 540 * 960, 4), (128, 270 * 480, 4)]
ODD_PLANES = [(6, 1961, 1), (1, 1, 1), (4096, 64, 4), (768, 32 * 48, 8)]


@pytest.mark.parametrize("planes,hw,vec", CELL_PLANES + ODD_PLANES)
def test_instance_norm_plan(planes, hw, vec):
    """Chunks of whole vectors that cover each plane once, none empty, at
    most NORM_MAX_SPLITS a plane; at the cells' shapes three blocks an SM
    or more on the H100's 132."""
    splits, chunk = kernels.instance_norm_plan(planes, hw, vec, 132)
    assert chunk % vec == 0 and 1 <= splits <= kernels.NORM_MAX_SPLITS
    assert (splits - 1) * chunk < hw <= splits * chunk
    if (planes, hw, vec) in CELL_PLANES:
        assert planes * splits >= 3 * 132


@pytest.mark.parametrize("images,hw", [(1, 360 * 640), (1, 540 * 960),
                                       (1, 1080 * 1920), (2, 32 * 48),
                                       (8, 37 * 53), (1, 1)])
def test_instance_norm_stem_plan(images, hw):
    """The stem form's chunks of positions cover each image once, none
    empty, at most NORM_STEM_MAX_SPLITS; at the cells' stems (one image)
    six blocks an SM or more on the H100's 132."""
    splits, chunk = kernels.instance_norm_stem_plan(images, hw, 132)
    assert 1 <= splits <= kernels.NORM_STEM_MAX_SPLITS
    assert (splits - 1) * chunk < hw <= splits * chunk
    if hw >= 360 * 640:
        assert images * splits >= 6 * 132


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("small", [False, True], ids=["large", "small"])
def test_encoder_route_equals_modules(monkeypatch, precision, small):
    """A feature encoding with no grad goes through the wrapper, 13 calls
    for RAFT-large (15 norms: each strided block's shortcut norm rides its
    last call) and 19 for RAFT-small, and on the CPU gives the modules'
    features bit for bit; with grad on, or with the context encoder's batch
    norm, the modules run and the wrapper is not called."""
    cfg = traft.RaftConfig(precision=precision, small=small)
    model = traft.init_raft_params(cfg, seed=1)
    g = torch.Generator().manual_seed(3)
    x = (torch.rand(2, 40, 56, 3, generator=g) * 2 - 1).permute(0, 3, 1, 2)
    calls = []
    wrapper = kernels.instance_norm_act

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return wrapper(*args, **kw)

    monkeypatch.setattr(kernels, "instance_norm_act", counting)
    with layers.precision_scope(precision):
        with torch.no_grad():
            got = model.fnet(x)
            n_route = len(calls)
            model.cnet(x)
            assert len(calls) == n_route
            with monkeypatch.context() as m:
                m.setattr(traft, "_norm_route", lambda module: False)
                want = model.fnet(x)
        assert len(calls) == n_route
        grad = model.fnet(x)
    assert n_route == (19 if small else 13)
    assert len(calls) == n_route
    assert torch.equal(got, want) and torch.equal(grad.detach(), want)
    grad.float().square().mean().backward()
    assert model.fnet.conv1.weight.grad.abs().sum().item() > 0


def test_wrapper_refuses():
    """A residual and a shortcut at once, a shortcut bias without a
    shortcut, and a call that would record a gradient."""
    x, sc, r, b, sb = _inputs((1, 4, 5, 6), torch.float32, seed=0)
    with pytest.raises(ValueError):
        kernels.instance_norm_act(x, residual=r, shortcut=sc)
    with pytest.raises(ValueError):
        kernels.instance_norm_act(x, shortcut_bias=sb)
    with pytest.raises(RuntimeError):
        kernels.instance_norm_act(x.requires_grad_())
