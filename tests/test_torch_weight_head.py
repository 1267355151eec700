"""Kernel J's model side on the CPU (``woft_tpu_torch/models/weight_head.py``):
its plain version against the unfused bf16 head, the reshape of the
lookup's channels, the weight layout, and the route of
``models/raft.py:weight_head_apply``.

The plain version and the unfused head (``raft.weight_head_chain``) round at
the same points (bf16 operands, float32 sums and biases) and sum in other
orders, so an activation whose sum lands at a bf16 rounding boundary may
round the other way: on seeded weights they differ by 6.8e-6 at most on
logits up to 0.066 (300 rows), 1/39 of a bf16 ulp of the largest logit. The
bound is a quarter of that ulp. The route is held where it must not move:
'highest', 'default', a gradient and other heads return the parent's
unfused head bit for bit.
"""

import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from woft_tpu_torch.models import layers
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models import weight_head as whead
from woft_tpu_torch.ops import kernels

PLAIN_TOL = 2.0 ** -8 / 4       # of the largest logit's magnitude


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs (the suite's workers run
    side by side), the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def head():
    return traft.init_raft_params(traft.RaftConfig(precision="bf16"),
                                  seed=0).weight_head


def _rows(M, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    corr = 2.0 * torch.randn(M, 324, generator=g)
    return corr.to(dtype), torch.randn(M, generator=g)


def _quirk_row():
    """One row whose 324 lookups are distinct and exact in bf16 (k / 64 for
    k in -162 .. 161, shuffled), with a mean response unlike all of them."""
    g = torch.Generator().manual_seed(3)
    corr = (torch.randperm(324, generator=g) - 162).float() / 64.0
    return corr[None], torch.tensor([3.3])


def _parent_head(head, corr_sample, mean_response):
    """The unfused weight head as the parent commit wrote it."""
    B, H1, W1, Kp, _, L = corr_sample.shape
    n = B * H1 * W1
    x = corr_sample.reshape(n, Kp, Kp, L)
    mean = mean_response.reshape(n, 1, 1, 1).expand(n, Kp, Kp, 1)
    x = torch.cat([x, mean], dim=-1).permute(0, 3, 1, 2)
    for mod in head.net:
        x = layers.conv(mod, x) if isinstance(mod, nn.Conv2d) else F.relu(x)
    return x.mean(dim=(2, 3)).reshape(B, H1, W1, 1)


def _unfused_bf16(head, corr, mean):
    M = corr.shape[0]
    with torch.no_grad(), layers.precision_scope("bf16"):
        return traft.weight_head_apply(head, corr.reshape(1, 1, M, 9, 9, 4),
                                       mean.reshape(1, 1, M)).reshape(M)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 81, 300])
def test_plain_matches_the_unfused_head_in_bf16(head, M, dtype):
    """The plain version of J (what ``weight_head`` runs on a CPU tensor)
    against ``weight_head_apply`` in bf16 mode, on float32 and bf16
    lookups."""
    corr, mean = _rows(M, seed=M, dtype=dtype)
    want = _unfused_bf16(head, corr, mean)
    with torch.no_grad():
        got = whead.weight_head(corr, mean, *whead.head_params(head))
    assert got.dtype == torch.float32 and got.shape == (M,)
    assert (got - want).abs().max() <= PLAIN_TOL * want.abs().max()


def test_reshape_quirk(head):
    """The 324 channels are read as (Kp, Kp, L), ``[y * 36 + x * 4 + l]``,
    although the lookup lays them out level-major: on a row of distinct
    values the plain version agrees with the unfused head, and reading the
    same row level-major (``[l * 81 + y * 9 + x]``) does not."""
    corr, mean = _quirk_row()
    want = _unfused_bf16(head, corr, mean)
    params = whead.head_params(head)
    level_major = corr.reshape(4, 9, 9).permute(1, 2, 0).reshape(1, 324)
    with torch.no_grad():
        got = whead.weight_head_plain(corr, mean, *params)
        misread = whead.weight_head_plain(level_major, mean, *params)
    tol = PLAIN_TOL * want.abs().max()
    assert (got - want).abs().max() <= tol
    assert (misread - want).abs().max() > 10 * tol   # 24x on these weights


def test_head_params_layout(head):
    """Block 0 of the taps is conv1 as the im2col product (column (ky * 3 +
    kx) * 5 + c), blocks 1-9 and 10-18 conv2's and conv3's taps, input
    channels minor; consts hold the biases and w4 rounded to bf16."""
    taps, consts = whead.head_params(head)
    c1, c2, c3, c4 = list(head.net)[::2]
    assert taps.shape == (19 * 128, 128) and taps.dtype == torch.bfloat16
    bf = torch.bfloat16
    for ky in range(3):
        for kx in range(3):
            t = ky * 3 + kx
            assert torch.equal(taps[:128, t * 5:t * 5 + 5],
                               c1.weight[:, :, ky, kx].to(bf))
            assert torch.equal(taps[(1 + t) * 128:(2 + t) * 128],
                               c2.weight[:, :, ky, kx].to(bf))
            assert torch.equal(taps[(10 + t) * 128:(11 + t) * 128],
                               c3.weight[:, :, ky, kx].to(bf))
    assert not taps[:128, 45:].any()
    assert torch.equal(consts, torch.cat([
        c1.bias, c2.bias, c3.bias,
        c4.weight.reshape(128).to(bf).float(), c4.bias]).detach())


def test_route_keeps_the_unfused_head_on_the_cpu(head):
    """On CPU tensors bf16 mode runs the unfused head, as before: the
    parent's result bit for bit, and no launch."""
    corr, mean = _rows(40, seed=7)
    cs, mr = corr.reshape(1, 4, 10, 9, 9, 4), mean.reshape(1, 4, 10)
    n0 = kernels.weight_head.launches
    with torch.no_grad(), layers.precision_scope("bf16"):
        assert not whead.fused_route(head, cs, mr)
        got = traft.weight_head_apply(head, cs, mr)
        want = _parent_head(head, cs, mr)
    assert torch.equal(got, want)
    assert kernels.weight_head.launches == n0


ROUTE_CASES = ["bf16", "highest", "default", "grad", "small_head", "patch7"]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_by_what_it_observes(head, monkeypatch, case):
    """With the tensors taken for the card's, only bf16 mode with no
    gradient and WOFT's head over a 9 x 9 patch takes kernel J (here a spy
    that runs the plain version); 'highest', 'default', a gradient into the
    head, RAFT-small's one-layer head and a 7 x 7 patch return the parent's
    unfused head bit for bit."""
    calls = []

    def spy(corr, mean, taps, consts):
        calls.append(tuple(corr.shape))
        return whead.weight_head_plain(corr, mean, taps, consts)

    monkeypatch.setattr(whead, "_on_card", lambda *tensors: True)
    monkeypatch.setattr(whead, "weight_head", spy)
    kp = 7 if case == "patch7" else 9
    g = torch.Generator().manual_seed(11)
    cs = 2.0 * torch.randn(1, 3, 5, kp, kp, 4, generator=g)
    mr = torch.randn(1, 3, 5, generator=g)
    h = head
    if case == "small_head":
        h = traft.WeightHead(((32, 3),), 5)
        for mod in h.net:
            if isinstance(mod, nn.Conv2d):
                layers.init_conv_(mod, torch.Generator().manual_seed(0))
    precision = case if case in ("highest", "default") else "bf16"
    grad = case == "grad"
    if grad:
        h = traft.WeightHead(traft.RaftConfig().weight_head_structure, 5)
        h.load_state_dict(head.state_dict())
    with torch.set_grad_enabled(grad), layers.precision_scope(precision):
        got = traft.weight_head_apply(h, cs, mr)
        want = _parent_head(h, cs, mr)
    if case == "bf16":
        assert calls == [(15, 324)]
        assert (got - want).abs().max() <= PLAIN_TOL * want.abs().max()
    else:
        assert calls == []
        assert torch.equal(got, want)
        assert got.requires_grad == grad


def test_weight_head_refuses_grad_and_cpu_launches(head):
    """``weight_head`` raises when autograd would record an input (J has no
    backward), on the CPU too; the launch wrapper takes CUDA tensors only."""
    corr, mean = _rows(3, seed=1)
    taps, consts = whead.head_params(head)
    with pytest.raises(RuntimeError, match="no backward"):
        whead.weight_head(corr.requires_grad_(), mean, taps, consts)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.weight_head(corr.detach(), mean, taps, consts)
