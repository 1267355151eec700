"""The reference network's pieces on small seeded inputs."""

import numpy as np
import pytest
import torch

from benchmark.harness import spec
from benchmark.reference import precision, raft, tracker

M = spec.Cell("woft-720p-online").config["model"]


@pytest.fixture(scope="module")
def net():
    state = torch.load(str(spec.ROOT / spec.Cell("woft-720p-online")
                           .config["weights"]), map_location="cpu",
                       weights_only=True)
    return raft.WeightedRaft(state, M, torch.device("cpu"))


def test_weight_head_in_chunks_equals_whole(net):
    g = torch.Generator().manual_seed(3)
    f1 = torch.randn(1, 256, 8, 16, generator=g)
    f2 = torch.randn(1, 256, 8, 16, generator=g)
    levels = net.pyramid(f1, f2)
    coords = torch.rand(128, 2, generator=g) * torch.tensor([15.0, 7.0])
    whole = net.weight_logits(levels, coords, chunk=4096)
    parts = net.weight_logits(levels, coords, chunk=7)
    torch.testing.assert_close(parts, whole, rtol=0, atol=1e-5)
    part = net.lookup(levels, coords[13:29], 13)
    torch.testing.assert_close(part, net.lookup(levels, coords)[13:29])


def test_lookup_window_order(net):
    """Channel i*k + j of a level samples (y + j - r, x + i - r)."""
    levels = [torch.arange(16 * 10 * 12, dtype=torch.float32).reshape(16, 10,
                                                                      12)]
    net1 = raft.WeightedRaft({}, {**M, "corr_levels": 1}, torch.device("cpu"))
    coords = torch.tensor([[5.0, 4.0]])
    out = net1.lookup(levels, coords).reshape(9, 9)
    r = 4
    for i in range(9):
        for j in range(9):
            y, x = 4 + j - r, 5 + i - r
            want = levels[0][0, y, x] if 0 <= y < 10 and 0 <= x < 12 else 0
            assert out[i, j] == want


def test_roundings():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -3.0e-3])
    t = precision.round_tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0 + 2.0 ** -9      # half to even
    assert abs(t[2] - x[2]) <= 2.0 ** -11 * 3.0e-3
    f = precision.round_fp8(torch.linspace(-2, 2, 101))
    assert f.abs().max() == 2.0 and len(f.unique()) < 101


def test_sobol_selection():
    valid = np.zeros(50, bool)
    valid[[3, 7, 8, 20, 41]] = True
    idx, keep = tracker.sobol_select(valid, 8)
    assert list(idx[keep]) == [3, 7, 8, 20, 41] and keep.sum() == 5
    many = np.ones(2000, bool)
    idx, keep = tracker.sobol_select(many, 500)
    assert keep.sum() <= 500 and np.all(np.diff(idx[keep]) > 0)
    assert list(tracker.sobol_1d(4)) == [0.0, 0.5, 0.75, 0.25]


def test_fit_recovers_a_homography():
    rng = np.random.default_rng(0)
    H = np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, -2.0], [1e-5, 2e-5, 1.0]])
    a = rng.uniform(0, 100, (200, 2))
    b = tracker.project(H, a)
    w = rng.uniform(0.2, 1.0, 200)
    np.testing.assert_allclose(tracker.fit_homography(a, b, w), H, rtol=1e-6,
                               atol=1e-9)
    ok, frac = tracker.inlier_check(H, a, b, np.ones(200, bool), 5.0, 0.2)
    assert ok and frac == 1.0
