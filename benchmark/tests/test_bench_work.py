"""The operation and byte counts against hand counts at 1280x720."""

import pytest

from benchmark.harness import spec, work

M = spec.Cell("woft-720p-online").config["model"]
H, W = 720, 1280


def test_encoder():
    stem = 2 * 3 * 64 * 49 * 360 * 640
    layer1 = 4 * 2 * 64 * 64 * 9 * 360 * 640
    layer2 = (2 * 64 * 96 * 9 + 3 * 2 * 96 * 96 * 9 + 2 * 64 * 96) * 180 * 320
    layer3 = (2 * 96 * 128 * 9 + 3 * 2 * 128 * 128 * 9
              + 2 * 96 * 128) * 90 * 160
    out = 2 * 128 * 256 * 90 * 160
    assert work.encoder_flops(H, W, 256) == stem + layer1 + layer2 + layer3 \
        + out == 125_249_126_400


def test_update_iteration_and_heads():
    # convc1, convc2, convf1, convf2, conv; 2 x (z, r, q) 1x5 / 5x1 over
    # [hidden 128, context 128, motion 128]; flow head
    per_cell = (2 * 324 * 256 + 2 * 256 * 192 * 9 + 2 * 2 * 128 * 49
                + 2 * 128 * 64 * 9 + 2 * 256 * 126 * 9
                + 6 * 2 * 384 * 128 * 5
                + 2 * 128 * 256 * 9 + 2 * 256 * 2 * 9)
    assert work.update_flops_per_cell(M) == per_cell == 5_351_936
    # 9x9 patch of 5 channels -> 128 -> 128 -> 128 -> 1
    head = 81 * (2 * 5 * 128 * 9 + 2 * 2 * 128 * 128 * 9 + 2 * 128)
    assert work.weight_head_flops_per_cell(M) == head == 48_729_600


def test_volumes():
    cells = 90 * 160 + 45 * 80 + 22 * 40 + 11 * 20
    assert work.dense_volume_flops(M, H, W) == 2 * 14400 * cells * 256
    # 120 blocks of 128 queries, 3200 + 1200 + 704 + 672 stored positions
    # (tests/test_torch_local_corr.py:test_layout_720p)
    nb, bq, wins = work.local_layout(M, H, W, 16)
    assert (nb, bq) == (120, 128)
    assert wins == [(50, 64), (30, 40), (22, 32), (21, 32)]
    assert work.local_volume_flops(M, H, W, 16) == 45_424_312_320
    feats = 14400 + 14400 + 3600 + 880 + 220
    assert work.local_volume_bytes(M, H, W, 16) == \
        2 * feats * 256 + 177_438_720


def test_lookup_bytes():
    h1, w1, _ = work.grid(H, W)
    # an interior cell: a 10 x 10 window on every level, float32
    assert work.window_bytes(M, h1, w1, 80, 45) == 4 * 100 * 4
    # the corner cell: 6 x 6 on every level
    assert work.window_bytes(M, h1, w1, 0, 0) == 4 * 36 * 4
    dense = work.dense_lookup_bytes(M, H, W)
    assert 14400 * (8 + 4 * 324) < dense < 14400 * (8 + 4 * 324 + 1600)


def test_frame_flops_and_bound():
    t = work.frame_flops(M, "dense", H, W, 16, 500, True)
    assert set(t) == {"encoders", "volume", "iterations", "weight_head",
                      "fit"}
    assert t["weight_head"] == 4500 * 48_729_600
    assert 1.35e12 < sum(t.values()) < 1.5e12
    fb = work.frame_flops(M, "dense", H, W, 16, 500, True, fallback=True)
    assert sum(fb.values()) > 2 * sum(t.values())
    assert work.bound_s(3.35e9, 67e9, 67e12) == pytest.approx(1e-3)
    assert work.bound_s(3.35e6, 67e12, 67e12) == pytest.approx(1.0)
