"""The traffic generator: the seed draws the texture and nothing else, and
the target stays in the frame over the whole walk."""

import numpy as np
import pytest
import torch

from benchmark.harness import spec, traffic as tf

from .conftest import TINY_TRAFFIC

SPEC = spec.Cell("woft-720p-online").traffic


def test_far_pose_keeps_the_target_in_the_frame():
    h, w = SPEC["height"], SPEC["width"]
    _, corners = tf.target(h, w, SPEC["target_frac"])
    far = tf.pose(SPEC["poses"], SPEC["step"], h, w)
    p = far @ np.vstack([corners.T, np.ones(4)])
    p = (p[:2] / p[2:]).T
    assert (p >= 0).all() and (p[:, 0] < w).all() and (p[:, 1] < h).all()
    # about 7 degrees, 1.13x, (64, -48) px
    assert np.degrees(SPEC["poses"] * SPEC["step"]["theta"]) == \
        pytest.approx(7.33, abs=0.01)


def test_pingpong_order():
    assert tf.schedule(4, "pingpong") == [1, 2, 3, 4, 3, 2]


def test_seed_draws_the_texture_only():
    a = tf.Traffic(TINY_TRAFFIC, 2**31 + 5, torch.device("cpu"))
    b = tf.Traffic(TINY_TRAFFIC, 2**31 + 5, torch.device("cpu"))
    c = tf.Traffic(TINY_TRAFFIC, 6, torch.device("cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a.frames, b.frames))
    assert not np.array_equal(a.template, c.template)
    assert a.order == c.order and len(a.frames) == len(c.frames)
    assert all(np.array_equal(p, q) for p, q in zip(a.poses, c.poses))
    assert a.frames[0].dtype == np.uint8 and a.frames[0].shape == (64, 96, 3)
