"""RAFT-small through the window steps against ``woft_tpu``'s on the CPU:
``build_window_track_step`` and the batched window step x2
(``MultiTargetTracker``, the JAX package's ``vmap`` of its window step).
The inputs and the tolerance are ``test_torch_small_steps.py``'s: one
seeded RAFT-small tree in both packages, the 96x128 walk, 64x64 windows,
the dense weight head (RAFT-small has no convex-upsampling mask), per-frame
H within 0.05 px at each target box's corners and equal ok flags. Kept
apart from the full-frame steps so the test workers run the two files'
JAX compiles side by side.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from test_torch_small_steps import (BOXES, CORNER_TOL, box_corners,
                                    box_masks, corner_err, rgb,
                                    small)  # noqa: F401  (fixture)

from woft_tpu.pipeline import MultiTargetTracker as JMulti
from woft_tpu.tracker import window_step as jws
from woft_tpu.tracker import woft as jw
from woft_tpu_torch.pipeline import MultiTargetTracker
from woft_tpu_torch.tracker import window_step as tws
from woft_tpu_torch.tracker import woft as tw

WINDOW = dict(size=64, margin=0.4, min_px=20)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs; the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def test_window_step_matches_jax(small):
    """The window step with ``redetection='never'``, so that every frame
    runs both flows on the dense head: the main one (its check, whose ok
    flag is then False) and the local fallback's between the previous and
    the current window, whose H the step returns. (The untrained network's
    flow passes its own check on this walk, so the default ladder would
    never reach the fallback; the batch below runs the main flow under
    the default parameters.) Ok flags, lost counts, search crops and H."""
    mask = box_masks()[0]
    tp, wp = tw.TrackerParams(redetection="never"), tws.WindowParams(**WINDOW)
    jtp = jw.TrackerParams(redetection="never")
    jwp = jws.WindowParams(**WINDOW)
    tstep = tws.build_window_track_step(small.tcfg, tp, wp)
    jstep = jws.build_window_track_step(small.jcfg, jtp, jwp)
    tstate = tws.window_init_state(small.model, small.tcfg, tp, wp,
                                   torch.from_numpy(rgb(small.template)),
                                   mask)
    jstate = jws.window_init_state(small.jp, small.jcfg, jtp, jwp,
                                   jnp.asarray(rgb(small.template)),
                                   jnp.asarray(mask))
    for f in small.frames:
        tstate, Ht, mt = tstep(small.model, tstate, torch.from_numpy(rgb(f)))
        jstate, Hj, mj = jstep(small.jp, jstate, jnp.asarray(rgb(f)))
        assert np.isfinite(Ht.numpy()).all()
        assert not mt["global_H_success"] and not mj["global_H_success"]
        assert mt["N_lost"] == int(mj["N_lost"])
        np.testing.assert_allclose(mt["h_crop"].numpy(),
                                   np.asarray(mj["h_crop"]),
                                   rtol=1e-4, atol=1e-4)
        assert corner_err(Ht.numpy(), np.asarray(Hj),
                          box_corners(BOXES[0])) < CORNER_TOL


def test_window_batch_matches_jax(small):
    """``MultiTargetTracker``, two targets: the port's batched window step
    (one B = 2 RAFT-small forward) against the JAX package's ``vmap``."""
    tracker = MultiTargetTracker(small.model, small.tcfg, tw.TrackerParams(),
                                 tws.WindowParams(**WINDOW), device="cpu")
    jtracker = JMulti(small.jp, small.jcfg, jw.TrackerParams(),
                      jws.WindowParams(**WINDOW))
    masks = box_masks()
    tracker.init(small.template, masks)
    jtracker.init(small.template, masks)
    for f in small.frames:
        hs, meta = tracker.track(f)
        jhs, jmeta = jtracker.track(f)
        assert hs.shape == (2, 3, 3) and np.isfinite(hs).all()
        np.testing.assert_array_equal(meta["global_H_success"],
                                      jmeta["global_H_success"])
        np.testing.assert_array_equal(meta["N_lost"], jmeta["N_lost"])
        np.testing.assert_allclose(meta["h_crop"], jmeta["h_crop"],
                                   rtol=1e-4, atol=1e-4)
        for k, box in enumerate(BOXES):
            assert corner_err(hs[k], jhs[k], box_corners(box)) < CORNER_TOL
