"""Which weight head each tracker step asks for, against ``woft_tpu``, over
the whole grid of settings that decide it: ``variant`` ('orig',
'weighted', 'weighted_masked') x ``small`` x ``sparse_weights`` x
``padding_mode`` ('nopad', 'RAFT') x a ``flow_fn`` given or not.

Each step's first flow is a spy that records whether the sparse weight
head was asked for (``sparse_weight_head=True``; a ``flow_fn`` asks for no
head) and stops the step there. The JAX step is traced by
``jax.eval_shape`` up to that point, so nothing compiles. Covered: the
single full-frame step, the shared-flow multi-target step, the window
step, and the port's batched window step (whose JAX twin is the window
step under ``vmap``).

The reference refuses none of the grid's combinations at these gates, so
none is left out. What it refuses elsewhere is outside the grid: the
sparse head on RAFT-small inside the forward
(``test_torch_small_raft.py::test_small_rejects_the_sparse_head``), the
shared step without ``no_local_h`` or ``redetection='always'`` (both
shared steps here run with ``no_local_h``), and the batched window step
with ``corr_impl='local'`` (the grid runs the dense correlation).
"""

import itertools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.models import raft as jraft
from woft_tpu.tracker import window_step as jws
from woft_tpu.tracker import woft as jw
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.tracker import window_step as tws
from woft_tpu_torch.tracker import woft as tw

H_IMG, W_IMG = 64, 96
WINDOW = dict(size=64, margin=0.4, min_px=20)
STEPS = ("single", "shared", "window", "window_batch")
NETWORKS = list(itertools.product(("orig", "weighted", "weighted_masked"),
                                  (False, True)))
SETTINGS = list(itertools.product((True, False), ("nopad", "RAFT"),
                                  (False, True)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs; the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class _Asked(Exception):
    """Raised by a spy at a step's first flow: whether the step asked for
    the sparse weight head there."""

    def __init__(self, sparse):
        super().__init__(sparse)
        self.sparse = sparse


def _spy_forward(*args, sparse_weight_head=False, **kwargs):
    raise _Asked(bool(sparse_weight_head))


def _spy_flow_fn(*args, **kwargs):
    raise _Asked(False)


def _asked(call):
    with pytest.raises(_Asked) as info:
        call()
    return info.value.sparse


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 255, (1, H_IMG, W_IMG, 3)).astype(np.float32)
    masks = np.zeros((2, H_IMG, W_IMG), bool)
    masks[0, 16:48, 24:72] = True
    masks[1, 8:40, 40:88] = True
    return frame, masks


def _jax_asks(step, jcfg, setting, frame, masks):
    """Trace the JAX step (no compile) to its first flow."""
    frame, mask = jnp.asarray(frame), jnp.asarray(masks[0])
    flow_fn = _spy_flow_fn if setting.flow_fn else None
    tp = jw.TrackerParams(sparse_weights=setting.sparse_weights,
                          padding_mode=setting.padding_mode,
                          no_local_h=step != "single")
    if step in ("single", "shared"):
        state = jw.tracker_init_state({}, jcfg, tp, frame, mask,
                                      encode=False)
        if step == "single":
            fn = jw.build_track_step(jcfg, tp, flow_fn=flow_fn)._raw_step
            return _asked(lambda: jax.eval_shape(fn, {}, state, frame))
        fn = jw.build_shared_multi_step(jcfg, tp, flow_fn=flow_fn)._raw_step
        args = ({}, state, jnp.asarray(masks).reshape(2, -1),
                jnp.broadcast_to(jnp.eye(3), (2, 3, 3)), frame)
        return _asked(lambda: jax.eval_shape(fn, *args))
    wp = jws.WindowParams(**WINDOW)
    state = jws.window_init_state({}, jcfg, tp, wp, frame, mask,
                                  encode=False)
    fn = jws.build_window_track_step(jcfg, tp, wp, flow_fn=flow_fn)._raw_step
    if step == "window_batch":
        states = jax.tree.map(lambda *xs: jnp.stack(xs), state, state)
        return _asked(lambda: jax.eval_shape(
            jax.vmap(lambda s: fn({}, s, frame)), states))
    return _asked(lambda: jax.eval_shape(fn, {}, state, frame))


def _port_asks(step, tcfg, setting, frame, masks):
    """Run the port's step on the CPU to its first flow."""
    frame, mask = torch.from_numpy(frame), torch.from_numpy(masks[0])
    flow_fn = _spy_flow_fn if setting.flow_fn else None
    tp = tw.TrackerParams(sparse_weights=setting.sparse_weights,
                          padding_mode=setting.padding_mode,
                          no_local_h=step != "single")
    if step in ("single", "shared"):
        state = tw.tracker_init_state(None, tcfg, tp, frame, mask,
                                      encode=False)
        if step == "single":
            fn = tw.build_track_step(tcfg, tp, flow_fn=flow_fn)
            return _asked(lambda: fn(None, state, frame))
        fn = tw.build_shared_multi_step(tcfg, tp, flow_fn=flow_fn)
        return _asked(lambda: fn(None, state, torch.from_numpy(masks),
                                 torch.eye(3).expand(2, 3, 3), frame))
    wp = tws.WindowParams(**WINDOW)
    state = tws.window_init_state(None, tcfg, tp, wp, frame, mask,
                                  encode=False)
    if step == "window_batch":
        fn = tws.build_window_batch_step(tcfg, tp, wp, flow_fn=flow_fn)
        states = tws.stack_window_states([state, state])
        return _asked(lambda: fn(None, states, frame))
    fn = tws.build_window_track_step(tcfg, tp, wp, flow_fn=flow_fn)
    return _asked(lambda: fn(None, state, frame))


class _Setting:
    def __init__(self, sparse_weights, padding_mode, flow_fn):
        self.sparse_weights = sparse_weights
        self.padding_mode = padding_mode
        self.flow_fn = flow_fn

    def __repr__(self):
        return (f"sparse_weights={self.sparse_weights}, "
                f"padding_mode={self.padding_mode!r}, "
                f"flow_fn={'given' if self.flow_fn else 'none'}")


@pytest.mark.parametrize("variant,small", NETWORKS,
                         ids=[f"{v}-{'small' if s else 'large'}"
                              for v, s in NETWORKS])
@pytest.mark.parametrize("step", STEPS)
def test_step_asks_for_the_head_woft_tpu_asks_for(monkeypatch, inputs,
                                                   step, variant, small):
    """Over the 8 settings of each network, the port's step asks for the
    sparse weight head exactly where ``woft_tpu``'s does."""
    monkeypatch.setattr(jw, "weighted_raft_forward", _spy_forward)
    monkeypatch.setattr(jws, "weighted_raft_forward", _spy_forward)
    monkeypatch.setattr(tw, "weighted_raft_forward", _spy_forward)
    monkeypatch.setattr(tws, "weighted_raft_forward", _spy_forward)
    kw = dict(variant=variant, small=small, iters=1)
    jcfg, tcfg = jraft.RaftConfig(**kw), traft.RaftConfig(**kw)
    frame, masks = inputs
    differ, wanted = [], set()
    for setting in itertools.starmap(_Setting, SETTINGS):
        want = _jax_asks(step, jcfg, setting, frame, masks)
        got = _port_asks(step, tcfg, setting, frame, masks)
        wanted.add(want)
        if got != want:
            differ.append((setting, f"port {got}, woft_tpu {want}"))
    assert not differ, f"{step} step: {differ}"
    # the spies see both answers: RAFT-large 'weighted' takes each head
    if (variant, small) == ("weighted", False):
        assert wanted == {True, False}
