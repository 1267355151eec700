"""``train_wraft_torch.py`` on the CPU (``--device cpu``) with the argv of
the JAX trainer's own CLI test: multi-scale ``--size``/``--batch`` lists,
RAFT-small, ``--train-flow``, validation and a rolling checkpoint. The
final checkpoint is a torch state dict that the port's ``RaftFlow`` loads
and that ``woft_tpu``'s ``load_torch_checkpoint`` reads into the same tree
as ``params_to_jax_numpy`` makes, with the same forward on both sides
(flow 1e-3 px, weight logits 1e-4, as in ``test_torch_small_raft.py``).
``--dp 2`` on two CPU ranks against ``--dp 1``."""

import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import train_wraft_torch
from woft_tpu.models import raft as jraft
from woft_tpu.models.convert import load_torch_checkpoint
from woft_tpu_torch.config import Config
from woft_tpu_torch.flow.wrapper import RaftFlow
from woft_tpu_torch.models.convert import params_to_jax_numpy


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs; the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _images(directory):
    import cv2
    directory.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(directory / f"{i}.jpg"),
                    rng.integers(0, 255, (80, 112, 3), dtype=np.uint8))


def test_train_cli_multiscale_and_checkpoint(tmp_path, monkeypatch):
    _images(tmp_path / "imgs")
    out = tmp_path / "ckpt.pt"
    monkeypatch.setattr(sys, "argv", [
        "train_wraft_torch.py", "--images", str(tmp_path / "imgs"),
        "--size", "32x32,32x48", "--batch", "2,1",
        "--steps", "3", "--iters", "1", "--small",
        "--log-every", "1", "--val-every", "2", "--ckpt-every", "2",
        "--lr", "1e-4", "--train-flow", "--out", str(out),
        "--device", "cpu"])
    assert train_wraft_torch.main() == 0
    assert out.exists()

    # the port's flow wrapper serves it
    flow = Config()
    flow.raft_type = "weighted"
    flow.class_params = Config()
    flow.class_params.small = True
    flow.class_params.weight_head_structure = [(32, 3)]
    flow.iters = 2
    flow.model = str(out)
    raft = RaftFlow(flow, device="cpu")
    state = torch.load(str(out), weights_only=True)
    assert all(torch.equal(raft.model.state_dict()[k], v)
               for k, v in state.items())

    # the JAX package reads the same file into the bridge's tree
    jtree = load_torch_checkpoint(str(out))
    ptree = params_to_jax_numpy(state)
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    pl = dict(jax.tree_util.tree_leaves_with_path(ptree))
    assert len(jl) == len(pl)
    for path, leaf in jl:
        np.testing.assert_array_equal(np.asarray(leaf), pl[path])

    jcfg = jraft.RaftConfig(small=True, iters=2,
                            weight_head_structure=((32, 3),))
    rng = np.random.default_rng(1)
    img1 = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    img2 = np.roll(img1, (1, 2), axis=(1, 2))
    want = jax.jit(lambda p, a, b: jraft.weighted_raft_forward(
        p, jcfg, a, b))(jax.tree_util.tree_map(jnp.asarray, jtree),
                        jnp.asarray(img1), jnp.asarray(img2))
    got_flow, got_w, _ = raft.compute_flow_device(torch.from_numpy(img1),
                                                  torch.from_numpy(img2))
    np.testing.assert_allclose(got_flow.numpy(), np.asarray(want["flow_up"]),
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want["weights_up"]),
                               atol=1e-4, rtol=0)


def test_init_takes_a_state_dict_only(tmp_path):
    """``--init`` reads torch state dicts; an orbax directory raises,
    naming the one tool that reads orbax."""
    with pytest.raises(ValueError, match="export_torch_weights"):
        train_wraft_torch.load_init(None, tmp_path)


def _dp_argv(tmp_path, dp, out):
    return ["--images", str(tmp_path / "imgs"), "--size", "32x64",
            "--batch", "4", "--steps", "2", "--iters", "1", "--small",
            "--log-every", "1", "--out", str(out), "--device", "cpu",
            "--dp", str(dp)]


def test_dp_two_ranks_equal_one(tmp_path, monkeypatch):
    """``--dp 2 --device cpu`` (two spawned ``gloo`` ranks, a global batch
    of 4) trains as ``--dp 1`` does: the same losses a step to 1e-6
    relative and frozen tensors bit-identical. AdamW moves a parameter by
    ``lr * g / (|g| + 1e-8)`` a step, so where a gradient is within a few
    of its eps of zero the float32 rounding of the two ranks' gradient sum
    moves the step by up to ``2 lr`` (a flipped sign): those entries (a
    gradient of 1e-5 or less at either step) are held to ``4 lr`` over the
    two steps, and the others, whose second step sees the first's
    differences, to 1e-4 of the tensor's largest magnitude (measured 1.3e-5
    on the weight head's last bias)."""
    from woft_tpu_torch.training import train as ttrain
    _images(tmp_path / "imgs")
    seen = []
    update = ttrain.AdamW.update

    def recording(self, grads, state, loss=None):
        seen.append({n: g.detach().clone() for n, g in zip(self.names,
                                                             grads)})
        return update(self, grads, state, loss)

    monkeypatch.setattr(ttrain.AdamW, "update", recording)
    one = train_wraft_torch.run(train_wraft_torch.parse_args(
        _dp_argv(tmp_path, 1, tmp_path / "dp1.pt")))
    monkeypatch.setattr(ttrain.AdamW, "update", update)
    two = train_wraft_torch.run_dp(train_wraft_torch.parse_args(
        _dp_argv(tmp_path, 2, tmp_path / "dp2.pt")))
    assert two["rc"] == 0 and len(two["losses"]) == 2
    for a, b in zip(two["losses"], one["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b), (a, b)
    want = torch.load(str(tmp_path / "dp1.pt"), weights_only=True)
    got = torch.load(str(tmp_path / "dp2.pt"), weights_only=True)
    lr = train_wraft_torch.parse_args(_dp_argv(tmp_path, 1, "x")).lr
    assert len(seen) == 2
    for k, v in want.items():
        if k not in seen[0]:
            assert torch.equal(got[k], v), k
            continue
        err = (got[k] - v).abs()
        sure = (seen[0][k].abs() > 1e-5) & (seen[1][k].abs() > 1e-5)
        assert err[sure].max() <= 1e-4 * v.abs().max(), k
        assert err.max() <= 4 * lr, k


def test_dp_beyond_the_visible_gpus_raises(tmp_path):
    """``--dp`` on the card needs one GPU a rank: with more ranks than GPUs
    the run raises, naming both numbers, and never falls back to sharing
    a card or to the CPU."""
    args = train_wraft_torch.parse_args(
        _dp_argv(tmp_path, 1, tmp_path / "x.pt")[:-4])
    args.dp = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match=f"--dp {args.dp} needs {args.dp} "
                       f"GPUs, {torch.cuda.device_count()} visible"):
        train_wraft_torch.run_dp(args)
