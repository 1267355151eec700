"""The trained weights carried to the port: ``weights/wraft_tpu_v3_torch.pt``,
``weights/wraft_tpu_v4_torch.pt`` and ``weights/wraft_tpu_v5_torch.pt``
against the JAX package's orbax checkpoints they were exported from
(``tools/export_torch_weights.py``).

Tolerances: the files equal a fresh export bit for bit; the forward on the
exported v4 weights equals the JAX forward on the orbax tree to 1e-3 px of
flow and 1e-4 of weight logits, as ``test_torch_raft.py`` holds seeded
weights.
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.models import raft as jraft
from woft_tpu.models.checkpoint import load_checkpoint
from woft_tpu_torch.config import load_config
from woft_tpu_torch.flow import RaftFlow
from woft_tpu_torch.models import raft as traft

ROOT = Path(__file__).resolve().parent.parent
WEIGHTS = ROOT / "weights"
VERSIONS = ["v3", "v4", "v5"]
FLOW_TOL = 1e-3
W_TOL = 1e-4


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", ROOT / "tools" / "export_torch_weights.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _committed(version):
    return torch.load(WEIGHTS / f"wraft_tpu_{version}_torch.pt",
                      map_location="cpu", weights_only=True)


@pytest.mark.parametrize("version", VERSIONS)
def test_committed_file_equals_a_fresh_export(version):
    """Each ``.pt`` holds exactly what the tool makes of its orbax
    checkpoint today: the same keys, dtypes and bits."""
    fresh = _export_tool().export_state_dict(f"wraft_tpu_{version}")
    got = _committed(version)
    assert list(got) == list(fresh)
    for key, value in fresh.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
    assert {v.dtype for v in got.values()} == {torch.float32, torch.int64}


@pytest.mark.parametrize("version", VERSIONS)
def test_committed_file_strict_loads(version):
    """Strict-loads into ``WeightedRAFT`` (the float32 parameters, the
    BatchNorm counters and the shortcut-norm aliases) and holds the
    checkpoint's 5,561,601 trained values (the aliases repeat 896)."""
    model = traft.WeightedRAFT(traft.RaftConfig())
    state = _committed(version)
    model.load_state_dict(state, strict=True)
    n = sum(v.numel() for v in state.values() if v.is_floating_point())
    assert n == 5_561_601 + 896
    assert all(torch.isfinite(v).all() for v in state.values()
               if v.is_floating_point())


def test_v4_forward_matches_jax_on_the_orbax_tree():
    """The port's forward on the exported v4 weights against the JAX
    forward on the orbax checkpoint itself, 64x96, 3 iterations."""
    jp = load_checkpoint(str(WEIGHTS / "wraft_tpu_v4"))
    jcfg = jraft.RaftConfig(variant="weighted", iters=3)
    tcfg = traft.RaftConfig(iters=3)
    model = traft.WeightedRAFT(tcfg)
    model.load_state_dict(_committed("v4"), strict=True)
    model.eval()

    rng = np.random.default_rng(0)
    img1 = rng.uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2))
    # jitted: one compile instead of an eager trace of every op (~10 s)
    oj = jax.jit(lambda p, a, b: jraft.weighted_raft_forward(p, jcfg, a, b))(
        jp, jnp.asarray(img1), jnp.asarray(img2))
    ot = traft.weighted_raft_forward(model, tcfg, torch.from_numpy(img1),
                                     torch.from_numpy(img2))
    for key, tol in (("flow", FLOW_TOL), ("flow_up", FLOW_TOL),
                     ("weights", W_TOL), ("weights_up", W_TOL)):
        np.testing.assert_allclose(ot[key].numpy(), np.asarray(oj[key]),
                                   atol=tol, rtol=0, err_msg=key)
    # trained weights move the flow: the roll of (3, 2) px is found
    assert np.abs(np.asarray(oj["flow_up"])[0, 16:48, 24:72]
                  - [3.0, 2.0]).mean() < 0.5


@pytest.mark.parametrize("config,version", [
    ("WOFT.py", "v4"), ("WOFT_fast.py", "v4"), ("WOFT_window.py", "v5"),
    ("WOFT_window_384.py", "v5"), ("WOFT_window_native.py", "v5")])
def test_configs_resolve_the_trained_weights(config, version, monkeypatch,
                                             tmp_path):
    """Full-frame configs take v4, window configs v5 (the reference's
    preference), and ``WOFT_WRAFT_TORCH_CKPT`` overrides both; a missing
    override falls through to the full-frame file, as in the reference."""
    path = ROOT / "woft_tpu_torch" / "configs" / config
    monkeypatch.delenv("WOFT_WRAFT_TORCH_CKPT", raising=False)
    assert Path(load_config(path).flow_config.model) == \
        WEIGHTS / f"wraft_tpu_{version}_torch.pt"
    other = tmp_path / "other.pt"
    other.write_bytes(b"")
    monkeypatch.setenv("WOFT_WRAFT_TORCH_CKPT", str(other))
    assert Path(load_config(path).flow_config.model) == other
    monkeypatch.setenv("WOFT_WRAFT_TORCH_CKPT", str(tmp_path / "missing.pt"))
    assert Path(load_config(path).flow_config.model) == \
        WEIGHTS / "wraft_tpu_v4_torch.pt"


def test_raft_flow_loads_the_trained_weights(monkeypatch):
    """``RaftFlow`` under the canonical flow config loads v4 bit for bit."""
    monkeypatch.delenv("WOFT_WRAFT_TORCH_CKPT", raising=False)
    conf = load_config(ROOT / "woft_tpu_torch" / "configs" / "flow"
                       / "wraft_large.py")
    flower = RaftFlow(conf, device="cpu")
    for key, value in _committed("v4").items():
        assert torch.equal(flower.model.state_dict()[key], value), key
