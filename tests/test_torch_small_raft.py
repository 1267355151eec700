"""RAFT-small (``RaftConfig(small=True)``: bottleneck encoders, the small
motion encoder, the 3x3 ConvGRU, the bilinear ``upflow8`` output) against
``woft_tpu``'s on the CPU: one seeded JAX parameter tree carried across by
``params_from_jax_numpy``, seeded numpy frames of 64x96.

Tolerances: flow 1e-3 px, weight logits and the mean response 1e-4, as for
RAFT-large (``test_torch_raft.py``: float32 convolutions in two libraries
over the refinement iterations).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from woft_tpu.models import raft as jraft
from woft_tpu_torch.models import raft as traft
from woft_tpu_torch.models.convert import params_from_jax_numpy

ITERS = 3
FLOW_TOL = 1e-3
LOGIT_TOL = 1e-4
HEAD = ((32, 3),)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs; the count restored."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant,batch", [("orig", 1), ("weighted", 2)])
def test_small_forward_matches_jax(variant, batch):
    kw = dict(small=True, variant=variant, iters=ITERS,
              weight_head_structure=HEAD)
    jcfg, tcfg = jraft.RaftConfig(**kw), traft.RaftConfig(**kw)
    assert (tcfg.radius, tcfg.hidden_dim, tcfg.context_dim,
            tcfg.fnet_dim) == (jcfg.radius, jcfg.hidden_dim,
                               jcfg.context_dim, jcfg.fnet_dim) == (
        3, 96, 64, 128)
    params = jraft.init_raft_params(jax.random.PRNGKey(1), jcfg)
    model = traft.WeightedRAFT(tcfg).eval()
    model.load_state_dict(params_from_jax_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    rng = np.random.default_rng(2)
    img1 = rng.uniform(0, 255, (batch, 64, 96, 3)).astype(np.float32)
    img2 = np.roll(img1, (2, 3), axis=(1, 2))
    want = jax.jit(lambda p, a, b: jraft.weighted_raft_forward(
        p, jcfg, a, b))(params, jnp.asarray(img1), jnp.asarray(img2))
    got = traft.weighted_raft_forward(model, tcfg, torch.from_numpy(img1),
                                      torch.from_numpy(img2))
    for key in ("flow", "flow_up"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=FLOW_TOL, rtol=0, err_msg=key)
    if variant == "weighted":
        for key in ("weights", "weights_up", "mean_response"):
            np.testing.assert_allclose(got[key].numpy(),
                                       np.asarray(want[key]),
                                       atol=LOGIT_TOL, rtol=0, err_msg=key)
    else:
        assert "weights" not in got


def test_small_rejects_the_sparse_head():
    """RAFT-small has no convex-upsampling mask, which the sparse weight
    head's outputs carry (the JAX package asserts the same)."""
    cfg = traft.RaftConfig(small=True, iters=1, weight_head_structure=HEAD)
    model = traft.init_raft_params(cfg)
    img = torch.zeros(1, 32, 48, 3)
    with pytest.raises(ValueError, match="sparse weight head"):
        traft.weighted_raft_forward(model, cfg, img, img,
                                    sparse_weight_head=True)
