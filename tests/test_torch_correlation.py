"""The forward's correlation seam (``woft_tpu_torch/models/corr.py``:
``make_correlation`` and its kinds) on the CPU: the factory picks the kind
``RaftConfig`` and the batch size call for, and the sparse weight head's
rows (``rows_at(coords)(cells)``) equal the natural lookup's rows at those
cells."""

import pytest
import torch

from woft_tpu_torch.models import corr
from woft_tpu_torch.models.raft import RaftConfig

H1, W1, D = 16, 32, 32

KIND_CASES = {
    # name: (config overrides, frame pairs, expected kind, volume dtype)
    "dense-f32": (dict(), 1, corr.DenseCorr, torch.float32),
    "dense-bf16": (dict(precision="bf16"), 1, corr.DenseCorr,
                   torch.bfloat16),
    "local": (dict(corr_impl="local"), 1, corr.BlockLocalCorr,
              torch.float32),
    "local-batch-2": (dict(corr_impl="local"), 2, corr.DenseCorr,
                      torch.float32),
    "alternate": (dict(alternate_corr=True, corr_impl="local", alt_chunk=64),
                  2, corr.AlternateCorr, torch.float32),
}


def _volume_dtype(c):
    vol = c.volume
    if isinstance(vol, corr.LocalCorrVolumes):
        return vol.volumes[0].dtype
    return vol[0].dtype


@pytest.mark.parametrize("case", list(KIND_CASES))
def test_factory_kind_and_sparse_rows(case):
    overrides, B, kind, dtype = KIND_CASES[case]
    cfg = RaftConfig(**overrides)
    g = torch.Generator().manual_seed(4)
    f1, f2 = (torch.randn(B, H1, W1, D, generator=g) for _ in range(2))
    grid = torch.stack(torch.meshgrid(torch.arange(float(W1)),
                                      torch.arange(float(H1)),
                                      indexing="xy"), -1)
    coords = (grid + 3 * torch.randn(B, H1, W1, 2, generator=g)).contiguous()
    c = corr.make_correlation(cfg, B)
    assert type(c) is kind
    assert c.graphable == (kind is corr.BlockLocalCorr)
    volume, mean = c.build(f1, f2)
    assert volume is c.volume and _volume_dtype(c) == dtype
    assert torch.equal(mean, corr.corr_mean_response(f1, f2))
    natural = c.lookup_natural(coords)
    C = cfg.corr_levels * (2 * cfg.radius + 1) ** 2
    assert natural.shape == (B, H1, W1, C)
    assert natural.abs().max().item() > 0
    # cells of every batch element, in no order, one of them twice
    cells = torch.randperm(B * H1 * W1, generator=g)[:40]
    cells = torch.cat([cells, cells[:1]])
    got = c.rows_at(coords)(cells)
    assert got.shape == (cells.shape[0], C)
    assert torch.equal(got, natural.reshape(B * H1 * W1, C)[cells])
