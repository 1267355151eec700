"""Kernel N's model side on the CPU: the sorted Sobol table that lets the
kernel skip the sort, the tile plan its wrapper hands the C entry, and
``ops/sampling.py:masked_sobol_gather``'s CPU route (its plain version).
The kernel itself is held to the plain version on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import pytest
import torch

from woft_tpu_torch.ops import kernels, sampling


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while the module runs (the suite's workers run
    side by side), the previous count restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _dups(targets):
    return torch.cat([torch.zeros_like(targets[:, :1], dtype=torch.bool),
                      targets[:, 1:] == targets[:, :-1]], dim=1)


@pytest.mark.parametrize("n", [100, 500, 1000])
def test_sorted_table_gives_the_sorted_targets(n):
    """x -> round(float32(n_valid * x)) is non-decreasing, so rounding the
    table sorted once (kernel N's) gives the plain version's sorted
    targets and duplicates, for every n_valid above n up to the 4K grid's
    8,294,400 slots (a stride, and the edges)."""
    table = torch.from_numpy(sampling.sobol_1d(n))
    sorted_table = sampling._sobol_sorted_on(n, torch.device("cpu"))
    edges = [n + 1, n + 2, 2 * n - 1, 2 * n, 2 * n + 1, 192 * 344, 288 * 384,
             921_600, 2_073_600, 8_294_399, 8_294_400]
    nv = torch.cat([torch.arange(n + 1, 8_294_401, 4099),
                    torch.tensor(edges)]).to(torch.float32)[:, None]
    want, _ = torch.sort(torch.round(nv * table), dim=1)
    got = torch.round(nv * sorted_table)
    assert torch.equal(got, want)
    assert torch.equal(_dups(got), _dups(want))
    assert _dups(want)[nv[:, 0] < 2 * n].any()    # rows that round to dups


@pytest.mark.parametrize("P", [1, 4095, 8192, 66_048, 921_600, 2_073_600,
                               8_294_400, 2 ** 27 + 1, 2 ** 31 - 1])
def test_sobol_select_plan(P):
    """The tiles cover the row with no empty tile, each a multiple of the
    4,096 bytes a count block reads a load, at most ``SOBOL_MAX_TILES``
    (the C entry's conditions)."""
    tile, tiles = kernels.sobol_select_plan(P)
    assert tile % 4096 == 0 and tile % kernels.SOBOL_TILE == 0
    assert 1 <= tiles <= kernels.SOBOL_MAX_TILES
    assert (tiles - 1) * tile < P <= tiles * tile


def _rows(P, counts, seed):
    """(len(counts), P) bool, row r with ``counts[r]`` valid slots at seeded
    places ('half': each slot with probability 1/2)."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.zeros(len(counts), P, dtype=torch.bool)
    for r, c in enumerate(counts):
        if c == "half":
            rows[r] = torch.rand(P, generator=g) < 0.5
        else:
            rows[r, torch.randperm(P, generator=g)[:c]] = True
    return rows


@pytest.mark.parametrize("P,counts,n", [
    (4000, [0, 1, 499, 500, 501, 1003, "half", 4000], 500),
    (66_048, ["half"] * 8, 500),
    (4000, [0, 199, 200, 201, 450, "half", 3999, 4000], 200),
], ids=["mixed", "window-batch", "n200"])
def test_cpu_gather_is_the_plain_version(P, counts, n):
    """On the CPU ``masked_sobol_gather`` returns its plain version's
    indices and flags at every slot (invalid ones included), for a batch
    of 8 rows and for one row alone, and launches nothing."""
    valid = _rows(P, counts, seed=P + n)
    before = kernels.masked_sobol_select.launches
    idx, sel = sampling.masked_sobol_gather(valid, n)
    want_idx, want_sel = sampling.masked_sobol_gather_plain(valid, n)
    assert idx.shape == sel.shape == (8, n)
    assert torch.equal(idx, want_idx) and torch.equal(sel, want_sel)
    idx1, sel1 = sampling.masked_sobol_gather(valid[3], n)
    assert torch.equal(idx1, want_idx[3]) and torch.equal(sel1, want_sel[3])
    assert kernels.masked_sobol_select.launches == before


def test_sobol_select_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match="CUDA"):
        kernels.masked_sobol_select(torch.ones(2, 64, dtype=torch.bool),
                                    torch.zeros(5))
