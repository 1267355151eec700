"""The port's numpy copies of the training data machinery
(``woft_tpu_torch/training/datasets.py``, ``augment.py`` and
``utils/flow_formats.py``) against ``woft_tpu``'s on the fabricated
directory trees of ``tests/test_datasets.py``: the same layouts, the same
items, the same augmented outputs from the same seeds (exactly: the same
numpy and OpenCV calls)."""

import numpy as np
import pytest
from test_datasets import H, W, _flow, trees  # noqa: F401

from woft_tpu.training import augment as jaug
from woft_tpu.training import datasets as jds
from woft_tpu.utils import flow_formats as jff
from woft_tpu_torch.training import augment as taug
from woft_tpu_torch.training import datasets as tds
from woft_tpu_torch.utils import flow_formats as tff


def _roots(trees):  # noqa: F811
    return {"sintel": str(trees / "Sintel"),
            "things": str(trees / "FlyingThings3D"),
            "kitti": str(trees / "KITTI"),
            "hd1k": str(trees / "HD1k"),
            "chairs": str(trees / "FlyingChairs_release/data")}


def _same_item(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("name", ["MpiSintel", "FlyingChairs",
                                  "FlyingThings3D", "KITTI", "HD1K"])
def test_layouts_and_items_match(trees, name):  # noqa: F811
    roots = _roots(trees)
    root = {"MpiSintel": roots["sintel"], "FlyingChairs": roots["chairs"],
            "FlyingThings3D": roots["things"], "KITTI": roots["kitti"],
            "HD1K": roots["hd1k"]}[name]
    j, t = getattr(jds, name)(root=root), getattr(tds, name)(root=root)
    assert len(t) == len(j) > 0
    assert t.image_list == j.image_list and t.flow_list == j.flow_list
    for i in (0, len(j) - 1):
        _same_item(t[i], j[i])


def test_stage_mix_and_batches_match(trees):  # noqa: F811
    roots = _roots(trees)
    for stage in ("chairs", "things", "sintel", "kitti"):
        jd, _ = jds.fetch_dataloader(stage, (32, 48), 2, roots=roots)
        td, _ = tds.fetch_dataloader(stage, (32, 48), 2, roots=roots)
        assert len(td) == len(jd)
    j = jds.MpiSintel(root=roots["sintel"]) + jds.KITTI(root=roots["kitti"])
    t = tds.MpiSintel(root=roots["sintel"]) + tds.KITTI(root=roots["kitti"])
    jb = next(jds.batch_iterator(j, 2, rng=np.random.default_rng(4)))
    tb = next(tds.batch_iterator(t, 2, rng=np.random.default_rng(4)))
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_augmentors_match_on_the_same_seed(trees):  # noqa: F811
    item = jds.FlyingChairs(root=_roots(trees)["chairs"])[0]
    img1, img2, flow, _ = item
    for seed in range(3):
        kw = dict(crop_size=(24, 32), min_scale=-0.2, max_scale=0.4)
        a = taug.FlowAugmentor(**kw)(img1, img2, flow,
                                     rng=np.random.default_rng(seed))
        b = jaug.FlowAugmentor(**kw)(img1, img2, flow,
                                     rng=np.random.default_rng(seed))
        _same_item(a, b)
    kitti = jds.KITTI(root=_roots(trees)["kitti"])[0]
    for seed in range(3):
        kw = dict(crop_size=(24, 32), min_scale=-0.2, max_scale=0.4)
        a = taug.SparseFlowAugmentor(**kw)(*kitti,
                                           rng=np.random.default_rng(seed))
        b = jaug.SparseFlowAugmentor(**kw)(*kitti,
                                           rng=np.random.default_rng(seed))
        _same_item(a, b)
    valid = np.zeros((H, W), np.float32)
    valid[5:30, 7:40] = 1
    _same_item(taug.resize_sparse_flow_map(_flow(), valid, 1.5, 0.75),
               jaug.resize_sparse_flow_map(_flow(), valid, 1.5, 0.75))


def test_flow_formats_round_trip_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    flow = rng.normal(size=(H, W, 2)).astype(np.float32) * 10
    tff.write_flo(tmp_path / "a.flo", flow)
    np.testing.assert_array_equal(jff.read_flo(tmp_path / "a.flo"), flow)
    img = rng.normal(size=(H, W, 3)).astype(np.float32)
    jff.write_pfm(tmp_path / "a.pfm", img)
    np.testing.assert_array_equal(tff.read_pfm(tmp_path / "a.pfm"), img)
    tff.write_kitti_flow(tmp_path / "a.png", flow)
    _same_item(tff.read_kitti_flow(tmp_path / "a.png"),
               jff.read_kitti_flow(tmp_path / "a.png"))
    for name in ("a.flo", "a.pfm", "a.png"):
        np.testing.assert_array_equal(tff.read_gen(tmp_path / name),
                                      jff.read_gen(tmp_path / name))
