"""The PyTorch port's boundaries: what it imports, where it runs, and how
its kernel wrappers dispatch."""

import ast
import inspect
from pathlib import Path

import pytest
import torch

from woft_tpu_torch.config import load_config
from woft_tpu_torch.flow.wrapper import RaftFlow
from woft_tpu_torch.models import corr
from woft_tpu_torch.ops import kernels, warp
from woft_tpu_torch.tracker import WOFTTracker, WOFTWindowTracker

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "woft_tpu", "cv2")
# The host fits of the ablation estimators ('cvransac', 'trs') are OpenCV
# calls, as in the JAX package: the port imports cv2 in this one function,
# called inside those fits, so importing the port never needs it
CV2_IMPORTER = ("woft_tpu_torch/geometry/homography.py", "_cv2")


def _port_files():
    return sorted((ROOT / "woft_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "train_wraft_torch.py",
        ROOT / "eval_woft_torch.py", ROOT / "WOFT_demo_torch.py",
        *sorted((ROOT / "tools").glob("torch_*.py"))]


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_woft_tpu_or_cv2(path):
    tree = ast.parse(path.read_text())
    bad = [m for m in _imported_modules(tree)
           if m.split(".")[0] in FORBIDDEN]
    if str(path.relative_to(ROOT)) == CV2_IMPORTER[0]:
        importer, = (node for node in ast.walk(tree)
                     if isinstance(node, ast.FunctionDef)
                     and node.name == CV2_IMPORTER[1])
        assert list(_imported_modules(importer)) == ["cv2"]
        bad.remove("cv2")
    assert not bad, f"{path}: imports {bad}"


@pytest.mark.parametrize("config", ["WOFT.py", "WOFT_fast.py",
                                    "WOFT_window.py", "WOFT_window_384.py",
                                    "WOFT_window_native.py",
                                    "WOFT_downscale_3x.py", "WOFT_wIRLSq.py",
                                    "WOFT_origraft.py", "WOFT_masked.py",
                                    "WOFT_rep.py", "ablation_10.py"])
@pytest.mark.parametrize("entry", ["tracker", "flow"])
def test_entry_points_need_a_card_unless_asked_for_cpu(entry, config,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = load_config(ROOT / "woft_tpu_torch" / "configs" / config)
    tracker_class = (WOFTWindowTracker if config.startswith("WOFT_window")
                     else WOFTTracker)
    assert conf.tracker_class is tracker_class
    # the config's flow wrapper: RaftFlow, or the external backend's
    flow_class = conf.flow_config.of_class
    assert flow_class is RaftFlow or config == "ablation_10.py"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "tracker":
            tracker_class(conf)
        else:
            flow_class(conf.flow_config)


_WRAPPERS = [kernels.warp_perspective_bilinear, kernels.corr_pyramid_lookup,
             kernels.corr_pyramid_lookup_backward, kernels.local_corr_build,
             kernels.local_lookup_fine_multi, kernels.local_lookup_fine, kernels.local_lookup_exact,
             warp.warp_perspective_fast, warp.warp_axis_aligned,
             corr.corr_lookup,
             corr.block_local_corr, corr.block_local_corr_levels,
             corr.block_local_lookup_fine_multi,
             corr.block_local_lookup_fine, corr.block_local_lookup,
             corr.block_local_lookup_levels, corr.corr_lookup_local_blocked]


@pytest.mark.parametrize("fn", _WRAPPERS, ids=lambda f: f.__name__)
def test_wrappers_have_no_silent_fallback(fn):
    tree = ast.parse(inspect.getsource(fn).lstrip())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


def test_launch_wrappers_refuse_cpu_tensors():
    img = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError):
        kernels.warp_perspective_bilinear(img, torch.eye(3)[None], 8, 8)
    with pytest.raises(ValueError):
        kernels.corr_pyramid_lookup([torch.zeros(4, 2, 2)],
                                    torch.zeros(4, 2), 4)
    with pytest.raises(ValueError):
        kernels.corr_pyramid_lookup_backward(
            [torch.zeros(4, 2, 2)], torch.zeros(4, 2), torch.zeros(4, 81), 4)
    vol = torch.zeros(1, 12, 12, 128)
    starts = torch.zeros(2, 1, 128, dtype=torch.int32)
    frac = torch.zeros(2, 1, 128)
    rcs = torch.zeros(1, 1, 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.local_corr_build(torch.zeros(1, 128, 32),
                                 [torch.zeros(4, 4, 32)],
                                 [(13, 8, 16, 34, 48)], 1, 1, torch.float32)
    with pytest.raises(ValueError):
        kernels.local_lookup_fine_multi(rcs, [vol], starts[None], frac[None],
                                        9)
    with pytest.raises(ValueError):
        kernels.local_lookup_fine(rcs[:, 0], vol, starts, frac, 9)
    with pytest.raises(ValueError):
        kernels.local_lookup_exact([vol], starts[None], frac[None], 9)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    counted = (kernels.warp_perspective_bilinear, kernels.corr_pyramid_lookup,
               kernels.corr_pyramid_lookup_backward, kernels.local_corr_build, kernels.local_lookup_fine_multi,
               kernels.local_lookup_fine, kernels.local_lookup_exact)
    before = [fn.launches for fn in counted]
    warp.warp_perspective_fast(torch.rand(1, 16, 16, 3), torch.eye(3))
    warp.warp_axis_aligned(torch.rand(1, 16, 16, 3),
                           torch.diag(torch.tensor([0.5, 0.5, 1.0])), (8, 8))
    corr.corr_lookup([torch.rand(4, 4, 4)], torch.rand(1, 2, 2, 2), 1)
    # under grad: the autograd Function's CPU path, forward and backward
    pyr = [torch.rand(4, 4, 4, requires_grad=True)]
    corr.corr_lookup(pyr, torch.rand(1, 2, 2, 2), 1).sum().backward()
    assert pyr[0].grad is not None
    local = corr.build_local_corr(torch.rand(1, 8, 16, 32),
                                  torch.rand(1, 8, 16, 32), 4, 2, 8)
    coords = torch.rand(1, 8, 16, 2) * 8
    corr.corr_lookup_local_blocked(local, coords, 4)
    corr.corr_lookup_local_blocked(local, coords, 4, fine=False)
    starts, frac = corr._local_level_coords(local, coords)
    rcs, rel, _ = corr._fine_anchor_starts(local, starts)
    corr.block_local_lookup_fine(rcs[:, 0].contiguous(), local.volumes[0],
                                 rel[0], frac[0], 9)
    assert before == [fn.launches for fn in counted]


def test_every_kernel_source_has_its_entries():
    """Each ``csrc`` source is listed for the build with its C entries."""
    assert set(kernels.SOURCES) == set(kernels._ENTRIES) == {
        p.stem for p in kernels.CSRC.glob("*.cu")}
    for name, entries in kernels._ENTRIES.items():
        src = (kernels.CSRC / f"{name}.cu").read_text()
        for symbol in entries:
            assert f'extern "C" int {symbol}(' in src


def test_kernel_sources_are_named_for_sm90a():
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    for name in kernels.SOURCES:
        src = (kernels.CSRC / f"{name}.cu").read_text()
        # a kernel with no Pallas twin says so, and names the JAX code
        # that computes its function instead
        assert ("Replaces the TPU kernel woft_tpu/ops/pallas/" in src
                or ("Replaces no TPU kernel" in src and "woft_tpu/" in src))
        assert "Bound on the H100" in src
        assert 'extern "C" int' in src
